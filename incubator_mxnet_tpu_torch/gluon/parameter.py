"""Parameter and ParameterDict.

Counterpart: the JAX package's ``gluon/parameter.py`` (``:29-509``): the
prefix-named ``Parameter`` with ``grad_req``, deferred initialisation
(``allow_deferred_init``; shape dims of 0 are unknown until the first
forward), ``initialize``/``data``/``grad``/``set_data``/``zero_grad``/
``cast``/``_load_init``/``list_data``/``list_grad``/``reset_ctx``/
``var``, ``Constant``,
``ParameterDict`` (with ``get_constant``) and
``DeferredInitializationError``.

Each ``Parameter`` owns one ``torch.nn.Parameter``, which the first block
it is assigned to registers with torch: so ``Module.parameters()``,
``.to()``, ``parallel.ShardedTrainer`` and ``serve`` see the same tensor.
Until initialisation it is a ``torch.nn.parameter.UninitializedParameter``,
materialised in place on the chosen device (the same object throughout).
``data()`` wraps that tensor in an ``NDArray``; ``grad()`` wraps its
``.grad``. An aux parameter (BatchNorm's running statistics:
``grad_req="null"``, ``differentiable=False``) has no gradient and no
``gluon.Trainer`` update; its layer writes it in place, and ``.params``
files and ``cast`` carry it like any other.

A parameter may live on several contexts (``initialize(ctx=[...])``, JAX
``gluon/parameter.py:138-158``), MXNet's single-process data parallelism:
the torch parameter is the replica on the first context, and each other
context holds a replica of its own (a tensor with its own gradient),
initialised to the same values. A block's forward reads the replica on
its input's context (:func:`replica_scope`; ``data(ctx)``, ``grad(ctx)``,
``list_data``, ``list_grad``, ``list_ctx``), and ``gluon.Trainer`` sums the
replicas' gradients, updates once and copies the weight to every replica.
The CPU is one torch device: ``cpu(i)`` contexts (as many as
``MXTPU_CPU_DEVICES`` allows) are replicas in host memory, and an
``NDArray`` placed on one remembers its context.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import List, Optional

import torch
from torch.nn.parameter import UninitializedParameter

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError, dtype_name, torch_dtype
from ..context import Context, as_context, current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import array

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "replica_scope"]


class DeferredInitializationError(MXNetError):
    """Raised when a parameter's shape is still unknown at data() time."""


def _shape_complete(shape) -> bool:
    return shape is not None and all(int(s) > 0 for s in shape)


def _contexts(ctx) -> List[Context]:
    """``ctx`` (a context, a list of them, or None: the current one) as a
    list without repeats."""
    if ctx is None:
        return [current_context()]
    if not isinstance(ctx, (list, tuple)):
        return [as_context(ctx)]
    out: List[Context] = []
    for c in ctx:
        c = as_context(c)
        if c not in out:
            out.append(c)
    if not out:
        raise MXNetError("a parameter needs at least one context")
    return out


#: the context of the forward running in this thread (its input's)
_REPLICA = threading.local()


@contextlib.contextmanager
def replica_scope(ctx: Optional[Context]):
    """Inside: parameters read their replica on ``ctx`` (a block's
    forward on an input of that context)."""
    prev = getattr(_REPLICA, "ctx", None)
    _REPLICA.ctx = ctx
    try:
        yield
    finally:
        _REPLICA.ctx = prev


class _Replica:
    """A parameter's replica on a context past its first: its own tensor
    and gradient, a variable of the autograd registry as the parameter
    itself is."""

    def __init__(self, param: "Parameter", tensor: torch.Tensor):
        self._param = param
        self.tensor = tensor
        self._fresh_grad = False
        autograd._register(self)

    @property
    def _autograd_leaf(self):
        return self.tensor if self._param._grad_req != "null" else None

    @property
    def _autograd_req(self) -> str:
        return self._param._grad_req


class Parameter:
    """A weight, bias or state tensor with lazy (deferred) initialisation
    (JAX counterpart: ``gluon/parameter.py:38``)."""

    def __init__(self, name: str, grad_req: str = "write", shape=None,
                 dtype="float32", lr_mult: float = 1.0, wd_mult: float = 1.0,
                 init=None, allow_deferred_init: bool = False,
                 differentiable: bool = True, stype: str = "default",
                 grad_stype: str = "default"):
        self._name = name
        # the storage types of the value and of the gradient (JAX
        # ``gluon/parameter.py:49-64``): both packages keep them as given
        # and hold the value and the gradient dense (``ndarray/sparse.py``
        # is a dense facade); ``data().tostype(stype)`` gives the sparse
        # view
        for label, st in (("stype", stype), ("grad_stype", grad_stype)):
            if st not in ("default", "row_sparse", "csr"):
                raise ValueError(f"{label} must be 'default', 'row_sparse' "
                                 f"or 'csr', got {st!r}")
        self._stype = stype
        self._grad_stype = grad_stype
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        dt = torch_dtype(self.dtype)
        # an integer parameter (an int8 ``Constant``) cannot take gradients
        self._var = UninitializedParameter(
            requires_grad=dt.is_floating_point, dtype=dt)
        self._owned = False          # registered with torch by a block yet
        self._sym_var = None         # var(): its symbol variable
        self._ctx: Optional[Context] = None
        #: the replicas on the contexts past the first (module docstring)
        self._replicas: "OrderedDict[Context, _Replica]" = OrderedDict()
        self._deferred_init = ()     # (init, ctx, default_init, data)
        self._fresh_grad = False
        #: the mesh axis over which the block that owns this parameter
        #: takes its own block of dimension 0 (``parallel.ShardedTrainer``
        #: hands it over ungathered), or None
        self.local_axis: Optional[str] = None
        self._grad_req = None
        self.grad_req = "null" if not differentiable else grad_req
        autograd._register(self)

    @property
    def name(self) -> str:
        return self._name

    @property
    def stype(self) -> str:
        return self._stype

    @property
    def grad_stype(self) -> str:
        return self._grad_stype

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write/add/null, got {req}")
        self._grad_req = req
        for t in self._tensors():
            t.requires_grad = req != "null"
            if req == "null" and self._initialized:
                t.grad = None

    @property
    def _initialized(self) -> bool:
        return not isinstance(self._var, UninitializedParameter)

    @property
    def _autograd_leaf(self):
        return self._var if self._initialized and self._grad_req != "null" \
            else None

    @property
    def _autograd_req(self) -> str:
        return self._grad_req

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        # merge: unknown (0) dims take the new value; known dims must match
        if len(self._shape) != len(new_shape):
            raise AssertionError(f"Expected shape {tuple(new_shape)} "
                                 f"incompatible with {self._shape}")
        merged = []
        for o, n in zip(self._shape, new_shape):
            if o and n and o != n:
                raise AssertionError(f"Expected shape {tuple(new_shape)} "
                                     f"incompatible with {self._shape}")
            merged.append(o if o else n)
        self._shape = tuple(merged)

    # ------------------------------------------------------------------
    # initialisation
    # ------------------------------------------------------------------
    def _tensors(self) -> List[torch.Tensor]:
        """The data tensor of every context, the first context's first."""
        return [self._var] + [r.tensor for r in self._replicas.values()]

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False) -> None:
        """Create the data on ``ctx`` (a context or a list of them;
        default: the current context), or defer that to the first forward
        while the shape is unknown. An initialised parameter is left alone
        unless ``force_reinit``."""
        if default_init is None:
            default_init = init_mod.Xavier()
        if self._initialized and not force_reinit:
            return
        ctx = _contexts(ctx)
        if init is None:
            init = self.init if self.init is not None else default_init
        if not _shape_complete(self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, None)
                return
            raise ValueError(
                f"Cannot initialize Parameter '{self.name}' because it has "
                f"invalid shape: {self._shape}. Set allow_deferred_init=True "
                "or specify in_units/in_channels.")
        self._init_impl(init, ctx)

    def _init_impl(self, init, ctx: List[Context], data=None) -> None:
        """The data on the contexts ``ctx``: ``init`` (or ``data``) on the
        first, copied to the others."""
        devs = [c.torch_device for c in ctx]
        dev, dt = devs[0], torch_dtype(self.dtype)
        if self._initialized:
            self._var.data = torch.empty(self._shape, dtype=dt, device=dev)
            self._var.grad = None
        else:
            self._var.materialize(self._shape, device=dev, dtype=dt)
        with torch.no_grad():
            if data is None:
                init_mod.create(init)(self.name, self._var)
            else:
                self._var.copy_(getattr(data, "_data", data))
        req = self._grad_req != "null" and dt.is_floating_point
        self._replicas = OrderedDict(
            (c, _Replica(self, self._var.detach().to(d, copy=True)
                         .requires_grad_(req)))
            for c, d in zip(ctx[1:], devs[1:]))
        self._ctx = ctx[0]
        self._deferred_init = ()

    def _finish_deferred_init(self) -> None:
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        if not _shape_complete(self._shape):
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has unknown shape {self._shape} and "
                "shape inference did not resolve it.")
        self._init_impl(init if init is not None else default_init, ctx,
                        data)

    def _load_init(self, data: NDArray, ctx, cast_dtype=False,
                   dtype_source="current") -> None:
        """Install loaded weights (JAX counterpart:
        ``gluon/parameter.py:178``)."""
        if _shape_complete(self._shape):
            if tuple(data.shape) != tuple(self._shape):
                raise AssertionError(
                    f"Failed loading Parameter '{self.name}' from saved "
                    f"params: shape incompatible expected {self._shape} vs "
                    f"saved {tuple(data.shape)}")
        else:
            self._shape = tuple(data.shape)
        if cast_dtype and dtype_source == "current":
            data = data.astype(self.dtype)
        else:
            self.dtype = dtype_name(data._data.dtype)
        if self._initialized:
            self.set_data(data)
            return
        if self._deferred_init:
            ctx = self._deferred_init[1]
        self._init_impl(None, _contexts(ctx), data)

    # ------------------------------------------------------------------
    # access
    # ------------------------------------------------------------------
    def _check_initialized(self) -> None:
        if self._initialized:
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Actual initialization "
                "happens during the first forward pass.")
        raise RuntimeError(
            f"Parameter '{self.name}' has not been initialized. You should "
            "initialize parameters and create a Trainer first, then use "
            ".data()/.grad() to access them.")

    def _replica(self, ctx: Optional[Context]) -> torch.Tensor:
        """The data tensor on ``ctx`` (None: the forward's context, else
        the current one, when there are several; JAX counterpart:
        ``_check_and_get``, ``gluon/parameter.py:196``)."""
        if not self._initialized:
            self._check_initialized()
        if not self._replicas:
            return self._var
        if ctx is None:
            ctx = getattr(_REPLICA, "ctx", None) or current_context()
        ctx = as_context(ctx)
        if ctx == self._ctx:
            return self._var
        rep = self._replicas.get(ctx)
        if rep is not None:
            return rep.tensor
        for c, t in zip(self.list_ctx(), self._tensors()):
            if c.device_type == ctx.device_type:
                return t
        raise RuntimeError(
            f"Parameter '{self.name}' was not initialized on context {ctx}. "
            f"It was only initialized on {self.list_ctx()}.")

    def _tensor(self) -> torch.Tensor:
        """The data tensor a forward uses: the replica on the forward's
        context (raises as :meth:`data`)."""
        return self._replica(None)

    def data(self, ctx=None) -> NDArray:
        t = self._replica(ctx)
        return NDArray(t, self._ctx_of(t))

    def _ctx_of(self, t: torch.Tensor) -> Optional[Context]:
        if t is self._var:
            return self._ctx
        return next(c for c, r in self._replicas.items() if r.tensor is t)

    def grad(self, ctx=None) -> NDArray:
        """The gradient buffer on ``ctx`` (zeros until a backward writes
        it)."""
        self._check_initialized()
        if self._grad_req == "null":
            raise RuntimeError(f"Cannot get gradient array for Parameter "
                               f"'{self.name}' because grad_req='null'")
        t = self._replica(ctx)
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return NDArray(t.grad, self._ctx_of(t))

    def list_data(self) -> List[NDArray]:
        """The data on each context (JAX counterpart:
        ``gluon/parameter.py:240``)."""
        return [self.data(c) for c in self.list_ctx()]

    def list_grad(self) -> List[NDArray]:
        """The gradient on each context (JAX counterpart:
        ``gluon/parameter.py:250``)."""
        return [self.grad(c) for c in self.list_ctx()]

    def _variables(self) -> list:
        """The autograd variable of each context: the parameter itself,
        then its replicas."""
        return [self] + list(self._replicas.values())

    def reset_ctx(self, ctx) -> None:
        """Move the data (or the deferred initialisation) to ``ctx`` (a
        context or a list of them), keeping its value (JAX counterpart:
        ``gluon/parameter.py:301``)."""
        ctx = _contexts(ctx)
        if self._initialized:
            self._init_impl(None, ctx, data=self._var.detach().clone())
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)
        else:
            raise ValueError(f"Cannot reset context for Parameter "
                             f"'{self.name}' because it has not been "
                             "initialized.")

    def var(self):
        """The symbol variable of this parameter, made once (JAX
        counterpart: ``gluon/parameter.py:328``)."""
        if self._sym_var is None:
            from ..symbol import var
            self._sym_var = var(self.name, shape=self.shape,
                                dtype=self.dtype)
        return self._sym_var

    def list_ctx(self) -> List[Context]:
        if self._initialized:
            return [self._ctx] + list(self._replicas)
        if self._deferred_init:
            return list(self._deferred_init[1])
        raise RuntimeError(f"Parameter '{self.name}' has not been "
                           "initialized")

    def set_data(self, data) -> None:
        """Set this parameter's value (cast to its dtype)."""
        self.shape = tuple(data.shape)
        if not self._initialized:
            if not self._deferred_init:
                raise RuntimeError(
                    f"Parameter '{self.name}' has not been initialized")
            self._deferred_init = self._deferred_init[:3] + (data,)
            return
        with torch.no_grad():
            for t in self._tensors():
                t.copy_(getattr(data, "_data", data))

    def zero_grad(self) -> None:
        if not self._initialized:
            return
        for t in self._tensors():
            if t.grad is not None:
                t.grad.zero_()

    def cast(self, dtype) -> None:
        self.dtype = dtype_name(dtype)
        if not self._initialized:
            return          # materialised in self.dtype
        dt = torch_dtype(dtype)
        for t in self._tensors():
            t.data = t.data.to(dt)
            if t.grad is not None:
                t.grad = t.grad.to(dt)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self._shape}, " \
               f"dtype={self.dtype})"


class _ConstantValue(init_mod.Constant):
    """A :class:`Constant`'s initializer: its value, whatever the
    parameter's name, as upstream MXNet's ``Constant`` initialises (the
    JAX package's ``_CInit`` fills only through ``_init_weight``, so its
    name dispatch zeroes a constant named ``*bias``: its quantized
    layers' ``qbias``)."""

    def __call__(self, name, arr) -> None:
        with torch.no_grad():
            self._init_weight(name, getattr(arr, "_data", arr))


class Constant(Parameter):
    """A parameter the Trainer never updates: ``grad_req='null'``, its value
    fixed at construction (JAX counterpart: ``gluon/parameter.py:348``)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = array(value, ctx="cpu")
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value._data.dtype,
                         init=_ConstantValue(value._data.cpu()))


class ParameterDict:
    """A prefix-scoped dictionary of Parameters (JAX counterpart:
    ``gluon/parameter.py:367``)."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self) -> str:
        return self._prefix

    def _get_impl(self, name) -> Optional[Parameter]:
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name: str, **kwargs) -> Parameter:
        """Get or create ``prefix + name`` (JAX counterpart:
        ``gluon/parameter.py:409``)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if k == "shape" and v is not None:
                param.shape = v
            elif k == "dtype" and param.dtype != dtype_name(v):
                raise AssertionError(
                    f"Cannot retrieve Parameter '{name}' because desired "
                    f"attribute does not match with stored for attribute {k}")
            elif getattr(param, k, None) is None:
                setattr(param, k, v)
        return param

    def get_constant(self, name: str, value=None) -> Constant:
        """Get or create the :class:`Constant` ``prefix + name`` holding
        ``value`` (JAX counterpart: ``gluon/parameter.py:429``)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'.")
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None and not isinstance(param, Constant):
            raise AssertionError(f"Parameter '{name}' already exists but is "
                                 "not a constant.")
        return param

    def update(self, other: "ParameterDict") -> None:
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    "Cannot update self with other because they have "
                    f"different Parameters with the same name '{k}'")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose: bool = False,
                   force_reinit: bool = False) -> None:
        if init is None:
            init = init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self) -> None:
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx) -> None:
        for v in self.values():
            v.reset_ctx(ctx)

    def list_ctx(self) -> List[Context]:
        ctxs = []
        for v in self.values():
            for c in v.list_ctx():
                if c not in ctxs:
                    ctxs.append(c)
        return ctxs

    def setattr(self, name: str, value) -> None:
        """Set attribute ``name`` of every parameter (``grad_req``,
        ``lr_mult`` ...)."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename: str, strip_prefix: str = "") -> None:
        from .. import ndarray as nd
        arg_dict = {}
        for param in self.values():
            if not param._initialized and param._deferred_init:
                raise RuntimeError(f"Parameter '{param.name}' is "
                                   "deferred-initialized; run a forward "
                                   "pass before saving")
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.data()
        nd.save(filename, arg_dict)

    def load(self, filename: str, ctx=None, allow_missing: bool = False,
             ignore_extra: bool = False, restore_prefix: str = "",
             cast_dtype: bool = False, dtype_source: str = "current") -> None:
        from .. import ndarray as nd
        loaded = nd.load(filename)
        arg_dict = {(restore_prefix + k.split(":", 1)[-1]): v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError(f"Parameter '{name}' is missing in "
                                         f"file '{filename}'")
        for name, data in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        f"Parameter '{name}' loaded from file '{filename}' "
                        "is not present in this dict")
                continue
            self[name]._load_init(data, ctx, cast_dtype=cast_dtype,
                                  dtype_source=dtype_source)

    def __repr__(self):
        s = "\n".join(f"  {v}" for v in self.values())
        return f"{type(self).__name__} '{self._prefix}' (\n{s}\n)"
