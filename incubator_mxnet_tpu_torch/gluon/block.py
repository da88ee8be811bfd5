"""Block / HybridBlock: the Gluon module system, as ``torch.nn.Module``\\ s.

Counterpart: the JAX package's ``gluon/block.py`` (``:39-487``): the
prefix counters of ``_BlockScope`` and ``name_scope``, ``register_child``,
``collect_params`` (prefix names, e.g. ``bertmodel0_encoder_layer0_attn_
qkv_weight``) and ``_collect_params_with_prefix`` (structural names, e.g.
``encoder.layer0.attention.qkv.weight``), ``initialize``, ``cast``,
``zero_grad``, ``save_parameters``/``load_parameters`` (``.params`` files,
structural names, with the legacy prefix-keyed branch), forward hooks, and
``HybridBlock.forward``, which fetches the parameters, finishes deferred
initialisation through ``infer_shape`` and calls ``hybrid_forward(F, x,
*args, **params)``.

Port design: a ``Block`` is a ``torch.nn.Module``. Children are torch
submodules under their attribute names, so torch's dotted parameter names
are the structural names; a ``Parameter`` assigned to a block is kept in
``_reg_params`` and its tensor registered with torch by the first block
that holds it (a tied weight, such as BERT's ``decoder_tied_weight``, is
one torch parameter). ``hybrid_forward`` always runs on tensors, with ``F``
the op namespace :mod:`..ndarray`: a forward given NDArrays unwraps them,
runs under ``torch.set_grad_enabled(autograd.is_recording())`` (no graph
outside ``autograd.record()``) and wraps the outputs; a forward given
tensors (the serving and ``ShardedTrainer`` paths) stays on torch's rules.
``export``, ``optimize_for`` and ``SymbolBlock`` are not ported yet.

``hybridize(static_alloc, static_shape)`` turns the block's forward on
NDArrays on the card into a cached op of CUDA graphs (JAX counterpart:
``gluon/block.py:420-436``, ``_call_cached_op`` ``:531-591``), one per
signature: training flag, recording flag, the arguments' structure and
their shapes, dtypes and ``requires_grad``, and which parameters take
gradients. The first call of a signature runs eagerly, as JAX's first
call does; the second captures the forward into a graph (and, under
``autograd.record()``, the backward into a second one), and every call
replays them. A forward that updates aux parameters in place (BatchNorm's
running statistics under ``autograd.is_training()``) does so inside the
graph, once per call; the training flag is part of the signature, so
``predict_mode()`` replays the graph that reads them. Under ``record()``
the cached op is one ``torch.autograd.Function``
(:class:`_CachedOpFunction`) whose forward replays the forward graph and
whose backward replays the backward graph, so the gradients reach the
parameters through ``autograd.backward`` by their ``grad_req``;
``autograd.backward`` copies each one into the parameter's own buffer, so
no ``.grad`` aliases graph memory. The graphs
compute on aliases of the parameters (the same storage, other autograd
leaves), so they see every in-place update and share nothing of the
autograd state of the eager path. Outputs are copies, safe to keep
across calls. ``hybridize(False)`` and ``_clear_cached_op()`` drop the
graphs. Arguments and outputs may nest arrays in lists and tuples (an
RNN layer's states), flattened for the graphs and rebuilt around them.
On CPU NDArrays or on tensors the hybridized block runs its eager
forward: the same function.

``summary(*inputs)`` prints each block's output shape and parameter
count (JAX counterpart: ``gluon/block.py:357``); ``save_params`` and
``load_params`` are the deprecated names of ``save_parameters`` and
``load_parameters`` (``:342-343``).
"""
from __future__ import annotations

import math
import re
import threading
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import autograd
from ..base import MXNetError
from ..context import Context
from .. import ndarray as F
from .. import random as _random
from ..ndarray import NDArray
from ..ndarray.op import _has_nd, _unwrap, _wrap
from ..ops.cuda import graphs
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope:
    """Name manager: numbers block instances per type (dense0_, dense1_ …)
    (JAX counterpart: ``gluon/block.py:39``). A block's counters live on
    the block; its scope object exists only while ``name_scope()`` is
    open, so blocks hold no reference cycle and free their tensors as soon
    as they are dropped."""

    _current = threading.local()

    def __init__(self, block=None):
        self._block = block
        self._counter: Dict[str, int] = {} if block is None \
            else block._scope_counter
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _GLOBAL_SCOPE._next_prefix(hint)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            prefix = current._next_prefix(hint)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def _next_prefix(self, hint):
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}_"

    def __enter__(self):
        if self._block is not None and self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block is not None and self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_GLOBAL_SCOPE = _BlockScope()


class _HookHandle:
    """A forward hook's handle: ``detach()`` (Gluon) or ``remove()``."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    remove = detach


class Block(nn.Module):
    """Base class of layers and models (JAX counterpart:
    ``gluon/block.py:160``)."""

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope_counter: Dict[str, int] = {}
        self._reg_params: Dict[str, Parameter] = {}

    def _alias(self) -> str:
        return self.__class__.__name__.lower()

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    def name_scope(self):
        return _BlockScope(self)

    @property
    def params(self) -> ParameterDict:
        return self._params

    @property
    def _children(self):
        return OrderedDict((k, m) for k, m in self._modules.items()
                           if isinstance(m, Block))

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """This block's and its descendants' Parameters by prefix name,
        optionally those matching the regex ``select``."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret._params.update({k: v for k, v in self.params.items()
                                if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix: str = ""
                                    ) -> Dict[str, Parameter]:
        if prefix:
            prefix += "."
        ret = {prefix + k.lstrip("_"): v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def __setattr__(self, name, value):
        existing = self.__dict__.get(name, self.__dict__.get(
            "_modules", {}).get(name))
        if isinstance(existing, (Parameter, Block)) \
                and not isinstance(value, type(existing)):
            raise TypeError(f"Changing attribute type for {self.name} from "
                            f"{type(existing)} to {type(value)} is not "
                            "allowed.")
        if isinstance(value, Parameter):
            self.__dict__["_reg_params"][name] = value
            if not value._owned:
                self.register_parameter(name, value._var)
                value._owned = True
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def register_child(self, block: "Block", name: Optional[str] = None
                       ) -> None:
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    def register_forward_pre_hook(self, hook, **kwargs):
        return _HookHandle(super().register_forward_pre_hook(hook, **kwargs))

    def register_forward_hook(self, hook, **kwargs):
        return _HookHandle(super().register_forward_hook(hook, **kwargs))

    def initialize(self, init=None, ctx=None, verbose: bool = False,
                   force_reinit: bool = False) -> None:
        """Initialise every Parameter not yet initialised (all of them with
        ``force_reinit``) on ``ctx``; ``init`` (default ``Xavier()``) for
        those without an initializer of their own."""
        from .. import initializer as init_mod
        self.collect_params().initialize(init or init_mod.Xavier(), ctx,
                                         verbose, force_reinit)

    def cast(self, dtype) -> None:
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def zero_grad(self, set_to_none: bool = False) -> None:
        """Zero every gradient (torch's ``set_to_none=True`` drops them)."""
        if set_to_none:
            super().zero_grad(set_to_none=True)
        else:
            self.collect_params().zero_grad()

    def hybridize(self, active: bool = True, **kwargs) -> None:
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def save_parameters(self, filename: str,
                        deduplicate: bool = False) -> None:
        """Write the parameters under their structural names to an
        upstream ``.params`` file."""
        arg_dict, seen = {}, set()
        for name, param in self._collect_params_with_prefix().items():
            if deduplicate and id(param) in seen:
                continue
            seen.add(id(param))
            arg_dict[name] = param.data()
        if not all(bool(torch.isfinite(a._data).all())
                   for a in arg_dict.values() if a._data.is_floating_point()):
            warnings.warn(f"save_parameters({filename!r}): parameters "
                          "contain non-finite values; the saved file will "
                          "restore a broken model")
        F.save(filename, arg_dict)

    def load_parameters(self, filename: str, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False, cast_dtype: bool = False,
                        dtype_source: str = "current") -> None:
        """Read a ``.params`` file keyed by structural names, or (the
        legacy branch) by prefix names."""
        loaded = F.load(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in k for k in loaded.keys()):
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError(f"Parameter '{name}' is missing in "
                                         f"file '{filename}'")
        for name, data in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise AssertionError(
                        f"Parameter '{name}' loaded from file '{filename}' "
                        "is not present in this block")
                continue
            params[name]._load_init(data, ctx, cast_dtype=cast_dtype,
                                    dtype_source=dtype_source)

    save_params = save_parameters
    load_params = load_parameters

    def summary(self, *inputs) -> None:
        """Run a forward on ``inputs`` and print each block's type, name,
        (first) output shape and parameter count (JAX counterpart:
        ``gluon/block.py:357``)."""
        rows, hooks = [], []

        def hook(blk, _, out):
            o = out[0] if isinstance(out, (list, tuple)) else out
            n_param = sum(math.prod(p.shape) for p in blk.params.values()
                          if p.shape and all(s > 0 for s in p.shape))
            rows.append((type(blk).__name__, blk.name,
                         tuple(getattr(o, "shape", ())), n_param))

        for blk in self.modules():
            if isinstance(blk, Block):
                hooks.append(blk.register_forward_hook(hook))
        try:
            self(*inputs)
        finally:
            for h in hooks:
                h.detach()
        print(f"{'Layer (type)':<30}{'Output Shape':<24}{'Param #':<12}")
        print("-" * 66)
        total = 0
        for tname, name, shape, n in rows:
            print(f"{tname + ' (' + name + ')':<30}{str(shape):<24}{n:<12}")
            total += n
        print("-" * 66)
        print(f"Total params (incl. shared): {total}")


class HybridBlock(Block):
    """A Block whose forward is ``hybrid_forward(F, x, *args, **params)``
    over tensors (JAX counterpart: ``gluon/block.py:404``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags: Dict[str, bool] = {}
        self._cached_ops: Dict[tuple, "_CachedOp"] = {}
        self._cached_params: Optional[List[Parameter]] = None

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, **kwargs) -> None:
        """Make the forward on card NDArrays a cached op of CUDA graphs
        (module docstring), here and below. ``static_alloc`` and
        ``static_shape`` are accepted as in the JAX package: a graph has
        both by construction."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._clear_cached_op()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _clear_cached_op(self) -> None:
        """Drop every captured graph of this block."""
        self._cached_ops = {}
        self._cached_params = None

    def infer_shape(self, *args) -> None:
        """Resolve deferred parameter shapes from the inputs' shapes; layers
        with lazy in-units or in-channels override it."""
        raise ValueError(
            f"Deferred initialization of parameters in {type(self).__name__}"
            " could not be resolved: override infer_shape() or give explicit"
            " in_units/in_channels.")

    def _fetch_params(self, args) -> Dict[str, torch.Tensor]:
        sub = getattr(_ALIASES, "map", None)
        if sub:
            return {name: sub[id(p)] for name, p in self._reg_params.items()}
        try:
            return {name: p._tensor() for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            return {name: p._tensor() for name, p in self._reg_params.items()}

    def forward(self, *args):
        if _has_nd(args):
            if self._active:
                op = self._cached_op(args)
                if op is not None:
                    return op(self, args)
            args = _unwrap(args)
            with torch.set_grad_enabled(autograd.is_recording()):
                return _wrap(self.hybrid_forward(F, *args,
                                                 **self._fetch_params(args)))
        return self.hybrid_forward(F, *args, **self._fetch_params(args))

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # the cached op (JAX counterpart: ``_call_cached_op``, ``:531-591``)
    # ------------------------------------------------------------------
    def _cached_op(self, args) -> Optional["_CachedOp"]:
        """The cached op of this call's signature, or None when this call
        runs eagerly: the first of its signature, or one the graphs do not
        take (CPU arrays). Arguments may nest arrays in lists and tuples
        (an RNN layer's states); the nesting is part of the signature."""
        leaves, spec = _flatten(args)
        skeleton, tensors = [str(spec)], []
        for a in leaves:
            if isinstance(a, (NDArray, torch.Tensor)):
                t = _unwrap(a)
                if not t.is_cuda:
                    return None
                tensors.append(t)
                skeleton.append((tuple(t.shape), t.dtype, t.requires_grad))
            else:
                skeleton.append(("static", repr(a)))
        params = self._params_for_graphs()
        if not tensors or params is None:
            return None
        recording = autograd.is_recording()
        sig = (autograd.is_training(), recording, tuple(skeleton),
               tuple(p._var.requires_grad for p in params))
        op = self._cached_ops.get(sig)
        if op is not None and op.fwd is not None and op.storage != tuple(
                p._var.data_ptr() for p in params):
            # a parameter got new storage (re-initialised, cast): the
            # graphs read the old one, so every graph of the block goes
            self._clear_cached_op()
            return None
        if op is None:
            self._cached_ops[sig] = _CachedOp(recording, tensors[0].device)
            return None
        return op

    def _params_for_graphs(self) -> Optional[List[Parameter]]:
        """This block's parameters in sorted-name order, once each, or None
        while one is not initialised (the eager call initialises it)."""
        if self._cached_params is None:
            seen, params = set(), []
            for _, p in sorted(self.collect_params().items()):
                if not p._initialized:
                    return None
                if id(p) not in seen:
                    seen.add(id(p))
                    params.append(p)
            self._cached_params = params
        return self._cached_params


class _CachedOp:
    """One signature's graphs: the forward, and under ``record()`` the
    backward, over static input buffers and aliases of the parameters."""

    def __init__(self, recording: bool, device: torch.device):
        self.recording = recording
        self.device = device
        self.fwd: Optional[graphs.Graph] = None
        self.bwd: Optional[graphs.Graph] = None
        self.params: List[Parameter] = []
        self.static_in: List[torch.Tensor] = []
        self.static_out: List[torch.Tensor] = []
        self.out_spec = None         # the nesting of the outputs
        self.replays = 0             # forward replays, for backward's check
        self.storage: tuple = ()     # the parameters' data_ptr at capture

    def __call__(self, block: HybridBlock, args):
        tensors = [_unwrap(a) for a in _flatten(args)[0]
                   if isinstance(a, (NDArray, torch.Tensor))]
        if self.fwd is None:
            self._capture(block, args, tensors)
        if self.recording:
            outs = _CachedOpFunction.apply(
                self, *tensors, *(p._var for p in self.params))
        else:
            self._replay_forward(tensors)
            outs = [o.clone() for o in self.static_out]
        return tree_unflatten([_wrap(o) for o in outs], self.out_spec)

    def _replay_forward(self, tensors) -> None:
        with torch.no_grad():
            for dst, src in zip(self.static_in, tensors):
                dst.copy_(src)
        self.fwd.replay()
        self.replays += 1

    def _capture(self, block: HybridBlock, args, tensors) -> None:
        """Capture the forward (and backward) graph of this signature,
        after one run of the same work on the capture stream."""
        from ..nn import Dropout
        rec = self.recording
        self.params = block._cached_params
        self.storage = tuple(p._var.data_ptr() for p in self.params)
        aliases = [p._var.detach().requires_grad_(rec and p._var.requires_grad)
                   for p in self.params]
        self.static_in = [t.detach().clone().requires_grad_(
            rec and t.requires_grad) for t in tensors]
        training = autograd.is_training()
        gens = [m.generator or _random.generator(
            Context.from_device(self.device)) for m in block.modules()
            if isinstance(m, Dropout)]

        leaves, spec = _flatten(args)

        def forward():
            it = iter(self.static_in)
            call_args = tree_unflatten(
                [next(it) if isinstance(a, (NDArray, torch.Tensor)) else a
                 for a in leaves], spec)
            _ALIASES.map = {id(p): a for p, a in zip(self.params, aliases)}
            try:
                with autograd.pause(train_mode=training), \
                        torch.set_grad_enabled(rec):
                    out = block.hybrid_forward(
                        F, *call_args, **block._fetch_params(call_args))
            finally:
                _ALIASES.map = None
            outs, self.out_spec = tree_flatten(out)
            return outs

        diff_in = [x for x in self.static_in + aliases if x.requires_grad]

        def backward(outs, seeds):
            diff = [o for o in outs if o.requires_grad]
            return torch.autograd.grad(diff, diff_in, seeds,
                                       allow_unused=True)

        def warm():
            outs = forward()
            if rec and any(o.requires_grad for o in outs):
                backward(outs, [torch.ones_like(o) for o in outs
                                if o.requires_grad])

        # the warm run is not a call: the running statistics it moved
        # (aux parameters, ``grad_req="null"``) go back, so that this call
        # moves them once, by its replay
        aux = [p._var for p in self.params if p.grad_req == "null"]
        saved = [t.detach().clone() for t in aux]
        graphs.run_on_capture_stream(self.device, warm)
        with torch.no_grad():
            for t, v in zip(aux, saved):
                t.copy_(v)
        self.fwd = graphs.Graph(self.device, gens)
        outs = self.fwd.capture(forward)
        self.static_out = [o.detach() for o in outs]
        # nothing to differentiate: the forward graph alone serves
        self.recording = rec = rec and any(o.requires_grad for o in outs)
        if rec:
            self._graph_outs = outs   # keeps the saved activations alive
            self.diff_out = [o.requires_grad for o in outs]
            self.seeds = [torch.ones_like(o) for o in outs if o.requires_grad]
            self.bwd = graphs.Graph(self.device, gens, share=self.fwd)
            grads = self.bwd.capture(lambda: backward(outs, self.seeds))
            it = iter(grads)
            self.grad_of = [next(it) if x.requires_grad else None
                            for x in self.static_in + aliases]


class _CachedOpFunction(torch.autograd.Function):
    """A cached op under ``record()``: ``apply(op, *inputs, *params)``.
    The forward replays the forward graph and returns copies of its
    outputs; the backward writes the output gradients into the graph's
    seeds, replays the backward graph and returns its gradients."""

    @staticmethod
    def forward(ctx, op, *tensors):
        op._replay_forward(tensors[:len(op.static_in)])
        ctx.op, ctx.replay = op, op.replays
        outs = tuple(o.clone() for o in op.static_out)
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, op.diff_out)
                                      if not d])
        return outs

    @staticmethod
    def backward(ctx, *grad_outs):
        op = ctx.op
        if op.replays != ctx.replay:
            raise MXNetError(
                "a hybridized block ran its forward again before the "
                "backward of an earlier call: its captured activations are "
                "gone; call backward() before the next forward")
        with torch.no_grad():
            for seed, g in zip(op.seeds, [g for g, d in zip(grad_outs,
                                                            op.diff_out)
                                          if d]):
                seed.copy_(g)
        op.bwd.replay()
        return (None,) + tuple(op.grad_of)


#: parameter id -> alias tensor, while a cached op captures
_ALIASES = threading.local()


def _flatten(args):
    """The leaves of ``args`` (arrays, tensors and static values; lists
    and tuples opened) and their nesting."""
    return tree_flatten(list(args))
