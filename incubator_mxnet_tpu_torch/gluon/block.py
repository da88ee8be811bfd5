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
``hybridize()`` sets and cascades the flag; the forward stays eager (a
CUDA-graph capture is a later slice). ``export``, ``optimize_for`` and
``SymbolBlock`` are not ported yet.
"""
from __future__ import annotations

import re
import threading
import warnings
from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn

from .. import autograd
from .. import ndarray as F
from ..ndarray.op import _has_nd, _unwrap, _wrap
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


class HybridBlock(Block):
    """A Block whose forward is ``hybrid_forward(F, x, *args, **params)``
    over tensors (JAX counterpart: ``gluon/block.py:404``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active: bool = True, **kwargs) -> None:
        """Set the hybridize flag here and below; the forward stays
        eager."""
        self._active = active
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args) -> None:
        """Resolve deferred parameter shapes from the inputs' shapes; layers
        with lazy in-units or in-channels override it."""
        raise ValueError(
            f"Deferred initialization of parameters in {type(self).__name__}"
            " could not be resolved: override infer_shape() or give explicit"
            " in_units/in_channels.")

    def _fetch_params(self, args) -> Dict[str, torch.Tensor]:
        try:
            return {name: p._tensor() for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            return {name: p._tensor() for name, p in self._reg_params.items()}

    def forward(self, *args):
        if _has_nd(args):
            args = _unwrap(args)
            with torch.set_grad_enabled(autograd.is_recording()):
                return _wrap(self.hybrid_forward(F, *args,
                                                 **self._fetch_params(args)))
        return self.hybrid_forward(F, *args, **self._fetch_params(args))

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
