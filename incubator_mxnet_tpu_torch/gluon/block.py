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
tensors (the serving and ``ShardedTrainer`` paths) stays on torch's rules;
a forward given Symbols runs ``hybrid_forward`` with ``F`` the symbol
namespace and the parameters' variables (the trace ``optimize_for``
partitions).

``export`` (JAX ``:596-735``) writes the inference forward as a
``torch.export`` program in functional form, the parameters its inputs,
beside the ``.params`` file and a manifest with the JAX keys;
:class:`SymbolBlock` (JAX ``:870-1049``) runs it back without the class.
``optimize_for`` (JAX ``:737-852``) applies a block-rewrite backend
(:func:`register_subgraph_backend`, ``"INT8"``) or partitions the forward
with an ``mx.subgraph`` property backend.

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

import json
import math
import os
import re
import threading
import warnings
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as onp

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import autograd
from ..base import MXNetError, dtype_name, torch_dtype
from ..context import Context
from .. import ndarray as F
from .. import random as _random
from ..ndarray import NDArray
from ..ndarray.op import _has_nd, _unwrap, _wrap
from ..ops.cuda import graphs
from ..symbol import Symbol
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock",
           "register_subgraph_backend"]


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
        # non-finite weights save "successfully" and break every restore:
        # say so now, with one fused check and one host read (JAX
        # counterpart: ``gluon/block.py:298-311``); a diverged model may
        # still be saved for a post-mortem
        from ..fault.guards import all_finite
        if not all_finite(list(arg_dict.values())):
            warnings.warn(f"save_parameters({filename!r}): parameters "
                          "contain non-finite values; the saved file will "
                          "restore a broken model (a fault.StepGuard on the "
                          "trainer catches this at the offending step)")
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
        #: ``(skeleton, n_in, [(shape, dtype name), ...], ctx)`` of the last
        #: call on arrays, as the JAX package records it: the signature
        #: ``export`` traces and ``serve.CompiledModel`` takes without
        #: example_args (the skeleton is the arguments with every array
        #: replaced by a slot)
        self._last_sig: Optional[tuple] = None
        #: ``(partitioned symbol, data names)`` from a property backend of
        #: :meth:`optimize_for`, else None
        self._sg_graph = None

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
            self._last_sig = _signature(args)
            if self._sg_graph is not None and self._active:
                # optimize_for installed a partitioned graph: while
                # hybridized it is the compute; hybridize(False) goes back
                # to the block's own forward (JAX ``gluon/block.py:471``)
                return self._forward_partitioned(*args)
            if self._active:
                op = self._cached_op(args)
                if op is not None:
                    return op(self, args)
            args = _unwrap(args)
            with torch.set_grad_enabled(autograd.is_recording()):
                return _wrap(self.hybrid_forward(F, *args,
                                                 **self._fetch_params(args)))
        if args and isinstance(args[0], Symbol):
            # the Symbol path (JAX ``gluon/block.py:482``): parameters as
            # their variables, ``F`` the symbol namespace
            from .. import symbol as S
            return self.hybrid_forward(
                S, *args, **{name: p.var()
                             for name, p in self._reg_params.items()})
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

    # ------------------------------------------------------------------
    # export (JAX counterpart: ``_make_pure_infer`` ``:596-631``,
    # ``export`` ``:633-735``)
    # ------------------------------------------------------------------
    def export(self, path: str, epoch: int = 0, platforms=None,
               signatures=None) -> Tuple[str, str]:
        """Write a deploy artifact that :meth:`SymbolBlock.imports` runs
        without this class: ``<path>-<epoch>.params`` (the dmlc file both
        packages read, structural names), the inference forward as a
        ``torch.export`` program over ``(*inputs, *parameters)`` in
        ``param_order`` (``<path>-symbol.pt2``; the weights live only in
        the ``.params`` file) and the manifest ``<path>-symbol.json`` with
        the JAX keys (``param_order``, ``param_prefix_names``,
        ``n_inputs``, ``in_avals``, ``out_fmt``, ``multi``,
        ``signatures``), ``"framework": "incubator_mxnet_tpu_torch"`` and a
        ``pt2`` file per signature where the JAX manifest names StableHLO.

        Needs one recorded forward on arrays (its signature comes first);
        ``signatures`` adds more, each a list of ``(shape, dtype)`` per
        input. The program is traced once with ``torch.export.Dim``\\ s
        over the axes the signatures vary on, bounded by their sizes, and
        every manifest entry names that one file; when the forward does
        not trace over those ranges, each signature gets a program of its
        own (``<path>-symbol.<i>.pt2``). Dropout is off and BatchNorm
        reads its running statistics (the ``predict_mode`` forward); the
        flash attention forward is one ``mxtpu::flash_attention_fwd``
        node per call.

        ``platforms``: the device types (``"cpu"``, ``"cuda"``) the
        artifact may be loaded on, by default the one it was traced on. A
        listed device other than that one gets the program moved there
        (``torch.export.passes.move_to_device_pass``) when it is loaded;
        an unlisted one raises, naming it."""
        if getattr(self, "_last_sig", None) is None:
            raise MXNetError(
                "export() needs a traced graph: call hybridize() and run one "
                "forward pass before exporting (reference behavior)")
        skeleton, n_in, in_avals, ctx = self._last_sig
        params = self._collect_params_with_prefix()
        params_file = f"{path}-{epoch:04d}.params"
        F.save(params_file, {k: p.data() for k, p in params.items()
                             if p._initialized})
        blk_params = [p for _, p in sorted(self.collect_params().items())]
        name_by_id = {id(p): k for k, p in params.items()}
        sigs = [[(tuple(s), str(d)) for s, d in in_avals]]
        for sig in (signatures or []):
            norm = [(tuple(s), dtype_name(d)) for s, d in sig]
            if len(norm) != n_in:
                raise MXNetError(
                    f"export(signatures=...): each signature needs "
                    f"{n_in} (shape, dtype) input entries, got {len(norm)}")
            if norm not in sigs:
                sigs.append(norm)
        device = ctx.torch_device
        # the device traced on first: a loader moves the program from it
        platforms = [device.type] + [p for p in platforms or ()
                                     if p != device.type]
        meta: Dict[str, object] = {}
        pure = _PureInfer(self, skeleton, n_in, blk_params, meta)
        pvals = [p._tensor().detach() for p in blk_params]
        files = _export_programs(pure, sigs, pvals, device, path)
        entries = [{"in_avals": [[list(s), d] for s, d in sig],
                    "pt2": os.path.basename(f),
                    "out_fmt": meta["out_fmt"], "multi": meta["multi"]}
                   for sig, f in zip(sigs, files)]
        primary = entries[0]
        arch = {
            "framework": "incubator_mxnet_tpu_torch",
            "block": type(self).__name__,
            "name": self.name,
            "params": sorted(params.keys()),
            "param_order": [name_by_id[id(p)] for p in blk_params],
            "param_prefix_names": [p.name for p in blk_params],
            "n_inputs": n_in,
            "in_avals": primary["in_avals"],
            "out_fmt": primary["out_fmt"],
            "multi": primary["multi"],
            "pt2": primary["pt2"],
            "signatures": entries,
            "platforms": platforms,
            "torch": torch.__version__,
        }
        sym_file = f"{path}-symbol.json"
        with open(sym_file, "w") as f:
            json.dump(arch, f, indent=2)
        return sym_file, params_file

    # ------------------------------------------------------------------
    # subgraph backends (JAX counterpart: ``gluon/block.py:737-852``)
    # ------------------------------------------------------------------
    def optimize_for(self, x, *args, backend=None, **kwargs):
        """Apply a subgraph backend, then hybridize and run once (JAX
        counterpart: ``gluon/block.py:737``). Block-rewrite backends
        (:func:`register_subgraph_backend`, e.g. ``"INT8"``) change the
        block tree in place; property backends (``mx.subgraph``) trace the
        forward symbolically, partition it and make the partitioned graph
        this block's compute while it is hybridized (evaluated eagerly,
        on the card too). ``backend=None`` (or ``"XLA"``) reverts an
        earlier partitioning."""
        if backend in (None, "XLA", "xla"):
            self._sg_graph = None
        else:
            from .. import subgraph as _subgraph
            if backend in _SUBGRAPH_BACKENDS:
                self._sg_graph = None
                _SUBGRAPH_BACKENDS[backend](self, x, *args, **kwargs)
            elif backend in _subgraph._BACKENDS:
                if kwargs:
                    raise MXNetError(
                        f"subgraph property backend {backend!r} takes no "
                        f"options; got {sorted(kwargs)}")
                self._install_partitioned_graph(backend, x, *args)
            else:
                raise MXNetError(
                    f"unknown subgraph backend {backend!r}; registered "
                    f"block passes: {sorted(_SUBGRAPH_BACKENDS)}, property "
                    f"backends: {_subgraph.list_backends()} (register with "
                    "gluon.block.register_subgraph_backend or "
                    "mx.subgraph.register_backend)")
        self.hybridize()
        return self(x, *args)

    def _install_partitioned_graph(self, backend, x, *args) -> None:
        """Trace the forward symbolically, partition it and install it
        (JAX counterpart: ``gluon/block.py:785``)."""
        from .. import subgraph as _subgraph
        from .. import symbol as S
        bad = self._training_dependent_children()
        if bad:
            raise MXNetError(
                "property-backend partitioning traces the forward once in "
                "inference mode, which would bake training-time behavior "
                f"out of {bad}; blocks with training-dependent state "
                "(Dropout masks, BatchNorm running stats) are not supported "
                "here yet — use a block-rewrite backend "
                "(gluon.block.register_subgraph_backend) or plain "
                "hybridize() for this net")
        self._sg_graph = None
        self(x, *args)   # finish deferred init so params have shapes
        data_vars = [S.Variable(f"data{i}") for i in range(1 + len(args))]
        out = self.forward(*data_vars)   # the Symbol path
        if isinstance(out, (list, tuple)):
            out = S.Group(list(out))
        self._sg_graph = (_subgraph.partition(out, backend),
                          [v.name for v in data_vars])
        self._clear_cached_op()

    def _training_dependent_children(self) -> List[str]:
        """Descendants whose forward depends on training mode or moves
        running state (JAX counterpart: ``gluon/block.py:811``)."""
        from ..nn import BatchNorm, Dropout
        bad = []

        def walk(b):
            for child in b._children.values():
                if isinstance(child, (Dropout, BatchNorm)):
                    bad.append(f"{type(child).__name__}({child.name})")
                walk(child)

        walk(self)
        return bad

    def _forward_partitioned(self, *args):
        """Evaluate the partitioned graph over the inputs and this block's
        parameters, recorded under ``autograd.record()`` (JAX counterpart:
        ``gluon/block.py:828``)."""
        from .. import symbol as S
        part, names = self._sg_graph
        vals = dict(zip(names, _unwrap(args)))
        for pname, p in self.collect_params().items():
            vals[pname] = p._tensor()
        arg_names = part.list_arguments()
        missing = [a for a in arg_names if a not in vals]
        if missing:
            raise MXNetError(
                f"partitioned graph argument(s) {missing} not found among "
                "data inputs or parameters")
        with torch.set_grad_enabled(autograd.is_recording()):
            out = S._eval_graph(part, arg_names,
                                [vals[a] for a in arg_names])
        if part._op == "_group":
            return [_wrap(o) for o in out]
        return _wrap(out)


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

        # the warm run is not a call: the running statistics it moved
        # (aux parameters, ``grad_req="null"``) go back, so that this call
        # moves them once, by its replay
        aux = [p._var for p in self.params if p.grad_req == "null"]
        saved = [t.detach().clone() for t in aux]

        def warm():
            outs = forward()
            if rec and any(o.requires_grad for o in outs):
                backward(outs, [torch.ones_like(o) for o in outs
                                if o.requires_grad])
            with torch.no_grad():
                for t, v in zip(aux, saved):
                    t.copy_(v)

        self.fwd = graphs.Graph(self.device, gens)
        outs = self.fwd.capture(forward, warm=warm,
                                what=f"the capture of {block.name}")
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


class _ArrSlot:
    """An array's place in a recorded call's skeleton (JAX counterpart:
    ``gluon/block.py:121``)."""

    __slots__ = ()


_ARR_SLOT = _ArrSlot()


def _strip_arrays(args) -> tuple:
    def rec(a):
        if isinstance(a, (NDArray, torch.Tensor)):
            return _ARR_SLOT
        if isinstance(a, (list, tuple)):
            return [rec(x) for x in a]
        return a

    return tuple(rec(a) for a in args)


def _rebuild_args(skeleton, it) -> list:
    """``skeleton`` with each slot taken from ``it`` in order (JAX
    counterpart: ``gluon/block.py:860``)."""
    def rec(a):
        if isinstance(a, _ArrSlot):
            return next(it)
        if isinstance(a, (list, tuple)):
            return [rec(x) for x in a]
        return a

    return [rec(a) for a in skeleton]


def _signature(args) -> tuple:
    """``HybridBlock._last_sig`` of a call (JAX counterpart:
    ``gluon/block.py:526-528``)."""
    arrays = [_unwrap(a) for a in _flatten(args)[0]
              if isinstance(a, (NDArray, torch.Tensor))]
    return (_strip_arrays(args), len(arrays),
            [(tuple(t.shape), dtype_name(t.dtype)) for t in arrays],
            Context.from_device(arrays[0].device))


def _flatten_out(outs) -> Tuple[list, list]:
    """The leaves of a forward's outputs and their format: 0 a tensor, -1
    any other leaf, a list a nesting (JAX counterpart: ``_flatten_args``,
    ``gluon/block.py:104``)."""
    flat: list = []

    def rec(a):
        if isinstance(a, torch.Tensor):
            flat.append(a)
            return 0
        if isinstance(a, (list, tuple)):
            return [rec(x) for x in a]
        flat.append(a)
        return -1

    return flat, [rec(a) for a in outs]


def _regroup(flat, fmt) -> list:
    """Rebuild the nesting ``fmt`` over ``flat`` (JAX counterpart:
    ``gluon/block.py:157``)."""
    it = iter(flat)

    def rec(f):
        if f == 0 or f == -1:
            return next(it)
        return [rec(x) for x in f]

    return [rec(f) for f in fmt]


class _PureInfer(nn.Module):
    """A block's inference forward in functional form, ``(*inputs,
    *params) -> flat outputs`` (JAX counterpart: ``_make_pure_infer``,
    ``gluon/block.py:596``): the parameters enter through the aliases a
    cached op captures with (:data:`_ALIASES`), so a traced program reads
    them as inputs and holds no copy of them, and the block is kept out of
    the module's attributes for the same reason. Dropout is off, BatchNorm
    reads its running statistics. ``meta`` gets ``out_fmt`` and ``multi``
    when it runs (the caller keeps it: ``torch.export`` leaves copies of a
    module's containers on the module)."""

    def __init__(self, block: HybridBlock, skeleton, n_in: int,
                 params: List[Parameter], meta: dict):
        super().__init__()
        self.__dict__["_blk"] = block
        self._skeleton = skeleton
        self._n_in = n_in
        self._plist = list(params)
        self.meta = meta

    def forward(self, *vals):
        ins, pvals = vals[:self._n_in], vals[self._n_in:]
        args = _rebuild_args(self._skeleton, iter(ins))
        _ALIASES.map = {id(p): v for p, v in zip(self._plist, pvals)}
        try:
            with autograd.pause(train_mode=False):
                out = self._blk(*args)
        finally:
            _ALIASES.map = None
        multi = isinstance(out, (tuple, list))
        flat, self.meta["out_fmt"] = _flatten_out(out if multi else (out,))
        self.meta["multi"] = multi
        return tuple(flat)


def _signature_dims(sigs) -> Tuple[Optional[list], list]:
    """The ``torch.export.Dim`` of each axis the signatures vary on (axes
    whose sizes vary alike share one), bounded by those sizes, as one
    ``{axis: Dim}`` per input; and example ``(shape, dtype)``\\ s with each
    such axis at its largest (an example size of 1 would be specialised).
    ``(None, first signature)`` when nothing varies or the signatures
    differ in a rank or a dtype."""
    first = sigs[0]
    if any([(len(s), d) for s, d in sig] != [(len(s), d) for s, d in first]
           for sig in sigs):
        return None, first
    dims: Dict[tuple, object] = {}
    spec, example = [], []
    for i, (shape, dtype) in enumerate(first):
        axes, ex = {}, list(shape)
        for a in range(len(shape)):
            sizes = tuple(sig[i][0][a] for sig in sigs)
            if len(set(sizes)) == 1:
                continue
            d = dims.get(sizes)
            if d is None:
                d = dims[sizes] = torch.export.Dim(
                    f"d{len(dims)}", min=min(sizes), max=max(sizes))
            axes[a] = d
            ex[a] = max(sizes)
        spec.append(axes or None)
        example.append((tuple(ex), dtype))
    return (spec if dims else None), example


def _trace(pure: _PureInfer, shapes, pvals, device, spec):
    """``torch.export`` of ``pure`` (non-strict: the forward runs as
    Python over fake tensors) at example inputs of ``shapes``."""
    ins = tuple(torch.zeros(s, dtype=torch_dtype(d), device=device)
                for s, d in shapes)
    dynamic = None if spec is None \
        else (tuple(spec) + (None,) * len(pvals),)
    ep = torch.export.export(pure, ins + tuple(pvals),
                             dynamic_shapes=dynamic, strict=False)
    ep.example_inputs = None    # they hold the weights: not saved
    return ep


def _export_programs(pure: _PureInfer, sigs, pvals, device,
                     path: str) -> List[str]:
    """Write the program(s) of ``sigs`` and return each signature's file:
    one program with ``Dim``\\ s over the varying axes that every
    signature names, or, when the forward does not trace over those
    ranges, one static program per signature."""
    spec, example = _signature_dims(sigs)
    if spec is not None:
        try:
            ep = _trace(pure, example, pvals, device, spec)
        except Exception:  # noqa: BLE001 — each signature apart below
            pass
        else:
            torch.export.save(ep, f"{path}-symbol.pt2")
            return [f"{path}-symbol.pt2"] * len(sigs)
    files = []
    for i, sig in enumerate(sigs):
        f = f"{path}-symbol.pt2" if i == 0 else f"{path}-symbol.{i}.pt2"
        torch.export.save(_trace(pure, sig, pvals, device, None), f)
        files.append(f)
    return files


#: block-rewrite subgraph backends (JAX counterpart:
#: ``gluon/block.py:854``)
_SUBGRAPH_BACKENDS: Dict[str, Callable] = {}


def register_subgraph_backend(name: str, fn: Optional[Callable] = None):
    """Register a block-rewrite pass ``fn(block, x, *args, **kwargs)``
    that changes the block tree in place before :meth:`HybridBlock.
    optimize_for` runs it; usable as a decorator (JAX counterpart:
    ``gluon/block.py:857``)."""
    def _do(f):
        _SUBGRAPH_BACKENDS[name] = f
        return f
    return _do(fn) if fn is not None else _do


@register_subgraph_backend("INT8")
def _int8_backend(block, x, *args, calib_data=None, calib_mode="naive",
                  exclude_layers=(), **kwargs):
    from ..quantization import quantize_net
    quantize_net(block, calib_data=list(calib_data or [x]),
                 calib_mode=calib_mode, exclude_layers=exclude_layers)


class SymbolBlock(HybridBlock):
    """A runnable block rebuilt from an exported artifact, without the
    class that made it (JAX counterpart: ``gluon/block.py:870-1049``).

    :meth:`imports` reads the manifest, loads each ``torch.export``
    program (``torch.export.load``; the flash forward node resolves to
    the registered ``mxtpu::flash_attention_fwd``) and the ``.params``
    weights as Parameters under their structural names. A call picks the
    signature of its input shapes and runs the program over the inputs
    and the parameters' own tensors, on their device: a program traced on
    another device type listed in the manifest's ``platforms`` is moved
    there first (``move_to_device_pass``); an unlisted one raises. So
    :meth:`set_weights` and :meth:`load_parameters`, which write into
    those tensors in place, reach a CUDA graph captured over the call
    with no capture. A JAX package manifest (StableHLO) is refused, naming
    its format: its weights load with :meth:`HybridBlock.load_parameters`
    into a block of the model's class."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        self._outputs = outputs
        self._inputs = inputs
        self._sigs: List[dict] = []
        self._arch = outputs if isinstance(outputs, dict) else None
        self._loaded: Dict[str, object] = {}    # pt2 file -> its program
        self._programs: Dict[tuple, nn.Module] = {}

    @staticmethod
    def imports(symbol_file: str, input_names,
                param_file: Optional[str] = None, ctx=None) -> "SymbolBlock":
        with open(symbol_file) as f:
            arch = json.load(f)
        framework = arch.get("framework")
        if framework != "incubator_mxnet_tpu_torch":
            fmt = "StableHLO (jax.export)" if "stablehlo" in arch \
                else "in an unknown format"
            raise MXNetError(
                f"{symbol_file}: a manifest of {framework!r} whose graph is "
                f"{fmt}; this package runs torch.export programs written by "
                "its own HybridBlock.export(). Load the artifact's weights "
                "(its .params file) with load_parameters() into a block of "
                "the model's class and export that")
        blk = SymbolBlock(arch, input_names)
        base = os.path.dirname(os.path.abspath(symbol_file))
        for ent in arch.get("signatures") or []:
            file = os.path.join(base, ent["pt2"])
            if file not in blk._loaded:
                blk._loaded[file] = torch.export.load(file)
            blk._sigs.append({
                "pt2": file,
                "in_avals": [(tuple(s), str(d)) for s, d in ent["in_avals"]],
                "out_fmt": ent["out_fmt"], "multi": ent["multi"]})
        if param_file:
            loaded = F.load(param_file)
            if not isinstance(loaded, dict):
                raise MXNetError(f"{param_file}: expected a name->array dict")
            for name, arr in loaded.items():
                p = blk.params.get(name, shape=arr.shape,
                                   dtype=dtype_name(arr._data.dtype))
                p._load_init(arr, ctx)
        return blk

    def signatures(self) -> List[Tuple[Tuple[tuple, str], ...]]:
        """The input (shape, dtype) signatures this artifact can run."""
        return [tuple(s["in_avals"]) for s in self._sigs]

    def _sig_for(self, ins) -> dict:
        shapes = [tuple(i.shape) for i in ins]
        dtypes = [dtype_name(i.dtype) for i in ins]
        shape_hits = [s for s in self._sigs
                      if [a[0] for a in s["in_avals"]] == shapes]
        for s in shape_hits:
            if [a[1] for a in s["in_avals"]] == dtypes:
                return s
        if shape_hits:
            return shape_hits[0]
        have = ", ".join(
            "(" + ", ".join(f"{a[0]}:{a[1]}" for a in s["in_avals"]) + ")"
            for s in self._sigs) or "<none>"
        raise MXNetError(
            f"no exported graph matches input shapes {shapes}; this "
            f"artifact was exported for: {have}. Re-export with "
            "signatures=[...] covering the needed shape buckets "
            "(serve.export_for_serving does this from a BucketTable).")

    def _program(self, file: str, device: torch.device) -> nn.Module:
        """The program of ``file`` as a module running on ``device``."""
        key = (file, device.type)
        mod = self._programs.get(key)
        if mod is None:
            platforms = self._arch["platforms"]
            if device.type not in platforms:
                raise MXNetError(
                    f"this artifact was exported for {platforms}, not for "
                    f"{device.type!r} (the device of its parameters): "
                    "export it with platforms=[..., "
                    f"{device.type!r}]")
            ep = self._loaded[file]
            if device.type != platforms[0]:
                from torch.export.passes import move_to_device_pass
                ep = move_to_device_pass(ep, device)
            mod = self._programs[key] = ep.module()
        return mod

    def _param_tensors(self) -> List[torch.Tensor]:
        try:
            return [self.params[n]._tensor()
                    for n in self._arch["param_order"]]
        except KeyError as e:
            raise MXNetError(f"missing parameter {e} — pass param_file to "
                             "imports()") from e

    def set_weights(self, mapping, ctx=None, allow_missing: bool = False,
                    ignore_extra: bool = False) -> int:
        """Write new values into the parameters in place (shapes must
        match) and return how many were written. ``mapping`` maps manifest
        (structural) names, or training-time prefix names through the
        manifest's ``param_prefix_names``, to NDArrays, tensors or numpy
        arrays: the registry's path for a checkpoint's weights (JAX
        counterpart: ``gluon/block.py:964``)."""
        arch = self._arch or {}
        order = arch.get("param_order", [])
        by_prefix = dict(zip(arch.get("param_prefix_names", []), order))
        known = set(order) | set(self.params.keys())
        resolved: Dict[str, NDArray] = {}
        for name, arr in mapping.items():
            target = name if name in known else by_prefix.get(name)
            if target is None:
                if ignore_extra:
                    continue
                raise MXNetError(
                    f"set_weights: {name!r} is not a parameter of this "
                    f"artifact (known: {sorted(known)[:8]}...)")
            if not isinstance(arr, NDArray):
                arr = NDArray(torch.as_tensor(onp.asarray(arr)))
            old = self.params._params.get(target)
            if old is not None and old._initialized \
                    and tuple(old.shape) != tuple(arr.shape):
                raise MXNetError(
                    f"set_weights: shape mismatch for {target!r}: artifact "
                    f"has {tuple(old.shape)}, new value is "
                    f"{tuple(arr.shape)}")
            resolved[target] = arr
        if not allow_missing:
            missing = [n for n in order if n not in resolved
                       and n not in self.params]
            if missing:
                raise MXNetError(f"set_weights: missing parameters "
                                 f"{missing}; pass allow_missing=True to "
                                 "keep current values")
        for name, arr in resolved.items():
            p = self.params._params.get(name)
            if p is None:
                p = self.params.get(name, shape=arr.shape,
                                    dtype=dtype_name(arr._data.dtype))
            p._load_init(arr, ctx)
        return len(resolved)

    def load_parameters(self, filename: str, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False, cast_dtype: bool = False,
                        dtype_source: str = "current") -> None:
        """Refresh the weights from a ``.params`` file, in place (JAX
        counterpart: ``gluon/block.py:1012``)."""
        loaded = F.load(filename)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename}: expected a name->array dict")
        self.set_weights(loaded, ctx=ctx, allow_missing=allow_missing,
                         ignore_extra=ignore_extra)

    load_params = load_parameters

    def forward(self, *inputs):
        """Run the program of the inputs' signature: NDArrays give
        NDArrays, tensors tensors (JAX counterpart: ``gluon/block.py:
        1026``)."""
        if not self._sigs:
            raise MXNetError(
                "this SymbolBlock was imported from a manifest without a "
                "torch.export program; re-export with HybridBlock.export()")
        n_in = self._arch["n_inputs"]
        if len(inputs) != n_in:
            raise MXNetError(f"expected {n_in} input array(s), "
                             f"got {len(inputs)}")
        pvals = self._param_tensors()
        nd_in = _has_nd(inputs)
        ins = [torch.as_tensor(_unwrap(i)) for i in inputs]
        device = pvals[0].device if pvals else ins[0].device
        ins = [i.to(device) for i in ins]
        sig = self._sig_for(ins)
        with torch.no_grad():
            outs = self._program(sig["pt2"], device)(*ins, *pvals)
        result = _regroup(list(outs), sig["out_fmt"])
        if nd_in:
            result = _wrap(result)
        return tuple(result) if sig["multi"] else result[0]

    def hybrid_forward(self, F, x, *args, **kwargs):
        return self.forward(x, *args)
