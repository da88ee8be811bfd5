"""CompiledModel: bucketed inference over an ``nn.Module``, one CUDA graph
per bucket on the card.

Counterpart: the JAX package's ``serve/compiled.py`` (``CompiledModel`` at
``:52-453``). Inputs are padded onto a :class:`~.buckets.BucketTable`, the
module runs under ``torch.inference_mode()`` in ``eval()``, and the padding
is sliced off every output, which comes back as an ``NDArray`` (one, or a
tuple) on the model's device.

The JAX model keeps one frozen executable per bucket (``_compile`` ``:278``,
``warmup`` ``:331``); here it is one CUDA graph per bucket
(:mod:`...ops.cuda.graphs`). On the card :meth:`CompiledModel.warmup`
runs each bucket's forward once on the capture stream (the kernels build,
cuBLAS settles) and captures it over static input buffers of that bucket;
every bucket's graph draws from one memory pool of the model, which is safe
because the model's lock lets one bucket replay at a time. :meth:`predict`
copies the padded host arrays into the bucket's static inputs, replays,
and copies the outputs out before it lets go of the lock: the next replay
rewrites the graph's outputs, so no caller ever holds them. On the CPU a
bucket runs eagerly, the same function. The ``stats`` counters keep the
JAX keys: ``compiles`` counts captures (first runs on the CPU), and a
bucket's first call after :meth:`warmup` counts as ``post_warmup_compiles``,
the counter the serving contract asserts on.

:meth:`CompiledModel.refresh_params` is the version swap (JAX ``:200``):
weights written in place (``Parameter.set_data`` copies) need nothing,
since the graphs read the parameters' own storage; a parameter given new
storage (re-initialised, cast) makes every captured bucket capture again,
each counted as a compile. Numerics taps, the autotune consult and the
memory ledger come with later slices.

Artifact mode (JAX ``:114-125``): over a :class:`~..gluon.SymbolBlock`
imported from :func:`export_for_serving`'s files, a bucket runs (on the
card: its graph captures) the loaded ``torch.export`` program over the
artifact's parameters, with no Python model. The signature comes from the
manifest; a bucket the artifact was not exported for raises, naming the
ones it has. Its parameters are the block's own tensors, so
``SymbolBlock.set_weights`` reaches every graph with no capture.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch
from torch import nn

from ..base import MXNetError, dtype_name, torch_dtype
from ..context import as_context, resolve_device
from ..gluon.block import SymbolBlock, _rebuild_args
from ..ndarray import NDArray
from ..ops.cuda import graphs
from .buckets import BucketTable

__all__ = ["CompiledModel", "export_for_serving"]


def _as_numpy(x) -> onp.ndarray:
    """Host copy of a request input (JAX counterpart:
    ``serve/compiled.py:46``)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


def _dtype_name(dt) -> str:
    """The numpy name of an input's dtype (serving inputs cross the host
    as numpy arrays)."""
    name = dtype_name(dt)
    try:
        onp.dtype(name)
    except TypeError:
        raise MXNetError(f"serving inputs must have a numpy dtype, got "
                         f"{name}") from None
    return name


def _place(block: nn.Module, ctx) -> None:
    """Move ``block`` to ``ctx``'s device: a Gluon block's initialised
    parameters by ``reset_ctx`` (their context moves with them), then every
    other tensor of the module."""
    collect = getattr(block, "collect_params", None)
    if collect is not None:
        for p in collect().values():
            if p._initialized and p.list_ctx()[0] != ctx:
                p.reset_ctx(ctx)
    block.to(ctx.torch_device)


class _BucketGraph:
    """One bucket's captured forward: the graph, its static inputs and the
    outputs each replay rewrites."""

    __slots__ = ("graph", "inputs", "outputs", "multi")

    def __init__(self, graph, inputs, outputs, multi):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.multi = multi


class CompiledModel:
    """Bucketed inference over an ``nn.Module`` (JAX counterpart:
    ``serve/compiled.py:52``).

    ``example_args`` fix the call signature: the number of inputs, their
    ranks, dtypes and the sizes of unbucketed dims. A Gluon block that has
    run on arrays alone already carries it (its last call), and then
    ``example_args`` may be left out (JAX ``:129-140``). ``input_axes``:
    one ``{axis_index: bucket_axis_name}`` dict per input naming the dims
    that get padded. ``output_axes``: the same per output; default pads
    every output's axis 0 back from the ``"batch"`` bucket (or the table's
    first axis). ``pad_values``: a scalar or one per input. ``ctx`` (JAX
    ``:74``, ``:141``): the module is placed on its device first (a Gluon
    block's parameters by ``reset_ctx``); by default it stays where its
    parameters are. Inputs go to the device of the module's parameters.
    ``donate`` is taken for the JAX signature: requests are copied into
    each bucket's static inputs, so there is nothing to donate.
    """

    def __init__(self, block: nn.Module, table: BucketTable,
                 input_axes: Sequence[Dict[int, str]],
                 example_args: Optional[Sequence] = None,
                 output_axes: Optional[Sequence[Dict[int, str]]] = None,
                 pad_values: Any = 0, donate: Any = "auto", ctx=None):
        if not isinstance(block, nn.Module):
            raise MXNetError(f"CompiledModel wraps an nn.Module, not "
                             f"{type(block)}")
        if ctx is not None:
            _place(block, as_context(ctx))
        self._skeleton = None
        if isinstance(block, SymbolBlock):
            if not block._sigs:
                raise MXNetError("artifact has no torch.export programs; "
                                 "re-export with HybridBlock.export()")
            self._mode = "artifact"
            in_avals = [(tuple(s), str(d))
                        for s, d in block._sigs[0]["in_avals"]]
        elif example_args is not None:
            self._mode = "block"
            in_avals = [(tuple(a.shape), _dtype_name(
                a.dtype if hasattr(a, "dtype") else onp.asarray(a).dtype))
                for a in example_args]
        elif getattr(block, "_last_sig", None) is not None:
            self._mode = "block"
            self._skeleton, _, in_avals, _ = block._last_sig
        else:
            raise MXNetError(
                "CompiledModel over a live block needs either a prior "
                "forward on arrays or example_args to establish the call "
                "signature")
        self._block = block.eval()
        self._table = table
        self._input_axes = [dict(a) for a in input_axes]
        self._output_axes = ([dict(a) for a in output_axes]
                             if output_axes is not None else None)
        p = next(iter(self._tensors()), None)
        self._device = p.device if p is not None else resolve_device()
        self._graphed = self._device.type == "cuda"
        self._lock = threading.RLock()
        self._seen_buckets: set = set()
        #: bucket key -> its captured forward (on the card)
        self._graphs: Dict[tuple, _BucketGraph] = {}
        self._share: Optional[graphs.Graph] = None
        self._param_ptrs: tuple = ()
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "compiles": 0, "warmup_compiles": 0,
            "post_warmup_compiles": 0}
        self._warmed = False
        self._n_in = len(in_avals)
        self._in_avals: List[Tuple[tuple, str]] = in_avals
        if len(self._input_axes) != self._n_in:
            raise MXNetError(
                f"input_axes has {len(self._input_axes)} entries but the "
                f"model takes {self._n_in} array inputs")
        for spec in self._input_axes:
            for name in spec.values():
                if name not in table.axes:
                    raise MXNetError(f"input_axes names bucket axis "
                                     f"{name!r} not in {table!r}")
        for spec, (shape, _d) in zip(self._input_axes, self._in_avals):
            for axis in spec:
                if axis >= len(shape):
                    raise MXNetError(
                        f"input_axes maps axis {axis} but the example "
                        f"input has shape {shape}")
        if onp.isscalar(pad_values) or pad_values is None:
            pad_values = [pad_values or 0] * self._n_in
        self._pad_values = list(pad_values)
        if len(self._pad_values) != self._n_in:
            raise MXNetError(
                f"pad_values has {len(self._pad_values)} entries but the "
                f"model takes {self._n_in} array inputs")
        self._primary_axis = ("batch" if "batch" in table.axes
                              else sorted(table.axes)[0])

    # -- parameters -----------------------------------------------------
    def _tensors(self) -> List[torch.Tensor]:
        """The module's parameters and buffers (an artifact's parameters),
        once each."""
        if self._mode == "artifact":
            return self._block._param_tensors()
        seen = {}
        for t in itertools.chain(self._block.parameters(),
                                 self._block.buffers()):
            if not isinstance(t, nn.parameter.UninitializedParameter):
                seen[id(t)] = t
        return list(seen.values())

    def refresh_params(self) -> None:
        """Re-read the parameters after a weight swap (JAX counterpart:
        ``serve/compiled.py:200``). Weights written in place need nothing;
        a parameter given new storage makes every captured bucket capture
        again, each counted as a compile."""
        with self._lock:
            ptrs = tuple(t.data_ptr() for t in self._tensors())
            if not self._graphs or ptrs == self._param_ptrs:
                return
            keys = list(self._graphs)
            self._graphs.clear()
            self._share = None      # the stale graphs' pool goes with them
            for key in keys:
                self._capture(key)
                self._note_compile(key)

    def resident_bytes(self) -> int:
        """Device bytes this model holds between requests: its weights
        and, on the card, the segments of its graphs' memory pool (from
        ``torch.cuda.memory_snapshot``) and the static inputs."""
        with self._lock:
            n = sum(t.numel() * t.element_size() for t in self._tensors())
            if not self._graphs:
                return n
            n += sum(t.numel() * t.element_size()
                     for g in self._graphs.values() for t in g.inputs)
            pool = tuple(self._share.pool)
            n += sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) == pool)
            return n

    # -- bucketing ------------------------------------------------------
    def signature_for(self, assignment: Dict[str, int]
                      ) -> List[Tuple[tuple, str]]:
        """Input (shape, dtype) list for one bucket assignment (JAX
        counterpart: ``serve/compiled.py:217``)."""
        sig = []
        for (shape, dtype), spec in zip(self._in_avals, self._input_axes):
            s = list(shape)
            for axis, name in spec.items():
                s[axis] = assignment[name]
            sig.append((tuple(s), dtype))
        return sig

    def _sizes_of(self, arrays: Sequence[onp.ndarray]) -> Dict[str, int]:
        sizes: Dict[str, int] = {}
        for a, spec in zip(arrays, self._input_axes):
            for axis, name in spec.items():
                if axis >= a.ndim:
                    raise MXNetError(
                        f"input has rank {a.ndim} but input_axes maps "
                        f"axis {axis}")
                sizes[name] = max(sizes.get(name, 0), a.shape[axis])
        return sizes

    # -- compilation: a capture per bucket on the card -------------------
    def _note_compile(self, key: tuple) -> None:
        self._seen_buckets.add(key)
        self.stats["compiles"] += 1
        if self._warmed:
            self.stats["post_warmup_compiles"] += 1
        else:
            self.stats["warmup_compiles"] += 1

    def _forward(self, inputs: List[torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], bool]:
        args = inputs if self._skeleton is None \
            else _rebuild_args(self._skeleton, iter(inputs))
        with torch.inference_mode():
            outs = self._block(*args)
        multi = isinstance(outs, (tuple, list))
        return (list(outs) if multi else [outs]), multi

    def _capture(self, key: tuple) -> None:
        """Run bucket ``key``'s forward once on the capture stream, then
        capture it over static inputs filled with the pad values; a failed
        capture raises, naming the bucket."""
        inputs = [torch.full(s, pv, dtype=torch_dtype(d), device=self._device)
                  for (s, d), pv in zip(key, self._pad_values)]
        what = f"the capture of bucket {[s for s, _ in key]}"
        try:
            g = graphs.Graph(self._device, share=self._share)
            box = {}

            def fwd():
                outs, box["multi"] = self._forward(inputs)
                return outs

            outs = g.capture(fwd, warm=lambda: self._forward(inputs),
                             what=what)
        except Exception as e:  # noqa: BLE001 — re-raised, naming it
            raise MXNetError(f"{what} failed: {type(e).__name__}: "
                             f"{e}") from e
        if self._share is None:
            self._share = g
        self._param_ptrs = tuple(t.data_ptr() for t in self._tensors())
        self._graphs[key] = _BucketGraph(g, inputs, outs, box["multi"])

    def warmup(self) -> Dict[str, Any]:
        """Capture (on the CPU: run) every bucket combination, filled with
        the pad values; returns ``{"buckets", "compiled", "seconds"}``.
        Afterwards a first run of any bucket counts as
        ``post_warmup_compiles`` (JAX counterpart:
        ``serve/compiled.py:331``)."""
        t0 = time.perf_counter()
        n = 0
        # holding the lock across warmup is the contract: predict() callers
        # wait until every bucket exists instead of racing half a table
        with self._lock:
            for assignment in self._table.assignments():
                key = tuple(self.signature_for(assignment))
                if key in self._seen_buckets:
                    continue
                if self._graphed:
                    self._capture(key)
                else:
                    self._run_eager([onp.full(s, pv, dtype=d) for (s, d), pv
                                     in zip(key, self._pad_values)])
                self._note_compile(key)
                n += 1
            if self._graphed:
                torch.cuda.synchronize(self._device)
            self._warmed = True
        return {"buckets": self._table.num_buckets(), "compiled": n,
                "seconds": round(time.perf_counter() - t0, 3)}

    def cache_info(self) -> Dict[str, int]:
        """Copy of the bucket counters plus the number of buckets built
        (JAX counterpart: ``serve/compiled.py:355``)."""
        with self._lock:
            info = dict(self.stats)
            info["cached_executables"] = len(self._seen_buckets)
            info["warmed_up"] = self._warmed
        return info

    # -- inference ------------------------------------------------------
    def _pad(self, arrays: List[onp.ndarray],
             assignment: Dict[str, int]) -> List[onp.ndarray]:
        out = []
        for a, spec, pv, (shape, dtype) in zip(
                arrays, self._input_axes, self._pad_values, self._in_avals):
            target = list(a.shape)
            for axis, name in spec.items():
                target[axis] = assignment[name]
            a = a.astype(dtype, copy=False)
            if tuple(target) != a.shape:
                widths = [(0, t - s) for s, t in zip(a.shape, target)]
                a = onp.pad(a, widths, mode="constant", constant_values=pv)
            out.append(a)
        return out

    def _run_eager(self, padded: List[onp.ndarray]
                   ) -> Tuple[List[torch.Tensor], bool]:
        return self._forward([torch.from_numpy(onp.ascontiguousarray(a))
                              .to(self._device) for a in padded])

    def _replay(self, entry: _BucketGraph, padded: List[onp.ndarray],
                sizes: Dict[str, int]) -> List[torch.Tensor]:
        """Fill the static inputs, replay, and copy the outputs out (sliced
        to the request's sizes); the caller holds the model lock."""
        with torch.inference_mode():
            for dst, a in zip(entry.inputs, padded):
                dst.copy_(torch.from_numpy(onp.ascontiguousarray(a)))
            entry.graph.replay()
            return [o.clone() for o in self._unpad(entry.outputs, sizes)]

    def predict(self, *args):
        """Pad the inputs onto their bucket, run the bucket (replay its
        graph on the card) and slice the padding off every output, so
        callers never see bucket geometry. Accepts NDArrays, tensors, numpy
        arrays or nested lists; returns an NDArray or a tuple of NDArrays
        on the model's device (JAX counterpart:
        ``serve/compiled.py:379``)."""
        arrays = [_as_numpy(a) for a in args]
        if len(arrays) != self._n_in:
            raise MXNetError(f"expected {self._n_in} inputs, "
                             f"got {len(arrays)}")
        sizes = self._sizes_of(arrays)
        assignment = self._table.assignment(sizes)
        key = tuple(self.signature_for(assignment))
        padded = self._pad(arrays, assignment)
        # one bucket runs at a time (the graphs share one pool, and a weight
        # swap takes the lock); a first run of a bucket blocks peers: two
        # threads racing the same missing bucket make ONE graph
        with self._lock:
            if key in self._seen_buckets:
                self.stats["hits"] += 1
            else:
                self.stats["misses"] += 1
                if self._graphed:
                    self._capture(key)
                self._note_compile(key)
            if self._graphed:
                entry = self._graphs[key]
                outs = self._replay(entry, padded, sizes)
                multi = entry.multi
            else:
                flat, multi = self._run_eager(padded)
                outs = self._unpad(flat, sizes)
        nds = tuple(NDArray(o) for o in outs)
        return nds if multi else nds[0]

    __call__ = predict

    def _unpad(self, flat: List[torch.Tensor],
               sizes: Dict[str, int]) -> List[torch.Tensor]:
        out_axes = self._output_axes
        if out_axes is None:
            out_axes = [{0: self._primary_axis}] * len(flat)
        if len(out_axes) != len(flat):
            raise MXNetError(
                f"output_axes has {len(out_axes)} entries but the model "
                f"returned {len(flat)} outputs")
        outs = []
        for o, spec in zip(flat, out_axes):
            slicer = [slice(None)] * o.ndim
            for axis, name in spec.items():
                if axis < o.ndim and name in sizes \
                        and o.shape[axis] != sizes[name]:
                    slicer[axis] = slice(0, sizes[name])
            outs.append(o[tuple(slicer)])
        return outs


def export_for_serving(block, path: str, table: BucketTable,
                       input_axes: Sequence[Dict[int, str]],
                       epoch: int = 0, platforms=None) -> Tuple[str, str]:
    """Export ``block`` for every bucket of ``table`` (JAX counterpart:
    ``serve/compiled.py:456``): the recorded signature of its last forward
    on arrays with the bucketed axes of ``input_axes`` set to each bucket
    assignment, through :meth:`~..gluon.HybridBlock.export` (one program
    that every bucket's manifest entry names). The files cold-load with
    ``SymbolBlock.imports`` or ``ModelRegistry.load(artifacts=)`` and serve
    every bucket with no Python model and no capture after warmup."""
    if getattr(block, "_last_sig", None) is None:
        raise MXNetError("export_for_serving needs a traced graph: call "
                         "hybridize() and run one forward first")
    _, n_in, in_avals, _ = block._last_sig
    if len(input_axes) != n_in:
        raise MXNetError(f"input_axes has {len(input_axes)} entries but "
                         f"the model takes {n_in} array inputs")
    signatures = []
    for assignment in table.assignments():
        sig = []
        for (shape, dtype), spec in zip(in_avals, input_axes):
            s = list(shape)
            for axis, name in spec.items():
                s[axis] = assignment[name]
            sig.append((tuple(s), dtype))
        signatures.append(sig)
    return block.export(path, epoch=epoch, platforms=platforms,
                        signatures=signatures)
