"""int8 quantization: calibration, the quantized layers and the pass that
swaps them in.

Counterpart: the JAX package's ``quantization/__init__.py`` (reference:
``src/operator/quantization/`` and ``python/mxnet/contrib/
quantization.py``). Three pieces, as there:

1. **Calibration**: float inference over calibration batches records each
   quantizable layer's input through forward pre-hooks:
   :class:`LayerRangeCollector` (``calib_mode='naive'``: min/max;
   ``'entropy'``: the KL-optimal threshold of an 8001-bin histogram,
   :func:`optimal_threshold`) or :func:`observe_net`'s log2-magnitude
   histograms (:class:`Observer`, percentile-clipped). This part is numpy
   and a copy of the JAX package's, so both give the same ranges from the
   same activations.
2. **The pass**: ``Dense`` and ``Conv2D`` children are swapped in place for
   :class:`QuantizedDense`/:class:`QuantizedConv2D`, whose int8 weights are
   Gluon ``Constant`` parameters and whose forward is ``quantize`` ->
   ``quantized_fully_connected``/``quantized_conv`` -> ``dequantize``
   (:mod:`..ops.quantization`; on the card ``torch._int_mm``), float32 out
   so the float layers around them compose.
3. **The API**: :func:`quantize_net` (reference ``quantize_net_v2``),
   :func:`observe_net` and :func:`quantize_model`, the quantized serving
   twin of a ``serve.CompiledModel``.

Calibration runs every block eagerly (``_eager_tree``): a hybridized
block's cached op replays CUDA graphs, which run no forward pre-hook.
``MXTPU_QUANT_PERCENTILE`` sets the Observer paths' default percentile.
``optimize_for(backend="INT8")`` and the registry's staging gate are not
ported yet.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..ndarray import NDArray
from ..nn import Conv2D, Dense
from ..ops import quantization as Q
from ..util import getenv

__all__ = ["quantize_net", "quantize_model", "observe_net",
           "QuantizedDense", "QuantizedConv2D",
           "LayerRangeCollector", "Observer", "optimal_threshold"]


def _quant_percentile(percentile: Optional[float] = None) -> float:
    """The calibration percentile: the argument, else
    ``MXTPU_QUANT_PERCENTILE``, else 99.99 (JAX counterpart:
    ``quantization/__init__.py:44``)."""
    if percentile is not None:
        return float(percentile)
    return float(getenv("MXTPU_QUANT_PERCENTILE") or 99.99)


# ---------------------------------------------------------------------------
# calibration (numpy; the JAX package's ``:58-280``)
# ---------------------------------------------------------------------------

def _smooth_distribution(p: onp.ndarray, eps: float = 1e-4) -> onp.ndarray:
    """Laplace-style smoothing so KL(p||q) is finite (reference:
    contrib/quantization.py _smooth_distribution)."""
    is_zeros = (p == 0).astype(onp.float32)
    is_nonzeros = (p != 0).astype(onp.float32)
    n_zeros = int(is_zeros.sum())
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        return None
    eps1 = eps * n_zeros / n_nonzeros
    hist = p.astype(onp.float32)
    hist += eps * is_zeros + (-eps1) * is_nonzeros
    return hist


def optimal_threshold(hist: onp.ndarray, hist_edges: onp.ndarray,
                      num_quantized_bins: int = 255) -> float:
    """KL-divergence-optimal |threshold| from a symmetric histogram
    (reference: _get_optimal_threshold, the classic TensorRT-style search).
    """
    num_bins = hist.size
    assert num_bins % 2 == 1, "use an odd bin count (symmetric around 0)"
    zero_bin = num_bins // 2
    hist = hist.astype(onp.float64)
    csum = onp.concatenate([[0.0], onp.cumsum(hist)])
    thresholds = []
    divergences = []
    # p grows outward from the zero bin; all inner work is vectorized
    # (bucket sums via cumsum, expansion via repeat) so the search is
    # O(candidates · bins) instead of the reference's python-loop square.
    for i in range(num_quantized_bins // 2 + 1, zero_bin + 1):
        p_start, p_stop = zero_bin - i, zero_bin + i + 1
        thresholds.append(hist_edges[p_stop])
        sliced = hist[p_start:p_stop]
        p = sliced.copy()
        p[0] += csum[p_start]                      # left outliers
        p[-1] += csum[-1] - csum[p_stop]           # right outliers
        # quantize p's support down to num_quantized_bins buckets
        edges = onp.round(onp.linspace(0, sliced.size, num_quantized_bins + 1)
                          ).astype(onp.int64)
        starts = edges[:-1]
        widths = onp.diff(edges)
        q = onp.add.reduceat(sliced, starts)
        q[widths == 0] = 0.0
        nz_cnt = onp.add.reduceat((sliced != 0).astype(onp.float64), starts)
        nz_cnt[widths == 0] = 0.0
        # expand q back over p's support, mass split over nonzero slots
        per_slot = onp.divide(q, nz_cnt, out=onp.zeros_like(q),
                              where=nz_cnt > 0)
        q_exp = onp.repeat(per_slot, widths) * (sliced != 0)
        ps = _smooth_distribution(p / max(p.sum(), 1e-30))
        qs = _smooth_distribution(q_exp / max(q_exp.sum(), 1e-30))
        if ps is None or qs is None:
            divergences.append(onp.inf)
            continue
        divergences.append(float(
            onp.sum(ps * onp.log(onp.maximum(ps, 1e-30) /
                                 onp.maximum(qs, 1e-30)))))
    if not divergences:
        return float(hist_edges[-1])
    return float(thresholds[int(onp.argmin(divergences))])


class LayerRangeCollector:
    """Collects per-layer input calibration statistics via forward hooks.

    naive: running min/max. entropy: 8001-bin symmetric histogram per layer,
    threshold picked by :func:`optimal_threshold` at the end.
    """

    def __init__(self, mode: str = "naive", num_bins: int = 8001):
        if mode not in ("naive", "entropy"):
            raise MXNetError(f"unknown calib_mode {mode!r}")
        self.mode = mode
        self.num_bins = num_bins
        self.minmax: Dict[str, Tuple[float, float]] = {}
        self.hists: Dict[str, Tuple[onp.ndarray, onp.ndarray]] = {}

    def collect(self, name: str, x: onp.ndarray) -> None:
        amin, amax = float(x.min()), float(x.max())
        if name in self.minmax:
            lo, hi = self.minmax[name]
            self.minmax[name] = (min(lo, amin), max(hi, amax))
        else:
            self.minmax[name] = (amin, amax)
        if self.mode == "entropy":
            th = max(abs(amin), abs(amax), 1e-8)
            if name in self.hists:
                hist, edges = self.hists[name]
                old_th = edges[-1]
                if th > old_th:
                    # rebuild on the wider range, re-binning the old mass
                    centers = (edges[:-1] + edges[1:]) / 2
                    new_hist, new_edges = onp.histogram(
                        centers, bins=self.num_bins, range=(-th, th),
                        weights=hist)
                    h, _ = onp.histogram(x.ravel(), bins=self.num_bins,
                                         range=(-th, th))
                    self.hists[name] = (new_hist + h, new_edges)
                else:
                    h, _ = onp.histogram(x.ravel(), bins=self.num_bins,
                                         range=(-old_th, old_th))
                    self.hists[name] = (hist + h, edges)
            else:
                h, edges = onp.histogram(x.ravel(), bins=self.num_bins,
                                         range=(-th, th))
                self.hists[name] = (h, edges)

    def ranges(self) -> Dict[str, Tuple[float, float]]:
        if self.mode == "naive":
            return dict(self.minmax)
        out = {}
        for name, (hist, edges) in self.hists.items():
            th = optimal_threshold(hist, edges)
            out[name] = (-th, th)
        return out


class Observer:
    """Calibration observer over log2-magnitude histogram tables (JAX
    counterpart: ``quantization/__init__.py:153``): one histogram per site
    (bucket ``i`` counts ``|x|`` in ``[2^(lo_exp+i), 2^(lo_exp+i+1))``),
    turned into per-site symmetric ranges by percentile-clipping the
    magnitude distribution (the TensorRT-style outlier cut on a coarser,
    merge-friendly support than :class:`LayerRangeCollector`'s linear
    histogram: magnitude buckets add across steps, models and processes).
    The table format is the JAX package's ``telemetry.numerics.
    calibration_table()`` (not ported yet) and :func:`observe_net`'s, so a
    table from either package quantizes the other's model.

    Round trip: ``Observer(table).to_table() == table``. ::

        obs = quantization.observe_net(net, calib_batches)
        obs.ranges()                # {"dense0": (-2.9, 2.9)}
        obs.to_table()              # strict JSON
    """

    def __init__(self, table: Optional[Dict[str, dict]] = None):
        self._sites: Dict[str, dict] = {}
        for site, rec in (table or {}).items():
            self.update(site, rec["counts"], lo_exp=rec["lo_exp"],
                        amin=rec.get("min", 0.0), amax=rec.get("max", 0.0),
                        samples=rec.get("samples", 1))

    def update(self, site: str, counts, lo_exp: int,
               amin: float = 0.0, amax: float = 0.0,
               samples: int = 1) -> None:
        """Merge one magnitude histogram into ``site`` (fixed edges:
        histograms from different steps/processes add per-bucket)."""
        counts = [float(c) for c in counts]
        c = self._sites.get(site)
        if c is None:
            self._sites[site] = {"counts": counts, "lo_exp": int(lo_exp),
                                 "min": float(amin), "max": float(amax),
                                 "samples": int(samples)}
            return
        if int(lo_exp) != c["lo_exp"] or len(counts) != len(c["counts"]):
            raise MXNetError(
                f"observer site {site!r}: incompatible histogram support "
                f"(lo_exp {lo_exp} vs {c['lo_exp']}, bins {len(counts)} "
                f"vs {len(c['counts'])})")
        c["counts"] = [a + b for a, b in zip(c["counts"], counts)]
        c["min"] = min(c["min"], float(amin))
        c["max"] = max(c["max"], float(amax))
        c["samples"] += int(samples)

    def sites(self) -> List[str]:
        return sorted(self._sites)

    def threshold(self, site: str, percentile: float = 99.99) -> float:
        """The |x| clipping threshold covering ``percentile`` % of the
        observed magnitude mass: walk the histogram from the top until
        the excluded tail would exceed the allowance, return that
        bucket's upper edge (clamped into the observed [~, max|x|])."""
        c = self._sites[site]
        counts, lo = c["counts"], c["lo_exp"]
        total = sum(counts)
        absmax = max(abs(c["min"]), abs(c["max"]))
        if total <= 0:
            return absmax or 1.0
        # (100 - p)/100, NOT 1 - p/100: the subtraction in percent
        # space is exact for the round percentiles callers pass, so a
        # bucket holding exactly the tail allowance is dropped
        allow = total * (100.0 - percentile) / 100.0
        dropped = 0.0
        cut = len(counts)                 # index of first EXCLUDED bucket
        for i in range(len(counts) - 1, -1, -1):
            if dropped + counts[i] > allow:
                break
            dropped += counts[i]
            cut = i
        th = float(2.0 ** (lo + cut))     # upper edge of the last kept
        if absmax > 0:
            th = min(th, absmax)
        return th

    def ranges(self, percentile: float = 99.99
               ) -> Dict[str, Tuple[float, float]]:
        """Symmetric per-site quantization ranges ``(-t, t)`` — the
        ``in_range`` shape :func:`quantize_net`'s swapped layers take."""
        return {site: (-self.threshold(site, percentile),
                       self.threshold(site, percentile))
                for site in self._sites}

    def to_table(self) -> Dict[str, dict]:
        """Render back to the table shape (strict JSON; round-trips a
        table fed to the constructor)."""
        return {site: {"counts": list(c["counts"]),
                       "lo_exp": int(c["lo_exp"]),
                       "bins": len(c["counts"]),
                       "min": float(c["min"]), "max": float(c["max"]),
                       "samples": int(c["samples"])}
                for site, c in sorted(self._sites.items())}


# ---------------------------------------------------------------------------
# quantized gluon layers (the swapped-in nodes of the pass)
# ---------------------------------------------------------------------------

def _q8(arr: onp.ndarray) -> Tuple[onp.ndarray, float, float]:
    """Symmetric int8 encode of a weight tensor; returns (q, min, max)."""
    mx_abs = float(onp.abs(arr).max()) or 1e-8
    q = onp.clip(onp.round(arr / (mx_abs / 127.0)), -127, 127).astype(onp.int8)
    return q, -mx_abs, mx_abs


class _QuantizedLayerBase:
    """Mixin marking a swapped-in int8 layer (weights live as Gluon
    ``Constant`` parameters, calibrated ranges as Python floats)."""


def _weights(layer):
    """The layer's weight and bias (or None) as float numpy arrays, and
    the context they live on."""
    w = layer.weight.data().asnumpy()
    b = layer.bias.data().asnumpy() if layer.bias is not None else None
    return w, b, layer.weight.list_ctx()[0]


class QuantizedDense(HybridBlock, _QuantizedLayerBase):
    """int8 Dense swapped in by :func:`quantize_net` (reference:
    ``quantized_fully_connected`` and the requantize node the graph pass
    appends): the input quantized on its calibrated range, the int8
    product into int32, the output dequantized to float32 and the layer's
    activation on it. The int8 weight and bias are Gluon ``Constant``
    parameters (``qweight``, ``qbias``). Each swapped layer is an instance
    of a subclass made for it, closing over its ranges."""


class QuantizedConv2D(HybridBlock, _QuantizedLayerBase):
    """int8 Conv2D swapped in by :func:`quantize_net` (reference:
    ``quantized_conv`` + requantize), NCHW only, as the reference's
    quantized convolution; weights as in :class:`QuantizedDense`."""


def _quantized_layer(layer, in_range, kind):
    """The int8 twin of ``layer`` (``kind`` "dense" or "conv"), its
    constants on the layer's context (JAX counterpart:
    ``_make_quantized_dense``/``_make_quantized_conv``, ``:312-403``)."""
    w, b, ctx = _weights(layer)
    qw, wmin, wmax = _q8(w)
    qb, bmin, bmax = _q8(b) if b is not None else (None, 0.0, 0.0)
    act = layer.act
    if kind == "dense":
        units, flatten = layer._units, layer._flatten

        def product(qx, qweight, qbias, qlo, qhi):
            return Q.quantized_fully_connected(
                qx, qweight, qbias, qlo, qhi, wmin, wmax, bmin, bmax,
                num_hidden=units, no_bias=qbias is None, flatten=flatten)
        base = QuantizedDense
    else:
        kwargs = dict(layer._kwargs)

        def product(qx, qweight, qbias, qlo, qhi):
            return Q.quantized_conv(
                qx, qweight, qbias, qlo, qhi, wmin, wmax, bmin, bmax,
                stride=kwargs["stride"], pad=kwargs["pad"],
                dilate=kwargs["dilate"], num_filter=kwargs["num_filter"],
                no_bias=qbias is None, layout=kwargs["layout"])
        base = QuantizedConv2D

    class Layer(base):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.qweight = self.params.get_constant("qweight", qw)
            if qb is not None:
                self.qbias = self.params.get_constant("qbias", qb)
            self._range = in_range

        def hybrid_forward(self, F, x, qweight, qbias=None):
            lo, hi = self._range
            qx, qlo, qhi = Q.quantize(x, lo, hi, out_type="int8")
            acc, omin, omax = product(qx, qweight, qbias, qlo, qhi)
            out = Q.dequantize(acc, omin, omax)
            return act(out) if act is not None else out

    Layer.__name__ = Layer.__qualname__ = base.__name__
    qlayer = Layer(prefix=layer.prefix.rstrip("_") + "_int8_")
    qlayer.collect_params().initialize(ctx=ctx)
    return qlayer


# ---------------------------------------------------------------------------
# the pass + user API
# ---------------------------------------------------------------------------

def _quantizable(block) -> bool:
    return isinstance(block, (Dense, Conv2D))


def _iter_quantizable(block):
    for name, child in list(block._children.items()):
        if _quantizable(child):
            yield block, name, child
        else:
            yield from _iter_quantizable(child)


def _walk_blocks(b):
    yield b
    for c in b._children.values():
        yield from _walk_blocks(c)


class _eager_tree:
    """Switch ``hybridize()`` off across a block tree, so the forward runs
    eagerly and the forward pre-hooks see every layer's input (a cached
    op replays its CUDA graphs, which run no hook: calibration would see
    nothing); restores the blocks' state on exit (JAX counterpart:
    ``quantization/__init__.py:415``)."""

    def __init__(self, net):
        self._net = net
        self._saved = []

    def __enter__(self):
        for b in _walk_blocks(self._net):
            if isinstance(b, HybridBlock) and b._active:
                self._saved.append(b)
                b._active = False
        return self

    def __exit__(self, *exc):
        for b in self._saved:
            b._active = True
        return False


def _ranges_for_layers(site_ranges: Dict[str, Tuple[float, float]],
                       layer_names: Sequence[str]
                       ) -> Dict[str, Tuple[float, float]]:
    """Observer site names to layer names: an exact match, then
    ``act:<name>``, then a ``:<name>`` suffix, then a substring (JAX
    counterpart: ``quantization/__init__.py:439``)."""
    out = {}
    for name in layer_names:
        rng = site_ranges.get(name) or site_ranges.get("act:" + name)
        if rng is None:
            for site in sorted(site_ranges):
                if site.endswith(":" + name) or name in site:
                    rng = site_ranges[site]
                    break
        if rng is not None:
            out[name] = rng
    return out


def _host_array(t) -> onp.ndarray:
    """A layer input as a float numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.is_floating_point() and t.dtype != torch.float64:
            t = t.float()
        return t.cpu().numpy()
    return onp.asarray(t)


def _log2_counts(x, bins: int, lo_exp: int):
    """The magnitude histogram of :func:`observe_net`: bucket ``i`` counts
    the nonzero ``|x|`` with ``floor(log2|x|) - lo_exp == i`` (clipped
    into the buckets), and ``(min, max)``; computed where ``x`` lives.
    ``floor(log2|x|)`` is ``frexp``'s exponent less one, exactly the JAX
    package's ``floor(log2(float64(|x|)))`` for float32 values (which are
    never within a float64 rounding of a power of two unless equal to
    it)."""
    t = torch.as_tensor(x).detach().reshape(-1)
    if not t.is_floating_point() or t.dtype == torch.bfloat16 \
            or t.dtype == torch.float16:
        t = t.float()
    a = t.abs()
    _, e = torch.frexp(a)
    idx = (e.to(torch.int64) - 1 - lo_exp).clamp(0, bins - 1)
    idx = torch.where(a > 0, idx, torch.full_like(idx, bins))
    counts = torch.bincount(idx, minlength=bins + 1)[:bins]
    return (counts.double().cpu().numpy(), float(t.amin()),
            float(t.amax()))


def _calibrate(net, targets, calib_data, num_calib_batches, record) -> None:
    """Run ``net`` eagerly over ``calib_data`` (batches, or tuples of
    inputs) with a pre-hook on each target layer calling ``record(name,
    input)`` (a tensor, or what the layer was given)."""
    handles = []
    with _eager_tree(net), torch.no_grad():
        for _parent, _name, layer in targets:
            def pre_hook(blk, inputs, _lname=layer.name):
                x = inputs[0]
                record(_lname, x._data if isinstance(x, NDArray) else x)
            handles.append(layer.register_forward_pre_hook(pre_hook))
        try:
            n = 0
            for batch in calib_data:
                args = batch if isinstance(batch, (list, tuple)) \
                    else (batch,)
                net(*args)
                n += 1
                if num_calib_batches is not None \
                        and n >= num_calib_batches:
                    break
        finally:
            for h in handles:
                h.detach()


def observe_net(net, calib_data, num_calib_batches: Optional[int] = None,
                bins: int = 40, lo_exp: int = -24) -> Observer:
    """Run calibration batches eagerly and return an :class:`Observer`
    keyed by layer name: one log2-magnitude histogram of each quantizable
    layer's input (bucket ``i`` counts ``|x|`` in ``[2^(lo_exp+i),
    2^(lo_exp+i+1))``), counted on the input's device (JAX counterpart:
    ``quantization/__init__.py:463``, which counts in numpy)."""
    obs = Observer()

    def _record(name, x):
        counts, amin, amax = _log2_counts(x, bins, lo_exp)
        obs.update(name, counts, lo_exp, amin=amin, amax=amax)

    _calibrate(net, list(_iter_quantizable(net)), calib_data,
               num_calib_batches, _record)
    return obs


def quantize_net(net, calib_data=None, calib_mode: str = "naive",
                 quantized_dtype: str = "int8",
                 exclude_layers: Sequence[str] = (),
                 num_calib_batches: Optional[int] = None,
                 percentile: Optional[float] = None):
    """Quantize a Gluon network to int8 in place and return it (JAX
    counterpart: ``quantization/__init__.py:506``; reference
    ``quantize_net_v2``).

    ``calib_data``: an iterable of input batches (pre-hooks collect each
    layer's range: ``calib_mode='naive'`` min/max, ``'entropy'`` the
    KL-optimal threshold), an :class:`Observer`, or an Observer's
    ``to_table()`` dict (its percentile-clipped ranges, no forward).
    ``percentile`` applies to the Observer paths (default
    ``MXTPU_QUANT_PERCENTILE``, else 99.99). ``exclude_layers``: layer
    name substrings kept in float; a layer that saw no data stays float.
    """
    if quantized_dtype != "int8":
        raise MXNetError("the int8 path supports quantized_dtype='int8' "
                         "only (the JAX package's restriction)")
    if calib_data is None:
        raise MXNetError("quantize_net needs calib_data (reference requires "
                         "a calibration dataset for calib_mode != 'none')")

    targets = list(_iter_quantizable(net))

    observer = None
    if isinstance(calib_data, Observer):
        observer = calib_data
    elif isinstance(calib_data, dict) and calib_data and all(
            isinstance(v, dict) and "counts" in v
            for v in calib_data.values()):
        observer = Observer(calib_data)

    if observer is not None:
        ranges = _ranges_for_layers(
            observer.ranges(_quant_percentile(percentile)),
            [layer.name for _p, _n, layer in targets])
    else:
        collector = LayerRangeCollector(mode=calib_mode)
        _calibrate(net, targets, calib_data, num_calib_batches,
                   lambda name, x: collector.collect(name, _host_array(x)))
        ranges = collector.ranges()

    # swap: the child's slot in its parent takes the int8 twin (a torch
    # submodule, so attribute access finds the twin too)
    for parent, name, layer in targets:
        if any(tag in layer.name for tag in exclude_layers):
            continue
        if layer.name not in ranges:
            continue  # never saw data (dead branch): keep float
        kind = "dense" if isinstance(layer, Dense) else "conv"
        parent.register_child(_quantized_layer(layer, ranges[layer.name],
                                               kind), name)

    # drop captured graphs of the float layers
    for b in _walk_blocks(net):
        if isinstance(b, HybridBlock):
            b._clear_cached_op()
    return net


def quantize_model(model, observer, percentile: Optional[float] = None,
                   exclude_layers: Sequence[str] = ()):
    """Lower an :class:`Observer`'s ranges into a quantized serving twin of
    a ``serve.CompiledModel`` (JAX counterpart:
    ``quantization/__init__.py:617``).

    Returns a new ``CompiledModel`` over an int8 copy of the wrapped
    block, with the original's bucket table, input and output axes and
    pad values. The original is not touched: its block is deep-copied
    before the swap, so it keeps serving float, bitwise as before.
    ``observer``: an :class:`Observer` or its ``to_table()`` dict.
    """
    from ..serve.compiled import CompiledModel
    if not isinstance(model, CompiledModel):
        raise MXNetError("quantize_model takes a serve.CompiledModel "
                         f"(got {type(model).__name__}); use quantize_net "
                         "for a bare gluon block")
    if not (isinstance(observer, Observer)
            or (isinstance(observer, dict) and observer)):
        raise MXNetError("quantize_model needs an Observer (or its "
                         "to_table() dict): the calibration provenance of "
                         "its ranges")

    # deep-copy the block tree without what cannot or need not be copied:
    # the captured CUDA graphs of the cached ops (stale after the swap)
    block = model._block
    saved = []
    for b in _walk_blocks(block):
        if isinstance(b, HybridBlock):
            saved.append((b, b._cached_ops, b._cached_params))
            b._cached_ops, b._cached_params = {}, None
    try:
        twin = copy.deepcopy(block)
    finally:
        for b, ops, params in saved:
            b._cached_ops, b._cached_params = ops, params

    quantize_net(twin, calib_data=observer, percentile=percentile,
                 exclude_layers=exclude_layers)
    example_args = [onp.zeros(shape, dtype=dtype)
                    for shape, dtype in model._in_avals]
    return CompiledModel(twin, model._table, model._input_axes,
                         example_args=example_args,
                         output_axes=model._output_axes,
                         pad_values=list(model._pad_values))
