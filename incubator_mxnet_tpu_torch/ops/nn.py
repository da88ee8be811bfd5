"""The neural-network ops of the BERT and vision paths.

Counterpart: the JAX package's ``ops/nn.py`` and ``ops/tensor.py``. JAX
promotes mixed dtypes where PyTorch's matmul refuses them, so the casts JAX
makes implicitly are written out here. In a "bfloat16" BERT the LayerNorm
parameters stay float32, the normalised value times ``gamma`` promotes to
float32, and every later Dense computes float32 x bfloat16 -> float32.

The JAX package computes convolution, pooling and BatchNorm in XLA, not in
Pallas, so here they are torch calls (cuDNN on the card), held to the
reference's numbers where torch's defaults differ:

- float32 convolutions run without TF32 (PyTorch lets cuDNN use it by
  default), forward and backward: :class:`_Convolution` sets cuDNN's fp32
  precision to IEEE around its own calls only;
- ``pooling`` pads explicitly (``-inf`` for max, zeros for the sums) for
  the three output conventions, since torch's ``ceil_mode`` is another
  rule than MXNet's ``"full"``;
- ``batch_norm`` normalises in float32 and returns the batch mean and the
  *biased* batch variance; the caller writes the running statistics (torch
  would update them with the unbiased variance and the other momentum).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "layer_norm", "gelu", "tanh", "activation",
           "embedding", "ACTIVATIONS", "convolution", "deconvolution",
           "pooling", "batch_norm", "flatten", "leaky_relu", "pad", "top_k"]


def fully_connected(data, weight, bias=None, flatten=True):
    """``y = x @ W.T + b`` with ``weight (units, in_units)``; both operands
    promote to the wider dtype as in JAX (JAX counterpart:
    ``ops/nn.py:48``)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = F.linear(x.to(dt), weight.to(dt))
    if bias is not None:
        out = out + bias
    return out


def layer_norm(data, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis with float32 statistics; the normalised
    value is cast back to the input dtype *before* the affine, so float32
    ``gamma``/``beta`` promote a bfloat16 input to float32 (JAX
    counterpart: ``ops/nn.py:331``)."""
    x32 = data.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = ((x32 - m) * torch.rsqrt(v + eps)).to(data.dtype)
    return out * gamma + beta


def gelu(x):
    """Exact (erf) GELU (JAX counterpart: ``ops/nn.py:404``,
    ``jax.nn.gelu(approximate=False)``)."""
    return F.gelu(x, approximate="none")


def tanh(x):
    """Hyperbolic tangent (JAX counterpart: ``ops/nn.py:399``)."""
    return torch.tanh(x)


ACTIVATIONS = {"gelu": gelu, "tanh": tanh, "relu": torch.relu,
               "sigmoid": torch.sigmoid, "softrelu": F.softplus,
               "softsign": F.softsign,
               "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
               "silu": F.silu, "swish": F.silu,
               "mish": lambda x: x * torch.tanh(F.softplus(x))}


def activation(data, act_type):
    """Apply a named activation (JAX counterpart: ``ops/nn.py:396-418``,
    every name of its ``_ACTS``)."""
    try:
        fn = ACTIVATIONS[act_type]
    except KeyError:
        raise ValueError(f"activation {act_type!r} is not ported yet; "
                         f"known: {sorted(ACTIVATIONS)}") from None
    return fn(data)


def embedding(data, weight):
    """Row lookup with indices clipped to ``[0, rows)`` (JAX counterpart:
    ``ops/tensor.py:854``)."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


_SELU = (1.6732632423543772, 1.0507009873554805)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """The leaky family (JAX counterpart: ``ops/nn.py:421-454``): ``prelu``
    takes a per-channel ``gamma`` on axis 1; ``rrelu`` is deterministic at
    the mean slope, as in the reference."""
    neg = data < 0
    if act_type == "leaky":
        return torch.where(neg, slope * data, data)
    if act_type == "prelu":
        g = gamma
        if g.dim() < data.dim():
            shape = [1] * data.dim()
            if data.dim() > 1:
                shape[1] = g.numel()
            g = g.reshape(shape)
        return torch.where(neg, g * data, data)
    if act_type == "elu":
        return torch.where(neg, slope * torch.expm1(data), data)
    if act_type == "selu":
        alpha, scale = _SELU
        return scale * torch.where(neg, alpha * torch.expm1(data), data)
    if act_type == "gelu":
        return gelu(data)
    if act_type == "rrelu":
        return torch.where(neg, (lower_bound + upper_bound) / 2.0 * data,
                           data)
    raise ValueError(f"unknown act_type {act_type}")


def flatten(data):
    """All axes but the first collapsed (JAX counterpart: ``flatten``)."""
    return data.reshape(data.shape[0], -1)


def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """MXNet's ``pad``: ``pad_width`` holds (before, after) per axis, from
    the first axis (JAX counterpart: ``ops/tensor.py:507``). ``edge`` and
    ``reflect`` pad the spatial axes only, as in MXNet."""
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    if mode != "constant" and any(v for pr in pairs[:2] for v in pr):
        raise ValueError(f"pad mode {mode!r} pads the spatial axes only; "
                         f"got pad_width {tuple(pad_width)}")
    first = 0 if mode == "constant" else 2
    # torch lists the last axis first
    flat = [v for lo_hi in reversed(pairs[first:]) for v in lo_hi]
    if mode == "constant":
        return F.pad(data, flat, value=constant_value)
    return F.pad(data, flat, mode={"edge": "replicate",
                                   "reflect": "reflect"}[mode])


# -- convolution -----------------------------------------------------------
def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


@contextlib.contextmanager
def _ieee_fp32():
    """cuDNN's float32 convolutions in IEEE float32, not TF32, for the
    calls inside (torch's default lets cuDNN use TF32)."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


class _Convolution(torch.autograd.Function):
    """``aten::convolution`` whose forward and backward both run inside
    :func:`_ieee_fp32`: the backward runs later than the forward, outside
    any scope the caller could set around the op."""

    @staticmethod
    def forward(ctx, x, w, b, conf):
        with _ieee_fp32():
            out = torch.convolution(x, w, b, *conf)
        ctx.save_for_backward(x, w)
        ctx.conf, ctx.bias = conf, None if b is None else list(b.shape)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        with _ieee_fp32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, w, ctx.bias, *ctx.conf,
                [need[0], need[1], bool(need[2]) and ctx.bias is not None])
        return gx, gw, gb, None


def _conv(data, weight, bias, stride, padding, dilation, transposed,
          output_padding, groups):
    dt = torch.promote_types(data.dtype, weight.dtype)
    b = None if bias is None else bias.to(dt)
    conf = (list(stride), list(padding), list(dilation), transposed,
            list(output_padding), groups)
    return _Convolution.apply(data.to(dt), weight.to(dt), b, conf)


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None):
    """N-d convolution over NC(DHW) data with OI(DHW) weights, zero
    padding ``pad`` on both sides (JAX counterpart: ``ops/nn.py:90-122``)."""
    nd = data.dim() - 2
    zeros = (0,) * nd
    return _conv(data, weight, None if no_bias else bias, _tup(stride, nd),
                 _tup(pad if pad is not None else 0, nd), _tup(dilate, nd),
                 False, zeros, num_group)


def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=False, target_shape=None,
                  layout=None):
    """Transposed convolution, weights (in, out/groups, *k), the output
    ``(in - 1) * stride - 2 * pad + k + adj`` long (JAX counterpart:
    ``ops/nn.py:179-216``). As there, ``dilate`` is not applied."""
    nd = data.dim() - 2
    return _conv(data, weight, None if no_bias else bias, _tup(stride, nd),
                 _tup(pad if pad is not None else 0, nd), (1,) * nd, True,
                 _tup(adj if adj is not None else 0, nd), num_group)


# -- pooling ---------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_padding(shape, kernel, stride, pad, convention):
    """(low, high) padding per spatial axis under MXNet's convention
    (JAX counterpart: ``ops/nn.py:244-264``): ``valid`` pads ``pad`` on
    both sides and drops a partial last window; ``full`` adds right
    padding so that the last window fits; ``same`` gives
    ``ceil(in / stride)`` outputs, the needed padding split low/high."""
    pads = []
    for i, (k, s, p) in enumerate(zip(kernel, stride, pad)):
        size = shape[i] + 2 * p
        if convention == "full":
            rem = (size - k) % s
            pads.append((p, p + (0 if rem == 0 else s - rem)))
        elif convention == "same":
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads.append((p + total // 2, p + total - total // 2))
        else:
            pads.append((p, p))
    return pads


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None):
    """Max, average, sum or L2 pooling over NC(DHW) data (JAX counterpart:
    ``ops/nn.py:230-290``): max pads with ``-inf``; ``avg`` divides by the
    window size (``count_include_pad=True``) or by the real cells under
    it; ``global_pool`` is the max or mean over every spatial axis."""
    nd = data.dim() - 2
    if global_pool:
        axes = tuple(range(2, 2 + nd))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    kernel = _tup(kernel, nd)
    stride = _tup(stride, nd)
    pads = _pool_padding(data.shape[2:], kernel, stride,
                         _tup(pad if pad is not None else 0, nd),
                         pooling_convention)
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    if pool_type == "max":
        x = F.pad(data, flat, value=-math.inf) if any(flat) else data
        return _MAX_POOL[nd](x, kernel, stride)
    if pool_type == "lp":
        x = F.pad(data.abs().square(), flat) if any(flat) \
            else data.abs().square()
        return (_AVG_POOL[nd](x, kernel, stride) * math.prod(kernel)).sqrt()
    if pool_type not in ("avg", "sum"):
        raise ValueError(f"unknown pool_type {pool_type}")
    x = F.pad(data, flat) if any(flat) else data
    mean = _AVG_POOL[nd](x, kernel, stride)
    if pool_type == "sum":
        return mean * math.prod(kernel)
    if count_include_pad or not any(flat):
        return mean
    ones = F.pad(torch.ones((1, 1) + tuple(data.shape[2:]),
                            dtype=data.dtype, device=data.device), flat)
    return mean / _AVG_POOL[nd](ones, kernel, stride)


# -- BatchNorm -------------------------------------------------------------
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, training=False):
    """``(out, mean, var)`` (JAX counterpart: ``ops/nn.py:300-328``): the
    output normalised in float32 (float64 data: in float64) and cast back
    to ``data``'s dtype, by the
    batch statistics in training (``var`` biased), else by the moving
    ones, which come back as ``mean``/``var``. ``momentum`` is unused
    here: the caller updates the moving statistics (torch's
    ``F.batch_norm`` would use the unbiased variance). ``fix_gamma``
    scales by 1."""
    x = data.movedim(axis, 1) if axis not in (1, 1 - data.dim()) else data
    acc = torch.promote_types(data.dtype, torch.float32)
    g = torch.ones_like(gamma, dtype=acc) if fix_gamma else gamma.to(acc)
    b = beta.to(acc)
    if training and not use_global_stats:
        out, mean, invstd = torch.native_batch_norm(x, g, b, None, None,
                                                    True, 0.0, eps)
        var = (invstd.detach().pow(-2) - eps).clamp_min(0.0)
        mean = mean.detach()
    else:
        mean, var = moving_mean.to(acc), moving_var.to(acc)
        out, _, _ = torch.native_batch_norm(x, g, b, mean, var, False, 0.0,
                                            eps)
    if x is not data:
        out = out.movedim(1, axis)
    return out, mean, var


def top_k(x, k):
    """The ``k`` largest along the last axis, ties to the lower index, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order on
    ties): a stable descending sort. Returns ``(values, indices)``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
