"""The neural-network ops, registered under MXNet's names.

Counterpart: the JAX package's ``ops/nn.py``: the layers' ops
(``FullyConnected``, ``Convolution``, ``Pooling``, ``BatchNorm``,
``LayerNorm`` ...), the other normalisations (``GroupNorm``,
``InstanceNorm``, ``L2Normalization``, ``RMSNorm``, ``LRN``), the softmax
family, the output heads (``SoftmaxOutput`` and the regression and SVM
outputs, each a ``torch.autograd.Function`` whose backward is the
reference's fused loss gradient, the incoming gradient ignored),
``UpSampling``, the bilinear resize, ``im2col``/``col2im`` (1-D and 2-D
windows), the fused ``RNN`` op and ``CTCLoss`` (both loops over time, as
the JAX package's ``lax.scan``). The registry (:mod:`.registry`) puts
them in ``mx.nd``; the layers call the plain functions (``fully_connected``,
``layer_norm`` ...) directly. JAX
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

from .registry import register_op

__all__ = ["fully_connected", "layer_norm", "gelu", "tanh", "activation",
           "ACTIVATIONS", "convolution", "deconvolution", "pooling",
           "batch_norm", "leaky_relu", "pad", "top_k", "softmax",
           "log_softmax", "rnn", "rnn_unpack_params", "rnn_param_size",
           "ctc_loss"]


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


@register_op("Activation", aliases=("activation",))
def activation(data, act_type="relu", **_):
    """Apply a named activation (JAX counterpart: ``ops/nn.py:396-418``,
    every name of its ``_ACTS``)."""
    try:
        fn = ACTIVATIONS[act_type]
    except KeyError:
        raise ValueError(f"activation {act_type!r} is not ported yet; "
                         f"known: {sorted(ACTIVATIONS)}") from None
    return fn(data)


_SELU = (1.6732632423543772, 1.0507009873554805)


@register_op("LeakyReLU", aliases=("leaky_relu",))
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **_):
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


@register_op("pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0, **_):
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


@register_op("Convolution", aliases=("convolution",))
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **_):
    """N-d convolution over NC(DHW) data with OI(DHW) weights, zero
    padding ``pad`` on both sides (JAX counterpart: ``ops/nn.py:90-122``)."""
    nd = data.dim() - 2
    zeros = (0,) * nd
    return _conv(data, weight, None if no_bias else bias, _tup(stride, nd),
                 _tup(pad if pad is not None else 0, nd), _tup(dilate, nd),
                 False, zeros, num_group)


@register_op("Deconvolution", aliases=("deconvolution",))
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=False, target_shape=None,
                  layout=None, **_):
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


@register_op("Pooling", aliases=("pooling",))
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None, **_):
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
@register_op("BatchNorm", aliases=("batch_norm",))
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, training=False, **_):
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


_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _total_order_key(x):
    """Integers ordered as ``x`` in XLA's total order of floats (that of
    ``lax.top_k``): -NaN < -inf < ... < -0.0 < +0.0 < ... < inf < NaN."""
    if not x.is_floating_point():
        return x
    b = x.view(_BITS[x.dtype])
    mask = torch.iinfo(b.dtype).max
    return torch.where(b < 0, b ^ mask, b)


def top_k(x, k, largest=True):
    """The ``k`` largest (``largest=False``: smallest) along the last axis
    in ``jax.lax.top_k``'s order: XLA's total order of floats (-0.0 below
    +0.0, NaN by its sign), equal keys to the lower index (``torch.topk``
    promises no order on ties): a stable sort of the order's keys.
    Returns ``(values, indices)``."""
    idx = torch.sort(_total_order_key(x), dim=-1, descending=largest,
                     stable=True).indices[..., :k]
    return torch.take_along_dim(x, idx, dim=-1), idx


# -- the rest of the JAX ops/nn.py, under the registry's names ---------------
@register_op("FullyConnected", aliases=("fully_connected",))
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True, **_):
    """``data @ weight.T + bias`` (JAX counterpart: ``ops/nn.py:48``)."""
    return fully_connected(data, weight, None if no_bias else bias,
                           flatten=flatten)


@register_op("LayerNorm", aliases=("layer_norm",))
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
              **_):
    """Layer normalisation over ``axis`` with float32 statistics; with
    ``output_mean_var`` also the mean and variance (JAX counterpart:
    ``ops/nn.py:331``)."""
    axis = axis % data.dim()
    if axis == data.dim() - 1 and not output_mean_var:
        return layer_norm(data, gamma, beta, eps=eps)
    x32 = data.float()
    m = x32.mean(dim=axis, keepdim=True)
    v = x32.var(dim=axis, unbiased=False, keepdim=True)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = ((x32 - m) * torch.rsqrt(v + eps)).to(data.dtype)
    out = out * gamma.reshape(shape) + beta.reshape(shape)
    if output_mean_var:
        return out, m.squeeze(axis), v.squeeze(axis)
    return out


@register_op("GroupNorm")
def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5, **_):
    """Normalisation over each group of ``num_groups`` channel groups and
    the spatial axes, in the input's dtype (JAX counterpart:
    ``ops/nn.py:347``)."""
    n, c = data.shape[0], data.shape[1]
    rest = tuple(data.shape[2:])
    x = data.reshape((n, num_groups, c // num_groups) + rest)
    axes = tuple(range(2, x.dim()))
    m = x.mean(dim=axes, keepdim=True)
    v = x.var(dim=axes, unbiased=False, keepdim=True)
    x = ((x - m) * torch.rsqrt(v + eps)).reshape(data.shape)
    shape = (1, c) + (1,) * len(rest)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register_op("InstanceNorm")
def InstanceNorm(data, gamma, beta, eps=1e-3, **_):
    """Normalisation over the spatial axes of each sample and channel
    (JAX counterpart: ``ops/nn.py:361``)."""
    axes = tuple(range(2, data.dim()))
    m = data.mean(dim=axes, keepdim=True)
    v = data.var(dim=axes, unbiased=False, keepdim=True)
    shape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return (data - m) * torch.rsqrt(v + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register_op("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance", **_):
    """``data`` over its L2 norm per sample (``instance``), per position
    across channels (``channel``) or per channel (``spatial``)."""
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, data.dim()))
    return data / torch.sqrt(data.square().sum(dim=axes, keepdim=True) + eps)


@register_op("RMSNorm", aliases=("rms_norm",))
def RMSNorm(data, gamma, axis=-1, eps=1e-6, **_):
    """``data`` over its root mean square along ``axis`` (float32
    statistics), times ``gamma`` (JAX counterpart: ``ops/nn.py:383``)."""
    x32 = data.float()
    v = x32.square().mean(dim=axis, keepdim=True)
    return (x32 * torch.rsqrt(v + eps)).to(data.dtype) * gamma


@register_op("LRN", aliases=("lrn",))
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **_):
    """Local response normalisation across channels of NCHW data:
    ``x * (knorm + alpha / nsize * sum of x^2 over the window)^-beta``
    (JAX counterpart: ``ops/nn.py:665``)."""
    half = nsize // 2
    sq = F.pad(data.float().square(),
               (0, 0) * (data.dim() - 2) + (half, nsize - 1 - half))
    local = sq.unfold(1, nsize, 1).sum(-1)
    norm = torch.pow(knorm + (alpha / nsize) * local, -beta)
    return (data.float() * norm).to(data.dtype)


@register_op("gelu_tanh")
def gelu_tanh(data, **_):
    return F.gelu(data, approximate="tanh")


@register_op("silu", aliases=("swish",))
def silu(data, **_):
    return data * torch.sigmoid(data)


# -- the softmax family ----------------------------------------------------------
def _length_mask(data, length, axis):
    steps = torch.arange(data.shape[axis], device=data.device)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    lshape = list(data.shape)
    lshape[axis] = 1
    return steps.reshape(shape) < length.reshape(lshape).to(torch.int32)


@register_op("softmax")
def softmax(data, length=None, axis=-1, temperature=None, use_length=False,
            dtype=None, **_):
    """Softmax over ``axis`` of ``data / temperature``; with
    ``use_length``, the positions at or past ``length`` along ``axis``
    are masked out and give 0 (JAX counterpart: ``ops/nn.py:478``)."""
    x = data / temperature if temperature not in (None, 1.0) else data
    if use_length and length is not None:
        mask = _length_mask(data, length, axis)
        out = torch.softmax(x.masked_fill(~mask, -math.inf), dim=axis)
        return out.masked_fill(~mask, 0.0)
    return torch.softmax(x, dim=axis)


@register_op("log_softmax")
def log_softmax(data, axis=-1, temperature=None, **_):
    x = data / temperature if temperature not in (None, 1.0) else data
    return torch.log_softmax(x, dim=axis)


@register_op("softmin")
def softmin(data, axis=-1, **_):
    return torch.softmax(-data, dim=axis)


@register_op("SoftmaxActivation")
def SoftmaxActivation(data, mode="instance", **_):
    """Softmax over all axes but the first (``instance``) or over axis 1
    at every position (``channel``)."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    flat = data.reshape(data.shape[0], -1)
    return torch.softmax(flat, dim=-1).reshape(data.shape)


@register_op("masked_softmax")
def masked_softmax(data, mask=None, axis=-1, temperature=1.0, **_):
    x = data / temperature
    if mask is None:
        return torch.softmax(x, dim=axis)
    keep = mask != 0
    out = torch.softmax(x.masked_fill(~keep, -math.inf), dim=axis)
    return out.masked_fill(~keep, 0.0)


def _one_hot_at(lab, k, axis, like):
    """``one_hot(lab, k)`` with the class axis at ``axis`` of ``like``; an
    out-of-range label gives zeros."""
    shape = [1] * like.dim()
    shape[axis] = k
    classes = torch.arange(k, device=lab.device).reshape(shape)
    return (lab.to(torch.int32).unsqueeze(axis) == classes).to(like.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward is the fused cross-entropy gradient
    ``(p - onehot(label)) * grad_scale``, which ignores the incoming
    gradient unless ``out_grad`` (JAX counterpart: ``_bwd`` of
    ``softmax_output``, ``ops/nn.py:546-562``)."""

    @staticmethod
    def forward(ctx, x, lab, conf):
        axis = conf["axis"]
        p = torch.softmax(x, dim=axis)
        ctx.save_for_backward(p, lab)
        ctx.conf = conf
        return p

    @staticmethod
    def backward(ctx, g):
        p, lab = ctx.saved_tensors
        c = ctx.conf
        axis = c["axis"] % p.dim()
        k = p.shape[axis]
        oh = _one_hot_at(lab, k, axis, p)
        if c["smooth_alpha"]:
            oh = oh * (1.0 - c["smooth_alpha"]) + c["smooth_alpha"] / k
        gx = p - oh
        if c["use_ignore"]:
            keep = lab != c["ignore_label"]
            gx = gx * keep.to(p.dtype).unsqueeze(axis)
            if c["normalization"] == "valid":
                gx = gx / keep.sum().clamp_min(1).to(p.dtype)
        if c["normalization"] == "batch":
            gx = gx / p.shape[0]
        if c["out_grad"]:
            gx = gx * g
        glab = torch.zeros_like(lab) if ctx.needs_input_grad[1] else None
        return gx * c["grad_scale"], glab, None


@register_op("SoftmaxOutput", aliases=("softmax_output",))
def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0,
                  **_):
    """Softmax whose gradient is the fused cross-entropy gradient against
    ``label`` (JAX counterpart: ``ops/nn.py:529``)."""
    conf = dict(axis=1 if multi_output else -1, grad_scale=grad_scale,
                ignore_label=ignore_label, use_ignore=use_ignore,
                normalization=normalization, out_grad=out_grad,
                smooth_alpha=smooth_alpha)
    return _SoftmaxOutput.apply(data, label, conf)


@register_op("softmax_cross_entropy")
def softmax_cross_entropy(data, label, **_):
    logp = torch.log_softmax(data, dim=-1)
    idx = label.to(torch.int32).to(torch.int64)[:, None]
    return -torch.gather(logp, -1, idx).sum()


@register_op("smooth_l1")
def smooth_l1(data, scalar=1.0, **_):
    """Huber-style smooth L1 with MXNet's ``scalar`` (JAX counterpart:
    ``ops/nn.py:576``)."""
    s2 = scalar * scalar
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * torch.square(data),
                       a - 0.5 / s2)


class _LossOutput(torch.autograd.Function):
    """An output head: ``fwd(x)`` forward; the backward is
    ``grad(pred, label)``, ignoring the incoming gradient (JAX
    counterpart: ``_loss_output``, ``ops/nn.py:582-601``)."""

    @staticmethod
    def forward(ctx, x, lab, fwd, grad):
        p = fwd(x)
        ctx.save_for_backward(p, lab)
        ctx.grad = grad
        return p

    @staticmethod
    def backward(ctx, g):
        p, lab = ctx.saved_tensors
        glab = torch.zeros_like(lab) if ctx.needs_input_grad[1] else None
        return ctx.grad(p, lab.to(p.dtype)), glab, None, None


def _per_example_outputs(label) -> float:
    """Outputs per example: the regression heads scale their gradient by
    ``grad_scale`` over it."""
    return float(max(math.prod(int(d) for d in label.shape[1:]), 1))


def _identity(x):
    return x


@register_op("LinearRegressionOutput", aliases=("linear_regression_output",))
def LinearRegressionOutput(data, label, grad_scale=1.0, **_):
    """Identity forward; gradient ``(pred - label) * grad_scale /
    outputs per example``."""
    s = grad_scale / _per_example_outputs(label)
    return _LossOutput.apply(data, label, _identity,
                             lambda p, lab: (p - lab) * s)


@register_op("LogisticRegressionOutput",
             aliases=("logistic_regression_output",))
def LogisticRegressionOutput(data, label, grad_scale=1.0, **_):
    """Sigmoid forward; gradient ``(sigmoid(x) - label) * grad_scale /
    outputs per example``."""
    s = grad_scale / _per_example_outputs(label)
    return _LossOutput.apply(data, label, torch.sigmoid,
                             lambda p, lab: (p - lab) * s)


@register_op("MAERegressionOutput", aliases=("mae_regression_output",))
def MAERegressionOutput(data, label, grad_scale=1.0, **_):
    """Identity forward; gradient ``sign(pred - label) * grad_scale /
    outputs per example``."""
    s = grad_scale / _per_example_outputs(label)
    return _LossOutput.apply(data, label, _identity,
                             lambda p, lab: torch.sign(p - lab) * s)


@register_op("SVMOutput", aliases=("svm_output",))
def SVMOutput(data, label, margin=1.0, regularization_coefficient=1.0,
              use_linear=False, **_):
    """Identity forward over class scores; the gradient is the one-vs-all
    hinge loss's, L2-SVM by default, L1-SVM with ``use_linear`` (JAX
    counterpart: ``ops/nn.py:644``)."""
    reg = regularization_coefficient

    def grad(p, lab):
        y = 2.0 * _one_hot_at(lab, p.shape[-1], p.dim() - 1, p) - 1.0
        viol = margin - y * p
        active = (viol > 0).to(p.dtype)
        if use_linear:
            return -reg * y * active
        return -2.0 * reg * y * viol * active

    return _LossOutput.apply(data, label, _identity, grad)


# -- resampling ------------------------------------------------------------------
def _resize_bilinear(data, size):
    """Bilinear resize with half-pixel centres; shrinking widens the
    kernel (antialiasing), as ``jax.image.resize(method="bilinear")``."""
    shrink = size[0] < data.shape[2] or size[1] < data.shape[3]
    return F.interpolate(data, size=size, mode="bilinear",
                         align_corners=False, antialias=shrink)


@register_op("UpSampling")
def UpSampling(data, scale=1, sample_type="nearest", num_args=1, **_):
    """NCHW data enlarged ``scale`` times: nearest (each pixel repeated) or
    bilinear (JAX counterpart: ``ops/nn.py:716``)."""
    n, c, h, w = data.shape
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    return _resize_bilinear(data, (h * scale, w * scale))


@register_op("contrib_BilinearResize2D", aliases=("bilinear_resize_2d",))
def BilinearResize2D(data, height=None, width=None, scale_height=None,
                     scale_width=None, **_):
    n, c, h, w = data.shape
    oh = height if height else int(h * scale_height)
    ow = width if width else int(w * scale_width)
    return _resize_bilinear(data, (oh, ow))


def _as_2d(data, kernel, stride, dilate, pad):
    nd = data.dim() - 2
    if nd not in (1, 2):
        raise ValueError(f"im2col/col2im take 1-D or 2-D windows here, got "
                         f"{nd}-D")
    conf = [_tup(kernel, nd), _tup(stride, nd), _tup(dilate, nd),
            _tup(pad if pad is not None else 0, nd)]
    if nd == 1:
        conf = [(1,) + v if i != 3 else (0,) + v for i, v in enumerate(conf)]
        data = data.unsqueeze(2)
    return data, conf


@register_op("im2col")
def im2col(data, kernel=None, stride=None, dilate=None, pad=None, **_):
    """Sliding-window patches ``(N, C * prod(kernel), windows)``,
    channel-major (JAX counterpart: ``ops/nn.py:125``)."""
    x, (k, s, d, p) = _as_2d(data, kernel, stride, dilate, pad)
    return F.unfold(x, k, dilation=d, padding=p, stride=s)


@register_op("col2im")
def col2im(data, output_size=None, kernel=None, stride=None, dilate=None,
           pad=None, **_):
    """The transpose of :func:`im2col`: patches summed back into an image
    of ``output_size`` (JAX counterpart: ``ops/nn.py:142``)."""
    output_size = tuple(output_size)
    n, ckk, _ = data.shape
    fake = torch.empty((n, 1) + output_size, device="meta")
    _, (k, s, d, p) = _as_2d(fake, kernel, stride, dilate, pad)
    size = output_size if len(output_size) == 2 else (1,) + output_size
    out = F.fold(data, size, k, dilation=d, padding=p, stride=s)
    return out.reshape(out.shape[:2] + output_size)


# -- the fused RNN op -------------------------------------------------------
def _gates(mode: str) -> int:
    return {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}[mode]


def rnn_unpack_params(params, mode, num_layers, input_size, hidden,
                      bidirectional):
    """Views of MXNet's flat fused-RNN parameter vector: in cuDNN's order,
    every ``Wx``, ``Wh`` per layer and direction, then every ``bx``,
    ``bh`` (JAX counterpart: ``ops/nn.py:766``). Returns ``(ws, bs)``."""
    ngates, dirs = _gates(mode), 2 if bidirectional else 1
    shapes = []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else hidden * dirs
        shapes += [(ngates * hidden, isz), (ngates * hidden, hidden)] * dirs
    ws, off = [], 0
    for rows, cols in shapes:
        ws.append(params[off:off + rows * cols].reshape(rows, cols))
        off += rows * cols
    bs = []
    for _ in range(2 * num_layers * dirs):
        bs.append(params[off:off + ngates * hidden])
        off += ngates * hidden
    return ws, bs


def rnn_param_size(mode, num_layers, input_size, hidden, bidirectional):
    """Length of the flat parameter vector (JAX counterpart:
    ``ops/nn.py:795``)."""
    ngates, dirs = _gates(mode), 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else hidden * dirs
        size += dirs * ngates * hidden * (isz + hidden + 2)
    return size


def _lstm_scan(gx, h, c, wh):
    """The LSTM recurrence over precomputed input gates ``gx (T, N, 4H)``
    (``x @ Wx.T + bx + bh``): per step one GEMM into the gates, then the
    cell (JAX counterpart: ``_lstm_cell``, ``ops/nn.py:735``)."""
    outs = []
    for t in range(gx.shape[0]):
        gates = torch.addmm(gx[t], h, wh.t())
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs), h, c


def _gru_scan(gx, h, wh, bh):
    """The GRU recurrence over ``gx = x @ Wx.T + bx`` (JAX counterpart:
    ``_gru_cell``, ``ops/nn.py:745``)."""
    outs = []
    for t in range(gx.shape[0]):
        xr, xz, xn = gx[t].chunk(3, dim=-1)
        hr, hz, hn = torch.addmm(bh, h, wh.t()).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs), h


def _rnn_scan(gx, h, wh, act):
    """The Elman recurrence over ``gx = x @ Wx.T + bx + bh``."""
    outs = []
    for t in range(gx.shape[0]):
        h = act(torch.addmm(gx[t], h, wh.t()))
        outs.append(h)
    return torch.stack(outs), h


@register_op("RNN")
def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, **_):
    """The fused multi-layer, optionally bidirectional RNN over time-major
    ``data (T, N, C)``; returns the output, or ``(out, h_n[, c_n])`` with
    ``state_outputs`` (JAX counterpart: ``ops/nn.py:817``).

    ``parameters`` is the flat cuDNN-ordered vector, or, as
    ``gluon.rnn``'s layers pass their weights without joining them, a
    list of ``(wx, wh, bx, bh)`` per layer and direction. Plain torch, as
    the JAX package leaves it to ``lax.scan``: a loop over T per layer and
    direction, each direction's input projection hoisted out of the loop
    as one GEMM over every step. As in the JAX package, ``p`` is taken and
    not applied, and ``projection_size``, the LSTM state clips and
    ``use_sequence_length`` are ignored. The loop reads nothing back to
    the host, so a CUDA graph can capture it."""
    T, N, C = data.shape
    hidden, dirs = state_size, 2 if bidirectional else 1
    if isinstance(parameters, torch.Tensor):
        ws, bs = rnn_unpack_params(parameters, mode, num_layers, C, hidden,
                                   bidirectional)
        parameters = [(ws[2 * k], ws[2 * k + 1], bs[2 * k], bs[2 * k + 1])
                      for k in range(num_layers * dirs)]
    act = torch.relu if mode == "rnn_relu" else torch.tanh
    x, h_states, c_states = data, [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            k = layer * dirs + d
            wx, wh, bx, bh = parameters[k]
            seq = x if d == 0 else torch.flip(x, (0,))
            if mode == "gru":
                gx = torch.matmul(seq, wx.t()) + bx
                out, hT = _gru_scan(gx, state[k], wh, bh)
            else:
                gx = torch.matmul(seq, wx.t()) + bx + bh
                if mode == "lstm":
                    out, hT, cT = _lstm_scan(gx, state[k], state_cell[k], wh)
                    c_states.append(cT)
                else:
                    out, hT = _rnn_scan(gx, state[k], wh, act)
            h_states.append(hT)
            outs.append(out if d == 0 else torch.flip(out, (0,)))
        x = torch.cat(outs, dim=-1) if dirs == 2 else outs[0]
    if not state_outputs:
        return x
    outs = [x, torch.stack(h_states)]
    if mode == "lstm":
        outs.append(torch.stack(c_states))
    return tuple(outs)


# -- CTC loss ---------------------------------------------------------------
_IMPOSSIBLE = -1e30


@register_op("CTCLoss", aliases=("ctc_loss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first", **_):
    """Connectionist temporal classification loss of time-major
    activations ``data (T, N, C)`` (before the softmax) and padded labels
    ``label (N, L)``; returns each example's loss ``(N,)`` (JAX
    counterpart: ``ops/nn.py:876``).

    The JAX package's log-space alpha recursion, vectorised over N and
    looped over T, with its conventions: "impossible" is ``-1e30`` (so an
    infeasible label gives a loss near 1e30, where
    ``torch.nn.functional.ctc_loss`` gives ``inf``); without label lengths
    ``blank_label="first"`` counts the labels ``> 0`` and ``"last"`` the
    labels ``>= 0``; padding of -1 is clamped to the blank."""
    T, N, C = data.shape
    logp = torch.log_softmax(data, dim=-1)
    blank = 0 if blank_label == "first" else C - 1
    L = label.shape[1]
    lab = label.to(torch.int64)
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.to(torch.int64)
    elif blank_label == "first":
        lab_len = (lab > 0).sum(dim=1)
    else:
        lab_len = (lab >= 0).sum(dim=1)
    lab = torch.where(lab >= 0, lab, blank)
    if use_data_lengths and data_lengths is not None:
        t_len = data_lengths.to(torch.int64)
    else:
        t_len = torch.full((N,), T, dtype=torch.int64, device=data.device)
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=data.device)
    ext[:, 1::2] = lab
    # log p of each extended label at every step: (T, N, S)
    lp = logp.gather(2, ext.unsqueeze(0).expand(T, N, S))
    imp = torch.full((N, 1), _IMPOSSIBLE, dtype=logp.dtype,
                     device=data.device)
    alpha = torch.cat([lp[0, :, :1],
                       torch.where(lab_len[:, None] > 0, lp[0, :, 1:2], imp),
                       imp.expand(N, S - 2)], dim=1)
    allow_skip = torch.zeros((N, S), dtype=torch.bool, device=data.device)
    allow_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    for t in range(1, T):
        a1 = torch.cat([imp, alpha[:, :-1]], dim=1)
        a2 = torch.cat([imp, imp, alpha[:, :-2]], dim=1)
        a2 = torch.where(allow_skip, a2, imp)
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + lp[t]
        alpha = torch.where((t < t_len)[:, None], new, alpha)
    end = 2 * lab_len
    p1 = alpha.gather(1, end[:, None])[:, 0]
    p2 = alpha.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    p2 = torch.where(end - 1 >= 0, p2, imp[:, 0])
    return -torch.logaddexp(p1, p2)
