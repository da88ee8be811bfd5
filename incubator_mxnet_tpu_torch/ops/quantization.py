"""int8 quantization ops: quantize, dequantize, requantize and the
quantized compute ops.

Counterpart: the JAX package's ``ops/quantization.py`` (``:37-205``), the
reference INT8 subsystem's ops (``src/operator/quantization/``). Every
quantized tensor travels as ``(q, min_range, max_range)`` with the
symmetric signed int8 scheme, ``scale = max(|min|, |max|) / 127``, and the
float32 arithmetic is the JAX package's, in its order, so integer outputs
are equal and float outputs equal to the last bit:

- ``quantize`` is ``round(x / scale)`` (round half to even in both
  frameworks), then the clip;
- ``quantized_fully_connected`` returns the int32 accumulator with the
  bound ``sa * sw * (2**31 - 1)``, and ``dequantize`` divides that bound by
  the int32 span again (not ``acc * sa * sw``, which rounds otherwise);
- an int8 bias is re-encoded onto the accumulator's scale ``sa * sw``.

A range given as a Python or numpy number is computed on the host in numpy
float32 (the same IEEE operations), a range given as a tensor on the
tensor's device. A division by a scale divides by a tensor on the data's
device: CUDA would multiply by the reciprocal of a host scalar, one ulp off
a rounding edge.

The JAX package computes the int8 products in XLA
(``preferred_element_type=int32``), not in Pallas, so here they are a
library call: on the card ``torch._int_mm`` (cuBLASLt's int8 tensor-core
GEMM), which takes more than 16 rows and an inner and outer size that are
multiples of 8, so the operands are padded with zeros (exact in integers)
and the result sliced; on the CPU the plain version, an int32 ``@``. The
convolution is ``im2col`` by strided views followed by the same product,
and pooling reduces strided views in int32: torch has no int8 convolution
or pooling on CUDA. Both are exact, so the card and the CPU give the same
integers.
"""
from __future__ import annotations

from typing import Optional

import numpy as onp
import torch
import torch.nn.functional as F

#: the ops of the JAX registry, each also ``_contrib_<name>`` in ``mx.nd``
OPS = ("quantize", "quantize_v2", "dequantize", "requantize",
       "quantized_fully_connected", "quantized_conv", "quantized_pooling",
       "quantized_flatten", "quantized_act")
__all__ = list(OPS) + ["OPS", "int_matmul", "int_matmul_reference"]

_INT8_RANGE = 127.0
_UINT8_RANGE = 255.0
#: the int32 accumulator's span, as a float32 (2**31 - 1 rounds to 2**31)
_INT32_SPAN = float(2 ** 31 - 1)
_FLOOR = 1e-30

def _tensor(v, device) -> torch.Tensor:
    """A float32 scalar on ``device`` (a fill, no host copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _scalars(*vals) -> list:
    """float32 scalars: numpy ones when every value is a host number,
    else tensors on the device of the first tensor among them."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), None)
    if dev is None:
        return [onp.float32(v) for v in vals]
    return [_tensor(v, dev) for v in vals]


def _maximum(a, b):
    if isinstance(a, torch.Tensor):
        return torch.maximum(a, b)
    return onp.maximum(a, b)


def _symmetric_scale(min_range, max_range):
    """Real value of one int8 step (JAX counterpart:
    ``ops/quantization.py:37``; the reference's ``MaxAbs(min, max) /
    kInt8Range``)."""
    lo, hi, floor, span = _scalars(min_range, max_range, _FLOOR, _INT8_RANGE)
    return _maximum(_maximum(abs(lo), abs(hi)), floor) / span


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return onp.float32(v)


def quantize(data, min_range, max_range, out_type: str = "int8", **_):
    """float32 -> int8 (symmetric) or uint8 (affine over ``[min, max]``)
    with a given range; returns ``(q, min_range, max_range)`` (JAX
    counterpart: ``ops/quantization.py:45``)."""
    if out_type not in ("int8", "uint8"):
        raise ValueError(f"quantize: unsupported out_type {out_type!r}")
    min_range, max_range = _f32(min_range), _f32(max_range)
    x = data.to(torch.float32)
    if out_type == "int8":
        scale = _symmetric_scale(min_range, max_range)
        q = torch.round(x / _tensor(scale, x.device)).clamp(
            -_INT8_RANGE, _INT8_RANGE).to(torch.int8)
    else:
        lo, hi, floor, span = _scalars(min_range, max_range, _FLOOR,
                                       _UINT8_RANGE)
        scale = span / _maximum(hi - lo, floor)
        q = torch.round((x - _tensor(lo, x.device))
                        * _tensor(scale, x.device)).clamp(
            0, _UINT8_RANGE).to(torch.uint8)
    return q, min_range, max_range


def quantize_v2(data, min_calib_range: Optional[float] = None,
                max_calib_range: Optional[float] = None,
                out_type: str = "int8", **_):
    """:func:`quantize` with a calibrated range, or the data's own min and
    max when none is given (JAX counterpart: ``ops/quantization.py:69``)."""
    if min_calib_range is None or max_calib_range is None:
        min_calib_range = torch.amin(data).to(torch.float32)
        max_calib_range = torch.amax(data).to(torch.float32)
    return quantize(data, min_calib_range, max_calib_range,
                    out_type=out_type)


def dequantize(data, min_range, max_range, **_):
    """int8, uint8 or int32 -> float32 (JAX counterpart:
    ``ops/quantization.py:78``): the range is the real span of the dtype's
    full integer range (127 for int8, 2**31 - 1 for the accumulator)."""
    x = data.to(torch.float32)
    if data.dtype == torch.uint8:
        lo, hi, floor, span = _scalars(min_range, max_range, _FLOOR,
                                       _UINT8_RANGE)
        step = _maximum(hi - lo, floor) / span
        return x * _tensor(step, x.device) + _tensor(lo, x.device)
    span = _INT8_RANGE if data.dtype == torch.int8 else _INT32_SPAN
    lo, hi, floor, span = _scalars(min_range, max_range, _FLOOR, span)
    step = _maximum(_maximum(abs(lo), abs(hi)), floor) / span
    return x * _tensor(step, x.device)


def requantize(data, min_range, max_range,
               min_calib_range: Optional[float] = None,
               max_calib_range: Optional[float] = None, **_):
    """int32 accumulator -> int8 over a calibrated range, or the
    dequantized values' own min and max (JAX counterpart:
    ``ops/quantization.py:96``)."""
    real = dequantize(data, min_range, max_range)
    if min_calib_range is None or max_calib_range is None:
        min_calib_range = torch.amin(real)
        max_calib_range = torch.amax(real)
    return quantize(real, min_calib_range, max_calib_range, out_type="int8")


# -- the int8 x int8 -> int32 product -----------------------------------------
def int_matmul_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``a (m, k) @ w (n, k)^T`` in int32."""
    return a.to(torch.int32) @ w.to(torch.int32).t()


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * t.dim()
    pad[2 * (t.dim() - 1 - dim) + 1] = size - t.shape[dim]
    return F.pad(t, pad)


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (m, k) @ w (n, k)^T`` of int8 operands, exact in int32: on the
    card ``torch._int_mm`` over operands padded with zeros to its shape
    rules (rows > 16, inner and outer sizes multiples of 8), on the CPU
    :func:`int_matmul_reference`."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int_matmul takes int8 operands, got {a.dtype} and "
                        f"{w.dtype}")
    if a.device.type == "cpu":
        return int_matmul_reference(a, w)
    if a.device.type != "cuda":
        raise RuntimeError(f"int_matmul runs on cuda or cpu, not "
                           f"{a.device}")
    m, k = a.shape
    n = w.shape[0]
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    mp = m if m > 16 else 32
    a = _pad_to(_pad_to(a, 1, k8), 0, mp)
    w = _pad_to(_pad_to(w, 1, k8), 0, n8)
    out = torch._int_mm(a, w.t())
    if mp != m or n8 != n:
        out = out[:m, :n]
    return out


def _acc_scales(min_data, max_data, min_weight, max_weight):
    return (_symmetric_scale(min_data, max_data),
            _symmetric_scale(min_weight, max_weight))


def _bias32(bias, sa, sw, min_bias, max_bias):
    """The int8 bias re-encoded onto the accumulator's scale ``sa * sw``
    (JAX counterpart: ``ops/quantization.py:127-133``)."""
    sb, sa, sw = _scalars(_symmetric_scale(min_bias, max_bias), sa, sw)
    b = bias.to(torch.float32)
    return torch.round(b * _tensor(sb / (sa * sw), b.device)).to(
        torch.int32)


def _bound(sa, sw):
    """The accumulator's real range ``(-bound, bound)``, ``bound = sa * sw
    * (2**31 - 1)``."""
    sa, sw, span = _scalars(sa, sw, _INT32_SPAN)
    bound = sa * sw * span
    return -bound, bound


def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, num_hidden: int = 0,
                              no_bias: bool = False, flatten: bool = True,
                              **_):
    """int8 FC: ``data (N, ..., C) @ weight (num_hidden, C)^T`` into int32,
    plus the int8 ``bias`` on the accumulator's scale; returns ``(acc,
    -bound, bound)`` (JAX counterpart: ``ops/quantization.py:106``)."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    acc = int_matmul(data.reshape(-1, data.shape[-1]), weight).reshape(
        *lead, weight.shape[0])
    sa, sw = _acc_scales(min_data, max_data, min_weight, max_weight)
    if not no_bias and bias is not None:
        acc = acc + _bias32(bias, sa, sw, min_bias, max_bias)
    return (acc,) + _bound(sa, sw)


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _windows(x: torch.Tensor, kernel, stride, pad, dilate=(1, 1),
             value=0) -> torch.Tensor:
    """``(N, C, OH, OW, kh, kw)`` strided views of ``x (N, C, H, W)`` padded
    by ``pad`` with ``value`` (one copy, by the pad)."""
    kh, kw = kernel
    dh, dw = dilate
    if pad[0] or pad[1]:
        x = F.pad(x, (pad[1], pad[1], pad[0], pad[0]), value=value)
    eh, ew = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    win = x.unfold(2, eh, stride[0]).unfold(3, ew, stride[1])
    return win[..., ::dh, ::dw]


def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias=None, max_bias=None, kernel=None,
                   stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                   num_filter: int = 0, no_bias: bool = False,
                   layout: str = "NCHW", **_):
    """int8 convolution over NCHW data and OIHW weights into int32, with
    the accumulator's real range (JAX counterpart:
    ``ops/quantization.py:139``): ``im2col`` by strided views, then
    :func:`int_matmul`."""
    if layout != "NCHW":
        raise ValueError(f"quantized_conv takes NCHW data, not {layout!r}")
    O, C, kh, kw = weight.shape
    N = data.shape[0]
    win = _windows(data, (kh, kw), _pair(stride), _pair(pad), _pair(dilate))
    OH, OW = win.shape[2], win.shape[3]
    cols = win.permute(0, 2, 3, 1, 4, 5).reshape(N * OH * OW, C * kh * kw)
    acc = int_matmul(cols, weight.reshape(O, C * kh * kw))
    acc = acc.reshape(N, OH, OW, O).permute(0, 3, 1, 2).contiguous()
    sa, sw = _acc_scales(min_data, max_data, min_weight, max_weight)
    if not no_bias and bias is not None:
        acc = acc + _bias32(bias, sa, sw, min_bias, max_bias).reshape(
            1, -1, 1, 1)
    return (acc,) + _bound(sa, sw)


def quantized_pooling(data, min_data, max_data, kernel=(2, 2),
                      stride=None, pad=(0, 0), pool_type: str = "max", **_):
    """Max or average pooling of int8/uint8 values; the range passes
    through (JAX counterpart: ``ops/quantization.py:166``). Windows over
    the padding see the dtype's minimum (max) or 0 (avg, which divides by
    the whole window), as ``lax.reduce_window`` pads; reduced in int32."""
    kernel = _pair(kernel)
    stride = _pair(stride or kernel)
    pad = _pair(pad)
    info = torch.iinfo(data.dtype)
    if pool_type == "max":
        init = info.min if data.dtype == torch.int8 else 0
        win = _windows(data.to(torch.int32), kernel, stride, pad,
                       value=init)
        out = win.amax(dim=(-2, -1)).to(data.dtype)
        return out, min_data, max_data
    if pool_type == "avg":
        win = _windows(data.to(torch.int32), kernel, stride, pad)
        s = win.sum(dim=(-2, -1), dtype=torch.int32).to(torch.float32)
        n = _tensor(kernel[0] * kernel[1], s.device)
        out = torch.round(s / n).clamp(info.min, info.max).to(data.dtype)
        return out, min_data, max_data
    raise ValueError(f"quantized_pooling: unsupported pool_type "
                     f"{pool_type!r}")


def quantized_flatten(data, min_data, max_data, **_):
    """``(N, ...) -> (N, -1)`` (JAX counterpart:
    ``ops/quantization.py:193``)."""
    return data.reshape(data.shape[0], -1), min_data, max_data


def quantized_act(data, min_data, max_data, act_type: str = "relu", **_):
    """relu on int8: a clamp at the zero point, 0 (JAX counterpart:
    ``ops/quantization.py:198``); the range becomes ``(0, max)``."""
    if act_type != "relu":
        raise ValueError("only relu is supported on the int8 path "
                         "(reference restriction)")
    zero = (torch.zeros_like(_f32(min_data))
            if isinstance(min_data, torch.Tensor) else onp.float32(0.0))
    return torch.clamp_min(data, 0), zero, _f32(max_data)
