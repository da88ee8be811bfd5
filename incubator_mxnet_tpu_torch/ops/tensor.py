"""Tensor ops: elementwise, broadcast, reductions, matmul, shapes, indexing,
sorting, sequences and linear algebra, registered under MXNet's names.

Counterpart: the JAX package's ``ops/tensor.py``. Every op is a function
on tensors, registered in :mod:`.registry` with the reference's name and
aliases, and ``mx.nd`` reflects it. The JAX package runs without x64, so
its results are float32 and int32 where torch's defaults would be
float64 or int64; the ops here give the reference's dtypes:

- ``sum``, ``prod``, ``nansum`` and ``trace`` of a signed integer or bool
  input are int32, of an unsigned input uint32; ``mean`` of an integer
  input is float32 (``:198-240``);
- ``argmax``/``argmin`` are float32, and so are the indices of
  ``argsort``/``topk`` unless ``dtype=`` says otherwise (``:254-267``,
  ``:613-651``);
- ``cast`` and :meth:`NDArray.astype` saturate a float going to an
  integer type, NaN giving 0 (XLA's conversion; ``torch.Tensor.to``
  wraps) (:func:`cast_saturating`);
- index outputs (``shape_array``, ``index_array``, ``bincount``) are
  int32.

Ties order as in the reference: ``sort``/``argsort`` descending flip a
stable ascending sort (equal keys highest index first), ``topk`` takes
the lowest index first in either direction (``lax.top_k``). ``mod`` is the
floor modulus and ``round`` rounds half to even. ``boolean_mask`` and
``bincount`` have output shapes that depend on the data: they read it on
the host, and inside a CUDA-graph capture (a hybridized block, the fused
step) they raise an error that names the op.
"""
from __future__ import annotations

import builtins
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .nn import top_k
from .registry import register_op

_INT_SUM = {torch.uint8: torch.uint32, torch.uint16: torch.uint32,
            torch.uint32: torch.uint32}


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        return (axis % ndim if ndim else axis,)
    return tuple(a % ndim for a in axis)


def _fp(x):
    """``x`` as a float tensor (integers and bools to float32), for the
    functions JAX defines on floats only."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _t(v, like):
    """A scalar operand as a 0-d tensor on ``like``'s device (a 0-d
    tensor promotes like JAX's weakly typed Python scalars)."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, device=like.device)


def _no_capture(name, t):
    """Refuse an op whose output shape depends on the data inside a CUDA
    graph capture: reading the data there would need a sync."""
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            f"{name} has an output shape that depends on the data and "
            "cannot run inside a CUDA graph capture (a hybridized block "
            "or the fused step); use where()/SequenceMask or filter "
            "before the captured call")


def _sum_dtype(dt):
    """The dtype of ``jnp.sum`` of ``dt`` without x64."""
    if dt == torch.bool or (not dt.is_floating_point
                            and dt not in _INT_SUM and dt != torch.int64):
        return torch.int32
    return _INT_SUM.get(dt, dt)


def cast_saturating(x, dtype):
    """``x`` as ``dtype``; a float going to an integer type saturates at
    the type's range and NaN gives 0, as XLA's conversion does."""
    dt = torch_dtype(dtype)
    if not x.is_floating_point() or dt.is_floating_point or dt == torch.bool:
        return x.to(dt)
    info = torch.iinfo(dt)
    # float64 holds every bound but int64's exactly
    wide = x.to(torch.float64).nan_to_num(0.0, float(info.max),
                                          float(info.min))
    out = wide.clamp(info.min, info.max).to(dt)
    if dt == torch.int64:
        out = torch.where(wide >= 2.0 ** 63, info.max, out)
    return out


# -- unary elementwise -------------------------------------------------------
def _unary(name, f, aliases=()):
    def op(data, **_):
        return f(data)
    op.__name__ = op.__qualname__ = name
    register_op(name, aliases=aliases)(op)
    return op


def _keep_int(f):
    """``f`` on floats; integers and bools pass through (JAX's rounding
    functions return an integer input as it is)."""
    return lambda x: f(x) if x.is_floating_point() else x


def _cbrt(x):
    x = _fp(x)
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


_unary("negative", torch.neg)
_unary("abs", torch.abs)
_unary("sign", lambda x: torch.where(torch.isnan(x), x, torch.sign(x))
       if x.is_floating_point() else torch.sign(x))
_unary("ceil", _keep_int(torch.ceil))
_unary("floor", _keep_int(torch.floor))
_unary("round", _keep_int(torch.round))
_unary("rint", _keep_int(torch.round))
_unary("trunc", _keep_int(torch.trunc))
_unary("fix", _keep_int(torch.trunc))
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("expm1", torch.expm1)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", lambda x: torch.rad2deg(_fp(x)))
_unary("radians", lambda x: torch.deg2rad(_fp(x)))
_unary("reciprocal", lambda x: 1.0 / x)
_unary("erf", lambda x: torch.special.erf(_fp(x)))
_unary("erfinv", lambda x: torch.special.erfinv(_fp(x)))
_unary("gamma", lambda x: torch.exp(torch.lgamma(_fp(x))))
_unary("gammaln", lambda x: torch.lgamma(_fp(x)))
_unary("logical_not", lambda x: (x == 0).to(x.dtype))
_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", lambda x: x / (1 + x.abs()))
_unary("softrelu", lambda x: torch.logaddexp(x, torch.zeros_like(x)),
       aliases=("softplus",))
_unary("hard_sigmoid", lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0))
_unary("identity", torch.clone,
       aliases=("copy", "stop_gradient_identity", "BlockGrad_"))


@register_op("BlockGrad", aliases=("stop_gradient",))
def block_grad(data, **_):
    """The input, cut from the autograd graph (``lax.stop_gradient``)."""
    return data.detach()


@register_op("make_loss")
def make_loss(data, grad_scale=1.0, **_):
    """Identity; the registry ends up with ``ops/vision.py``'s
    ``MakeLoss`` under this name, as the JAX registry does."""
    return data


@register_op("cast", aliases=("Cast",))
def cast(data, dtype="float32", **_):
    return cast_saturating(data, dtype)


@register_op("clip")
def clip(data, a_min=None, a_max=None, **_):
    return torch.clamp(data, a_min, a_max)


@register_op("isnan")
def isnan(data, **_):
    return torch.isnan(data)


@register_op("isinf")
def isinf(data, **_):
    return torch.isinf(data)


@register_op("isfinite")
def isfinite(data, **_):
    return torch.isfinite(data)


# -- binary broadcast ----------------------------------------------------------
def _binary(name, f, aliases=()):
    def op(lhs, rhs, **_):
        like = lhs if isinstance(lhs, torch.Tensor) else rhs
        return f(_t(lhs, like), _t(rhs, like))
    op.__name__ = op.__qualname__ = name
    register_op(name, aliases=aliases)(op)
    return op


def _fp2(f):
    def g(a, b):
        if not (a.is_floating_point() or b.is_floating_point()):
            a, b = a.to(torch.float32), b.to(torch.float32)
        return f(a, b)
    return g


_binary("add", torch.add, aliases=("broadcast_add", "broadcast_plus",
                                   "elemwise_add", "__add__"))
_binary("subtract", torch.sub, aliases=("broadcast_sub", "broadcast_minus",
                                        "elemwise_sub"))
_binary("multiply", torch.mul, aliases=("broadcast_mul", "elemwise_mul"))
_binary("divide", torch.true_divide, aliases=("broadcast_div",
                                              "elemwise_div"))
_binary("floor_divide", torch.floor_divide)
_binary("mod", torch.remainder, aliases=("broadcast_mod",))
_binary("power", torch.pow, aliases=("broadcast_power", "pow"))
_binary("maximum", torch.maximum, aliases=("broadcast_maximum",))
_binary("minimum", torch.minimum, aliases=("broadcast_minimum",))
_binary("hypot", _fp2(torch.hypot), aliases=("broadcast_hypot",))
_binary("arctan2", _fp2(torch.atan2))


def _cmp(name, f, aliases=()):
    """A comparison as 0/1 in the operands' promoted dtype, float32 for
    two booleans (JAX counterpart: ``_cmp``, ``:159``)."""
    def op(lhs, rhs, **_):
        like = lhs if isinstance(lhs, torch.Tensor) else rhs
        a, b = _t(lhs, like), _t(rhs, like)
        dt = torch.result_type(a, b)
        if dt == torch.bool:
            dt = torch.float32
        return f(a, b).to(dt)
    op.__name__ = op.__qualname__ = name
    register_op(name, aliases=aliases)(op)
    return op


_cmp("equal", torch.eq, aliases=("broadcast_equal",))
_cmp("not_equal", torch.ne, aliases=("broadcast_not_equal",))
_cmp("greater", torch.gt, aliases=("broadcast_greater",))
_cmp("greater_equal", torch.ge, aliases=("broadcast_greater_equal",))
_cmp("lesser", torch.lt, aliases=("broadcast_lesser", "less"))
_cmp("lesser_equal", torch.le, aliases=("broadcast_lesser_equal",
                                        "less_equal"))
_cmp("logical_and", lambda a, b: (a != 0) & (b != 0),
     aliases=("broadcast_logical_and",))
_cmp("logical_or", lambda a, b: (a != 0) | (b != 0),
     aliases=("broadcast_logical_or",))
_cmp("logical_xor", lambda a, b: (a != 0) ^ (b != 0),
     aliases=("broadcast_logical_xor",))


@register_op("add_n", aliases=("ElementWiseSum", "sum_n"))
def add_n(*args, **_):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register_op("where")
def where(condition, x, y, **_):
    cond = condition if condition.dtype == torch.bool else condition != 0
    return torch.where(cond, x, _t(y, x))


# -- reductions ----------------------------------------------------------------
def _excl(axis, exclude, ndim):
    if not exclude:
        return axis
    ax = set(_axes(axis, ndim))
    return tuple(i for i in range(ndim) if i not in ax)


def _reduce(x, axis, keepdims, fn, out_dtype):
    """``fn(x, dim, keepdim)`` over ``axis`` (None: all; ``()``: none,
    as in numpy) computed in ``out_dtype`` (integers in int64 first)."""
    if axis == () or axis == []:
        return x.to(out_dtype)
    dims = _axes(axis, x.dim())
    if not out_dtype.is_floating_point:
        x = x.to(torch.int64)
    elif x.dtype != out_dtype and x.is_floating_point():
        x = x.to(out_dtype)
    out = fn(x, dims, keepdims) if x.dim() else x
    return out.to(out_dtype)


@register_op("sum", aliases=("sum_axis",))
def sum(data, axis=None, keepdims=False, exclude=False, **_):  # noqa: A001
    return _reduce(data, _excl(axis, exclude, data.dim()), keepdims,
                   lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
                   _sum_dtype(data.dtype))


@register_op("nansum")
def nansum(data, axis=None, keepdims=False, **_):
    return _reduce(data, axis, keepdims,
                   lambda x, d, k: torch.nansum(x, dim=d, keepdim=k),
                   _sum_dtype(data.dtype))


@register_op("mean")
def mean(data, axis=None, keepdims=False, exclude=False, **_):
    dt = data.dtype if data.is_floating_point() else torch.float32
    return _reduce(_fp(data), _excl(axis, exclude, data.dim()), keepdims,
                   lambda x, d, k: torch.mean(x, dim=d, keepdim=k), dt)


def _prod(x, dims, keepdims, fn=torch.prod):
    for d in sorted(dims, reverse=True):
        x = fn(x, dim=d, keepdim=keepdims)
    return x


@register_op("prod")
def prod(data, axis=None, keepdims=False, **_):
    return _reduce(data, axis, keepdims, _prod, _sum_dtype(data.dtype))


@register_op("nanprod")
def nanprod(data, axis=None, keepdims=False, **_):
    x = torch.where(torch.isnan(data), 1, data) if data.is_floating_point() \
        else data
    return _reduce(x, axis, keepdims, _prod, _sum_dtype(data.dtype))


@register_op("max", aliases=("max_axis",))
def max(data, axis=None, keepdims=False, **_):  # noqa: A001
    return _reduce(data, axis, keepdims,
                   lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
                   data.dtype)


@register_op("min", aliases=("min_axis",))
def min(data, axis=None, keepdims=False, **_):  # noqa: A001
    return _reduce(data, axis, keepdims,
                   lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
                   data.dtype)


@register_op("norm")
def norm(data, ord=2, axis=None, keepdims=False, **_):
    if ord == 1:
        return sum(torch.abs(data), axis=axis, keepdims=keepdims)
    return torch.sqrt(_fp(sum(torch.square(data), axis=axis,
                              keepdims=keepdims)))


@register_op("logsumexp")
def logsumexp(data, axis=None, keepdims=False, **_):
    return torch.logsumexp(_fp(data), dim=_axes(axis, data.dim()),
                           keepdim=keepdims)


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1), dim=0)
        return (out.reshape((1,) * data.dim()) if keepdims
                else out).to(torch.float32)
    return fn(data, dim=axis, keepdim=keepdims).to(torch.float32)


@register_op("argmax")
def argmax(data, axis=None, keepdims=False, **_):
    """Index of the largest (first of ties; NaN counts as largest), as
    float32."""
    return _arg(torch.argmax, data, axis, keepdims)


@register_op("argmin")
def argmin(data, axis=None, keepdims=False, **_):
    return _arg(torch.argmin, data, axis, keepdims)


@register_op("argmax_channel")
def argmax_channel(data, **_):
    return torch.argmax(data, dim=1).to(torch.float32)


# -- matmul family ---------------------------------------------------------------
def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


@register_op("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False, **_):
    """MXNet's dot: ``lhs``'s last axis against ``rhs``'s first;
    ``transpose_a``/``transpose_b`` contract ``lhs``'s first and ``rhs``'s
    last axis instead."""
    lhs, rhs = _promoted(lhs, rhs)
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs)
    la = 0 if transpose_a else lhs.dim() - 1
    ra = rhs.dim() - 1 if transpose_b else 0
    return torch.tensordot(lhs, rhs, dims=([la], [ra]))


@register_op("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **_):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(*_promoted(a, b))


@register_op("matmul")
def matmul(a, b, **_):
    return torch.matmul(*_promoted(a, b))


@register_op("khatri_rao")
def khatri_rao(*args, **_):
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            -1, out.shape[-1])
    return out


# -- shapes ----------------------------------------------------------------------
def mx_reshape_shape(ishape, shape):
    """MXNet's reshape codes (JAX counterpart: ``_mx_reshape_shape``,
    ``:311-342``): 0 copies an axis, -1 infers one, -2 copies the rest,
    -3 merges two axes, -4 splits one into the next two entries (one of
    them may be -1)."""
    out, i, j = [], 0, 0
    shape = list(shape)
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(ishape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(ishape[i:])
            i = len(ishape)
        elif s == -3:
            out.append(ishape[i] * ishape[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[j + 1], shape[j + 2]
            j += 2
            cur = ishape[i]
            i += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
        else:
            out.append(s)
            i += 1
        j += 1
    if out.count(-1) > 1:
        raise ValueError("reshape can infer at most one dimension")
    return tuple(out)


@register_op("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False, **_):
    """``shape`` with MXNet's codes (:func:`mx_reshape_shape`).
    ``reverse`` is taken and not applied, as in the JAX package."""
    if isinstance(shape, int):
        shape = (shape,)
    return data.reshape(mx_reshape_shape(tuple(data.shape), shape))


@register_op("reshape_like")
def reshape_like(lhs, rhs, **_):
    return lhs.reshape(rhs.shape)


@register_op("transpose")
def transpose(data, axes=None, **_):
    if not axes:
        return data.permute(tuple(reversed(range(data.dim()))))
    return data.permute(tuple(axes))


@register_op("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0, **_):
    return data.transpose(dim1, dim2)


@register_op("flatten", aliases=("Flatten",))
def flatten(data, **_):
    return data.reshape(data.shape[0], -1)


@register_op("expand_dims")
def expand_dims(data, axis=0, **_):
    return data.unsqueeze(axis)


@register_op("squeeze")
def squeeze(data, axis=None, **_):
    if axis is None:
        return data.squeeze()
    return data.squeeze(_axes(axis, data.dim()))


@register_op("broadcast_to")
def broadcast_to(data, shape=None, **_):
    """``shape``, where a 0 keeps the input's axis (same rank)."""
    shape = tuple(shape)
    if len(shape) == data.dim():
        shape = tuple(d if s == 0 else s for s, d in zip(shape, data.shape))
    return data.expand(shape)


@register_op("broadcast_like")
def broadcast_like(lhs, rhs, **_):
    return lhs.expand(rhs.shape)


@register_op("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=(), **_):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return data.expand(tuple(shape))


def _slice_dim(x, dim, b, e, s):
    n = x.shape[dim]
    start, stop, step = builtins.slice(b, e, s).indices(n)
    if step > 0:
        index = [builtins.slice(None)] * x.dim()
        index[dim] = builtins.slice(start, stop, step)
        return x[tuple(index)]
    idx = torch.arange(start, stop, step, device=x.device)
    return x.index_select(dim, idx)


@register_op("slice", aliases=("crop",))
def slice(data, begin=None, end=None, step=None, **_):  # noqa: A001
    """``data[b:e:s, ...]`` per axis (``None`` entries take the
    defaults; a negative step walks backwards)."""
    step = step or [None] * len(begin)
    out = data
    for dim, (b, e, s) in enumerate(zip(begin, end, step)):
        out = _slice_dim(out, dim, b, e, s)
    return out


@register_op("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None, **_):
    if end is not None and end < 0:
        end = data.shape[axis] + end
    return _slice_dim(data, axis % data.dim(), begin, end, None)


@register_op("slice_like")
def slice_like(data, shape_like, axes=(), **_):
    axes = axes or tuple(range(shape_like.dim()))
    index = [builtins.slice(None)] * data.dim()
    for a in axes:
        index[a] = builtins.slice(0, shape_like.shape[a])
    return data[tuple(index)]


@register_op("take")
def take(a, indices, axis=0, mode="clip", **_):
    """Slices of ``a`` along ``axis`` at integer-cast ``indices``, clipped
    (``mode="clip"``) or wrapped (``"wrap"``) into range."""
    n = a.shape[axis]
    idx = indices.to(torch.int32).to(torch.int64)
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    axis = axis % a.dim()
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register_op("pick", aliases=("choose_element_0index",))
def pick(data, index, axis=-1, keepdims=False, mode="clip", **_):
    """``data`` at ``index`` along ``axis``: the index is cast to int32 and
    clipped (the reference clips in every ``mode``)."""
    n = data.shape[axis]
    idx = index.to(torch.int32).clamp(0, n - 1).to(torch.int64)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


def _index_tuple(indices):
    idx = indices.to(torch.int32).to(torch.int64)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register_op("gather_nd")
def gather_nd(data, indices, **_):
    return data[_index_tuple(indices)]


@register_op("scatter_nd")
def scatter_nd(data, indices, shape=None, **_):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_index_tuple(indices), data)


@register_op("one_hot")
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32", **_):
    """``on_value`` at each index, ``off_value`` elsewhere; an index out
    of ``[0, depth)`` gives a row of ``off_value``. As in the reference,
    the result is float32 for an integer ``dtype`` (the values scale by
    Python floats)."""
    idx = indices.to(torch.int32)
    oh = (idx.unsqueeze(-1) == torch.arange(
        depth, device=idx.device, dtype=torch.int32)).to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register_op("concat", aliases=("Concat",))
def concat(*data, dim=1, **_):
    return torch.cat(data, dim=dim)


@register_op("stack")
def stack(*data, axis=0, **_):
    return torch.stack(data, dim=axis)


@register_op("split", aliases=("SliceChannel",))
def split(data, num_outputs=1, axis=1, squeeze_axis=False, **_):
    """``num_outputs`` equal parts along ``axis``, a tuple (one part: the
    array)."""
    n = data.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis {axis} of length {n} does not "
                         f"divide into {num_outputs} parts")
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register_op("split_v2")
def split_v2(data, indices_or_sections=1, axis=0, squeeze_axis=False, **_):
    """``numpy.split``: equal sections, or cuts at the given indices."""
    if isinstance(indices_or_sections, int):
        n = data.shape[axis]
        if n % indices_or_sections:
            raise MXNetError(f"split_v2: axis {axis} of length {n} does not "
                             f"divide into {indices_or_sections} parts")
        parts = torch.split(data, n // indices_or_sections, dim=axis)
    else:
        parts = torch.tensor_split(data, list(indices_or_sections), dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register_op("tile")
def tile(data, reps=(), **_):
    return torch.tile(data, tuple(reps))


@register_op("repeat")
def repeat(data, repeats=1, axis=None, **_):
    return torch.repeat_interleave(data, repeats, dim=axis)


@register_op("reverse", aliases=("flip",))
def reverse(data, axis=(), **_):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axis)


@register_op("roll")
def roll(data, shift=0, axis=None, **_):
    return torch.roll(data, shift, dims=axis)


@register_op("diag")
def diag(data, k=0, **_):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register_op("depth_to_space")
def depth_to_space(data, block_size=1, **_):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register_op("space_to_depth")
def space_to_depth(data, block_size=1, **_):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


def _strides(shape):
    out, s = [], 1
    for d in reversed(shape):
        out.append(s)
        s *= d
    return out[::-1]


@register_op("ravel_multi_index")
def ravel_multi_index(data, shape=None, **_):
    """Flat indices of the coordinates in ``data``'s rows, each clipped
    into range, as float32."""
    flat = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, (d, st) in enumerate(zip(shape, _strides(shape))):
        flat = flat + data[i].to(torch.int32).clamp(0, d - 1).to(
            torch.int64) * st
    return flat.to(torch.float32)


@register_op("unravel_index")
def unravel_index(data, shape=None, **_):
    """Coordinates of flat indices (negative ones counted from the end,
    the rest clipped into range), stacked on axis 0, as float32."""
    size = math.prod(shape)
    idx = data.to(torch.int32).to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)
    outs = [(idx // st) % d for d, st in zip(shape, _strides(shape))]
    return torch.stack(outs, dim=0).to(torch.float32)


@register_op("shape_array")
def shape_array(data, **_):
    return torch.tensor(data.shape, dtype=torch.int32, device=data.device)


@register_op("size_array")
def size_array(data, **_):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register_op("zeros_like")
def zeros_like(data, **_):
    return torch.zeros_like(data)


@register_op("ones_like")
def ones_like(data, **_):
    return torch.ones_like(data)


@register_op("full_like")
def full_like(data, fill_value=0.0, **_):
    return torch.full_like(data, fill_value)


# -- ordering ----------------------------------------------------------------------
@register_op("sort")
def sort(data, axis=-1, is_ascend=True, **_):
    """A stable ascending sort (NaN last); descending flips it."""
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register_op("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32", **_):
    """Indices of a stable ascending sort; descending flips them, so
    equal keys come highest index first, as in the reference."""
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


@register_op("topk")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32", **_):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis`` in XLA's
    total order (-0.0 below +0.0, NaN by its sign), equal keys lowest
    index first (``lax.top_k`` on the value or its negation).
    ``ret_typ``: ``"value"``, ``"indices"``, ``"both"`` or ``"mask"``
    (0/1 in ``data``'s dtype)."""
    ax = axis % data.dim()
    moved = data.movedim(ax, -1)
    vals, idx = top_k(moved, k, largest=not is_ascend)
    if ret_typ == "mask":
        mask = torch.zeros(moved.shape, dtype=data.dtype, device=data.device)
        mask.scatter_(-1, idx, 1)
        return mask.movedim(-1, ax)
    vals, idx = vals.movedim(-1, ax), idx.movedim(-1, ax)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx.to(torch_dtype(dtype))
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    raise ValueError(f"unknown ret_typ {ret_typ}")


# -- sequences (time-major: axis 0) ----------------------------------------------
def _steps_mask(data, sequence_length, axis):
    T = data.shape[axis]
    steps = torch.arange(T, device=data.device)
    lengths = sequence_length.to(torch.int32)
    if axis == 0:
        mask = steps[:, None] < lengths[None, :]
    else:
        mask = steps[None, :] < lengths[:, None]
    return mask.reshape(mask.shape + (1,) * (data.dim() - 2))


@register_op("SequenceMask", aliases=("sequence_mask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0, **_):
    """Steps at or past each sequence's length set to ``value``; time on
    ``axis`` 0 (or 1), batch on the other."""
    if not use_sequence_length or sequence_length is None:
        return data
    # a CPU scalar, passed by value: nothing is copied to the card, so a
    # CUDA graph can capture the mask
    return torch.where(_steps_mask(data, sequence_length, axis), data,
                       torch.tensor(value, dtype=data.dtype))


@register_op("SequenceLast", aliases=("sequence_last",))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0, **_):
    """Each sequence's last valid step (time on ``axis`` 0 or 1)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    T = data.shape[axis]
    last = (sequence_length.to(torch.int32).to(torch.int64) - 1) % T
    x = data if axis == 0 else data.transpose(0, 1)
    return x[last, torch.arange(x.shape[1], device=x.device)]


@register_op("SequenceReverse", aliases=("sequence_reverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0, **_):
    """Each sequence's first ``length`` steps reversed, the rest in place
    (time-major; ``axis`` is taken and time stays on axis 0, as in the
    reference)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    T = data.shape[0]
    steps = torch.arange(T, device=data.device)[:, None]
    length = sequence_length.to(torch.int32).to(torch.int64)[None, :]
    idx = torch.where(steps < length, length - 1 - steps, steps)
    idx = idx.reshape(idx.shape + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, idx)


# -- linear algebra ------------------------------------------------------------------
@register_op("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, **_):
    a = A.transpose(-1, -2) if transpose_a else A
    b = B.transpose(-1, -2) if transpose_b else B
    return alpha * torch.matmul(*_promoted(a, b))


@register_op("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, **_):
    return linalg_gemm2(A, B, transpose_a, transpose_b, alpha) + beta * C


@register_op("linalg_potrf")
def linalg_potrf(A, **_):
    return torch.linalg.cholesky(A)


def _tri_solve(A, B, trans, lower):
    """``op(A) X = B`` for a triangular ``A`` (``op``: transpose if
    ``trans``)."""
    if trans:
        return torch.linalg.solve_triangular(A.transpose(-1, -2), B,
                                             upper=lower)
    return torch.linalg.solve_triangular(A, B, upper=not lower)


@register_op("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **_):
    if rightside:
        X = _tri_solve(A, (alpha * B).transpose(-1, -2), not transpose,
                       lower)
        return X.transpose(-1, -2)
    return _tri_solve(A, alpha * B, transpose, lower)


@register_op("linalg_sumlogdiag")
def linalg_sumlogdiag(A, **_):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register_op("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0, **_):
    At = A.transpose(-1, -2)
    return alpha * (torch.matmul(At, A) if transpose else torch.matmul(A, At))


@register_op("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **_):
    """Triangular matmul: only the triangular half of ``A`` takes
    part."""
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = tri.transpose(-1, -2)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register_op("tril")
def tril(data, k=0, **_):
    return torch.tril(data, k)


@register_op("triu")
def triu(data, k=0, **_):
    return torch.triu(data, k)


@register_op("all_finite")
def all_finite(data, init_output=True, **_):
    """1 if every value is finite, else 0, shape (1,), float32."""
    return torch.isfinite(data).all().reshape(1).to(torch.float32)


@register_op("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=1, init_output=True, **_):
    ok = torch.stack([torch.isfinite(a).all() for a in arrays]).all()
    return ok.reshape(1).to(torch.float32)


@register_op("boolean_mask", aliases=("_contrib_boolean_mask",))
def boolean_mask(data, index, axis=0, **_):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero.
    The output's shape depends on the mask, which is read on the host
    (refused inside a CUDA graph capture); the op stays differentiable
    in ``data``."""
    _no_capture("boolean_mask", index)
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, axis, keep.to(data.device))


@register_op("linalg_extractdiag")
def linalg_extractdiag(A, offset=0, **_):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register_op("linalg_makediag")
def linalg_makediag(A, offset=0, **_):
    """Square matrices with ``A``'s last axis on the diagonal; a 1-D
    ``A`` takes ``offset`` (batched input: the main diagonal, as in the
    reference)."""
    if A.dim() > 1:
        return torch.diag_embed(A)
    return torch.diag(A, offset)


# -- embedding -----------------------------------------------------------------------
@register_op("Embedding", aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False, **_):
    """Row lookup with ids clipped to ``[0, rows)``."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


# -- numpy-style additions ---------------------------------------------------------
def _scan(fn, a, axis, dtype):
    x = a.reshape(-1) if axis is None else a
    out_dt = _sum_dtype(a.dtype) if a.dtype == torch.bool else a.dtype
    out = fn(x, dim=0 if axis is None else axis).to(out_dt)
    return cast_saturating(out, dtype) if dtype else out


@register_op("cumsum")
def cumsum(a, axis=None, dtype=None, **_):
    return _scan(torch.cumsum, a, axis, dtype)


@register_op("cumprod")
def cumprod(a, axis=None, dtype=None, **_):
    return _scan(torch.cumprod, a, axis, dtype)


@register_op("trace")
def trace(a, offset=0, axis1=0, axis2=1, **_):
    d = torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2)
    return sum(d, axis=-1)


@register_op("kron")
def kron(a, b, **_):
    return torch.kron(*_promoted(a, b))


@register_op("digamma")
def digamma(a, **_):
    return torch.digamma(_fp(a))


@register_op("bincount")
def bincount(a, weights=None, minlength=0, **_):
    """Counts of each non-negative integer (negative ones count as 0),
    ``max(minlength, largest + 1)`` long; int32, or the weights' dtype.
    The length is read on the host (refused inside a CUDA graph
    capture)."""
    _no_capture("bincount", a)
    x = a.to(torch.int32).reshape(-1).clamp_min(0).to(torch.int64)
    length = builtins.max(int(minlength),
                          int(x.max()) + 1 if x.numel() else 1)
    w = None if weights is None else weights.reshape(-1)
    out = torch.bincount(x, weights=w, minlength=length)
    return out.to(torch.int32) if w is None else out.to(w.dtype)


@register_op("index_copy", aliases=("_contrib_index_copy",))
def index_copy(old_tensor, index_vector, new_tensor, **_):
    """``old_tensor`` with the rows at ``index_vector`` replaced by
    ``new_tensor``'s, the last update winning where indices repeat.
    Out-of-range indices raise, except inside a CUDA graph capture,
    where their rows are dropped."""
    idx = index_vector.to(torch.int32).reshape(-1).to(torch.int64)
    n, k = old_tensor.shape[0], idx.shape[0]
    want = (k,) + tuple(old_tensor.shape[1:])
    if tuple(new_tensor.shape) != want:
        raise ValueError(
            f"index_copy: new_tensor shape {tuple(new_tensor.shape)} must "
            f"be (len(index),) + old_tensor.shape[1:] = {want}")
    bad = (idx < 0) | (idx >= n)
    if not (idx.is_cuda and torch.cuda.is_current_stream_capturing()):
        if bool(bad.any()):
            raise ValueError(
                f"index_copy: indices {idx[bad].tolist()} out of range for "
                f"first dim {n}")
    pos = torch.arange(k, device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, torch.where(bad, n, idx), pos, "amax")[:n]
    picked = new_tensor.to(old_tensor.dtype)[last.clamp_min(0)]
    mask = (last >= 0).reshape((n,) + (1,) * (old_tensor.dim() - 1))
    return torch.where(mask, picked, old_tensor)


@register_op("index_array", aliases=("_contrib_index_array",))
def index_array(data, axes=None, **_):
    """Each element's coordinates along ``axes`` (all when None), shape
    ``data.shape + (len(axes),)``, int32."""
    nd_ = data.dim()
    if nd_ == 0:
        raise ValueError("index_array needs at least a 1-d input")
    if axes is None:
        sel = tuple(range(nd_))
    else:
        sel = []
        for a in axes:
            if not -nd_ <= a < nd_:
                raise ValueError(
                    f"index_array: axis {a} out of range for {nd_}-d input")
            sel.append(a % nd_)
        if not sel:
            raise ValueError("index_array: axes must be non-empty")
    comps = [torch.arange(data.shape[a], dtype=torch.int32,
                          device=data.device).reshape(
        tuple(data.shape[a] if i == a else 1 for i in range(nd_))).expand(
        data.shape) for a in sel]
    return torch.stack(comps, dim=-1)
