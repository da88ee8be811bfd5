"""The op namespace: ``mx.nd.<op>`` and the ``F`` of ``hybrid_forward``.

Counterpart: the ops of the JAX package's registry that the port's layers
and losses use (``ops/nn.py``: ``FullyConnected``, ``Convolution``,
``Deconvolution``, ``Pooling``, ``BatchNorm``, ``LayerNorm``,
``Activation``, ``LeakyReLU``, ``Dropout``, softmax; ``ops/tensor.py``:
``Embedding``, ``take``, ``pick``, ``pad``, shape ops and reductions)
and the update ops of ``ops/optimizer_ops.py`` (:mod:`..ops.optimizer_ops`),
whose ``out=`` writes the results into the given arrays in place. Each op is a function on
tensors. Given NDArrays it unwraps them, runs under
``torch.set_grad_enabled(autograd.is_recording())`` and wraps the result;
given tensors (inside ``hybrid_forward``, which the Gluon blocks run on
tensors) it is the plain function. The JAX op registry is not ported: the
namespace is this module.
"""
from __future__ import annotations

import functools

import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..context import Context
from ..ops import nn as _nn
from ..ops import optimizer_ops as _opt_ops
from .ndarray import NDArray, _recorded

__all__ = ["FullyConnected", "LayerNorm", "Activation", "Embedding",
           "Convolution", "Deconvolution", "Pooling", "BatchNorm", "Flatten",
           "LeakyReLU", "gelu_tanh", "silu", "swish", "pad", "Dropout",
           "softmax", "log_softmax", "take", "pick", "relu",
           "sigmoid", "tanh", "exp", "log", "sqrt", "square", "abs", "clip",
           "sum", "mean", "max", "min", "reshape", "transpose", "flatten",
           "expand_dims", "squeeze", "broadcast_to", "slice_axis", "concat",
           "split", "broadcast_lesser", "dot"] + list(_opt_ops.__all__)


def _has_nd(values) -> bool:
    for v in values:
        if isinstance(v, NDArray) or (isinstance(v, (list, tuple))
                                      and _has_nd(v)):
            return True
    return False


def _unwrap(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap(x) for x in v)
    return v


def _wrap(v):
    if isinstance(v, torch.Tensor):
        return _recorded(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def _nd_op(fn):
    """``fn`` on tensors -> an op that also takes NDArrays (see the module
    docstring)."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        if not (_has_nd(args) or _has_nd(kwargs.values())):
            return fn(*args, **kwargs)
        args = _unwrap(args)
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            return _wrap(fn(*args, **kwargs))
    return op


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


# -- neural-network ops -------------------------------------------------
@_nd_op
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """``data @ weight.T + bias`` (JAX counterpart: ``ops/nn.py:48``)."""
    return _nn.fully_connected(data, weight, None if no_bias else bias,
                               flatten=flatten)


@_nd_op
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalisation over the last axis (JAX counterpart:
    ``ops/nn.py:331``)."""
    if axis not in (-1, data.dim() - 1):
        raise MXNetError(f"LayerNorm over axis {axis} is not ported yet; "
                         "only the last axis")
    return _nn.layer_norm(data, gamma, beta, eps=eps)


@_nd_op
def Activation(data, act_type):
    return _nn.activation(data, act_type)


@_nd_op
def Convolution(data, weight, bias=None, **kwargs):
    """N-d convolution, NC(DHW) (JAX counterpart: ``ops/nn.py:90``)."""
    return _nn.convolution(data, weight, bias, **kwargs)


@_nd_op
def Deconvolution(data, weight, bias=None, **kwargs):
    """Transposed convolution (JAX counterpart: ``ops/nn.py:179``)."""
    return _nn.deconvolution(data, weight, bias, **kwargs)


@_nd_op
def Pooling(data, **kwargs):
    """Max/avg/sum/lp pooling (JAX counterpart: ``ops/nn.py:230``)."""
    return _nn.pooling(data, **kwargs)


@_nd_op
def BatchNorm(data, gamma, beta, moving_mean, moving_var, **kwargs):
    """``(out, batch or moving mean, var)`` (JAX counterpart:
    ``ops/nn.py:300``); the caller updates the moving statistics."""
    return _nn.batch_norm(data, gamma, beta, moving_mean, moving_var,
                          **kwargs)


@_nd_op
def LeakyReLU(data, gamma=None, **kwargs):
    """The leaky ReLU family (JAX counterpart: ``ops/nn.py:428``)."""
    return _nn.leaky_relu(data, gamma, **kwargs)


@_nd_op
def gelu_tanh(data):
    return _nn.ACTIVATIONS["gelu_tanh"](data)


@_nd_op
def silu(data):
    return _nn.ACTIVATIONS["silu"](data)


swish = silu


@_nd_op
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """MXNet's ``pad`` (JAX counterpart: ``ops/tensor.py:507``)."""
    return _nn.pad(data, mode, pad_width, constant_value)


@_nd_op
def Embedding(data, weight):
    """Row lookup with ids clipped into range (JAX counterpart:
    ``ops/tensor.py:854``)."""
    return _nn.embedding(data, weight)


@_nd_op
def Dropout(data, p=0.5, axes=(), generator=None):
    """Inverted dropout, active only under ``autograd.is_training()``: the
    mask shared along ``axes``, drawn from ``generator`` or else the
    device's stream of :mod:`..random`."""
    if p <= 0.0 or not autograd.is_training():
        return data
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    if generator is None:
        generator = _random.generator(Context.from_device(data.device))
    u = torch.rand(shape, generator=generator, device=data.device)
    return data * (u < keep).to(data.dtype) / keep


@_nd_op
def softmax(data, axis=-1):
    return torch.softmax(data, dim=axis)


@_nd_op
def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)


@_nd_op
def take(a, indices, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` at integer-cast ``indices``, clipped
    (``mode="clip"``) or wrapped (``"wrap"``) into range."""
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    shape = a.shape[:axis % a.dim()] + idx.shape + a.shape[axis % a.dim()
                                                           + 1:]
    return out.reshape(shape)


@_nd_op
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis`` (JAX counterpart:
    ``ops/tensor.py:441``): the index is cast to int32 and clipped."""
    n = data.shape[axis]
    idx = index.to(torch.int32).clamp(0, n - 1).to(torch.int64)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


# -- elementwise ----------------------------------------------------------
relu = _nd_op(torch.relu)
sigmoid = _nd_op(torch.sigmoid)
tanh = _nd_op(torch.tanh)
exp = _nd_op(torch.exp)
log = _nd_op(torch.log)
sqrt = _nd_op(torch.sqrt)
square = _nd_op(torch.square)
abs = _nd_op(torch.abs)  # noqa: A001  (the op's MXNet name)


@_nd_op
def clip(data, a_min=None, a_max=None):
    return data.clamp(a_min, a_max)


# -- reductions -------------------------------------------------------------
def _reduce(fn):
    @_nd_op
    def op(data, axis=None, keepdims=False):
        return fn(data, dim=_dims(data, axis), keepdim=keepdims)
    op.__name__ = fn.__name__
    return op


sum = _reduce(torch.sum)  # noqa: A001
mean = _reduce(torch.mean)
max = _reduce(torch.amax)  # noqa: A001
min = _reduce(torch.amin)  # noqa: A001


# -- shapes -----------------------------------------------------------------
@_nd_op
def reshape(data, shape):
    """``shape`` with MXNet's codes 0 (keep this axis) and -1 (infer)."""
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(data.shape[i] if s == 0 else s for i, s in
                  enumerate(shape))
    return data.reshape(shape)


@_nd_op
def transpose(data, axes=None):
    axes = tuple(reversed(range(data.dim()))) if not axes else tuple(axes)
    return data.permute(axes)


@_nd_op
def flatten(data):
    return _nn.flatten(data)


Flatten = flatten


@_nd_op
def expand_dims(data, axis):
    return data.unsqueeze(axis)


@_nd_op
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(_dims(data, axis))


@_nd_op
def broadcast_to(data, shape):
    return data.expand(tuple(shape))


@_nd_op
def slice_axis(data, axis, begin, end):
    index = [slice(None)] * data.dim()
    index[axis] = slice(begin, end)
    return data[tuple(index)]


@_nd_op
def concat(*data, dim=1):
    return torch.cat(data, dim=dim)


@_nd_op
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``, a tuple (one part: the
    array) (JAX counterpart: ``ops/tensor.py:481``)."""
    n = data.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis {axis} of length {n} does not "
                         f"divide into {num_outputs} parts")
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@_nd_op
def broadcast_lesser(lhs, rhs):
    """``lhs < rhs`` broadcast, as 0/1 in the operands' promoted dtype
    (float32 for two booleans) (JAX counterpart: ``ops/tensor.py:174``)."""
    dt = torch.promote_types(lhs.dtype, rhs.dtype)
    if dt == torch.bool:
        dt = torch.float32
    return (lhs < rhs).to(dt)


@_nd_op
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``lhs @ rhs`` over the last axis of ``lhs`` and the first of
    ``rhs``, either transposed first (2-D)."""
    a = lhs.t() if transpose_a else lhs
    b = rhs.t() if transpose_b else rhs
    return torch.tensordot(a, b, dims=1)



# -- optimizer updates and AMP casts (ops/optimizer_ops.py) ------------------
def _update_op(fn):
    """``fn`` as an ``mx.nd`` op whose ``out=`` (an array or a list, one
    per result) receives the results in place (JAX counterpart:
    ``ndarray/op.py:66-103``, ``out._set_data``)."""
    op = _nd_op(fn)

    @functools.wraps(fn)
    def nd_op(*args, out=None, **kwargs):
        kwargs.pop("name", None)
        result = op(*args, **kwargs)
        if out is None:
            return result
        outs = [out] if isinstance(out, (NDArray, torch.Tensor)) \
            else list(out)
        results = [result] if isinstance(result, (NDArray, torch.Tensor)) \
            else list(result)
        for o, r in zip(outs, results):
            if isinstance(o, NDArray):
                o._check_inplace_ok()
            with torch.no_grad():
                _unwrap(o).copy_(_unwrap(r))
        return out
    return nd_op


for _name in _opt_ops.__all__:
    globals()[_name] = _update_op(getattr(_opt_ops, _name))
del _name
