"""``mx.nd``: the NDArray namespace.

Counterpart: the JAX package's ``ndarray/__init__.py``: the ``NDArray``
class, the factories (``zeros``, ``ones``, ``full``, ``empty``,
``arange``, ``linspace``, ``eye``, ``concatenate``, ``from_numpy``,
``from_dlpack``), ``save``/``load`` of ``.params`` files, ``waitall``,
the samplers of :mod:`.random` under their flat names (``random_uniform``
..., ``sample_multinomial``, ``shuffle``), and every op of the registry
(:mod:`.op`), which are also the ``F`` of ``hybrid_forward``. Factories
without ``ctx`` use the current context (``gpu(0)`` unless a ``with ctx:``
says otherwise), which raises without a card. ``mx.nd.contrib`` is
``mx.contrib.nd``; ``mx.nd.sparse`` is :mod:`.sparse` (CSR and row-sparse
arrays).
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as _F

from ..base import MXNetError, torch_dtype
from ..context import Context, as_context, cpu, current_context  # noqa: F401
from ..engine import waitall
from ..ops.registry import OPS
from .ndarray import DLPackCarrier, NDArray, array
from .op import *  # noqa: F401,F403
from .op import __all__ as _OPS
from .op import _nd_op, make_nd_op
from .op import refresh_ops as _refresh_ops
from .serialization import NotDmlcFile, dmlc_load, dmlc_save
from . import random  # noqa: F401
from . import sparse  # noqa: F401
from .random import (  # noqa: F401
    uniform as random_uniform, normal as random_normal,
    randint as random_randint, exponential as random_exponential,
    poisson as random_poisson, gamma as random_gamma,
    negative_binomial as random_negative_binomial,
    generalized_negative_binomial as random_generalized_negative_binomial,
    multinomial as sample_multinomial, shuffle,
)

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "linspace", "eye", "concatenate", "save", "load", "waitall",
           "imresize", "moveaxis", "from_numpy", "from_dlpack",
           "to_dlpack_for_read", "to_dlpack_for_write", "DLPackCarrier",
           "random_uniform", "random_normal", "random_randint",
           "random_exponential", "random_poisson", "random_gamma",
           "random_negative_binomial",
           "random_generalized_negative_binomial", "sample_multinomial",
           "shuffle", "OPS", "make_nd_op", "refresh_ops",
           "dispatch_op", "sparse"] + list(_OPS)

_this = sys.modules[__name__]


def refresh_ops() -> None:
    """Reflect into ``mx.nd`` the registry names it lacks (for ops
    registered after it was imported; JAX counterpart: ``:42-48``)."""
    _refresh_ops(vars(_this))


def dispatch_op(pure_fn, arrays, kwargs=None, ctx=None, name=""):
    """``pure_fn`` on the tensors of ``arrays`` (NDArrays), recorded for
    autograd under ``record()``, the results wrapped (JAX counterpart:
    ``ndarray/op.py:dispatch_op``; ``kwargs``, ``ctx`` and ``name`` are
    taken for its signature)."""
    return _nd_op(pure_fn)(*arrays)


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _factory(fill, shape, ctx, dtype) -> NDArray:
    return NDArray(fill(_shape(shape), dtype=torch_dtype(dtype or "float32"),
                        device=as_context(ctx).torch_device))


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return _factory(torch.zeros, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return _factory(torch.ones, shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.full(_shape(shape), val,
                              dtype=torch_dtype(dtype or "float32"),
                              device=as_context(ctx).torch_device))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None,
           infer_range=False) -> NDArray:
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step,
                       dtype=torch_dtype(dtype or "float32"),
                       device=as_context(ctx).torch_device)
    if repeat > 1:
        out = out.repeat_interleave(repeat)
    return NDArray(out)


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype=None) -> NDArray:
    """``num`` evenly spaced values from ``start`` to ``stop`` (inclusive
    with ``endpoint``)."""
    dt = torch_dtype(dtype or "float32")
    dev = as_context(ctx).torch_device
    if endpoint:
        return NDArray(torch.linspace(start, stop, num, device=dev).to(dt))
    step = (stop - start) / num
    return NDArray((start + step * torch.arange(num, device=dev)).to(dt))


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    """An ``N x M`` (``M=0``: square) array with ones on diagonal ``k``."""
    M = M or N
    out = torch.zeros((N, M), dtype=torch_dtype(dtype or "float32"),
                      device=as_context(ctx).torch_device)
    out.diagonal(k).fill_(1)
    return NDArray(out)


def moveaxis(data, source, destination) -> NDArray:
    return _nd_op(torch.movedim)(data, source, destination)


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return concat(*arrays, dim=axis)  # noqa: F405


def from_numpy(np_array, zero_copy=False) -> NDArray:
    """An NDArray of a numpy array, as :func:`array`."""
    return array(np_array)


def from_dlpack(dlpack) -> NDArray:
    """An NDArray over a DLPack-protocol object or capsule (no copy)."""
    return NDArray(torch.from_dlpack(dlpack))


def to_dlpack_for_read(data: NDArray) -> DLPackCarrier:
    return data.to_dlpack_for_read()


to_dlpack_for_write = to_dlpack_for_read


def imresize(src, w, h, interp=1) -> NDArray:
    """``src`` (H, W, ...) resized to ``(h, w)``: bilinear (``interp``
    nonzero, antialiased when shrinking, as ``jax.image.resize``) or
    nearest."""
    x = src._data
    flat = x.reshape(x.shape[0], x.shape[1], -1).permute(2, 0, 1)[None]
    if interp:
        shrink = h < x.shape[0] or w < x.shape[1]
        out = _F.interpolate(flat.float(), size=(h, w), mode="bilinear",
                             align_corners=False, antialias=shrink)
    else:
        out = _F.interpolate(flat.float(), size=(h, w), mode="nearest-exact")
    out = out[0].permute(1, 2, 0).reshape((h, w) + tuple(x.shape[2:]))
    return NDArray(out.to(x.dtype))


def _host(v):
    if isinstance(v, torch.Tensor):
        v = NDArray(v)
    if not isinstance(v, NDArray):
        raise MXNetError("save expects NDArray, list of NDArray, or dict of "
                         "str->NDArray")
    return v._raw_numpy()


def save(fname: str, data) -> None:
    """Write ``data`` (an NDArray, a list of them or a dict name ->
    NDArray) as an upstream ``.params`` V2 file (JAX counterpart:
    ``ndarray/__init__.py:214``): the same bytes as the JAX package writes
    for the same arrays."""
    if isinstance(data, (NDArray, torch.Tensor)):
        arrays, names = [_host(data)], []
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [_host(v) for v in data.values()]
    elif isinstance(data, (list, tuple)):
        arrays, names = [_host(v) for v in data], []
    else:
        raise MXNetError("save expects NDArray, list of NDArray, or dict of "
                         "str->NDArray")
    dmlc_save(fname, arrays, names)


def load(fname: str):
    """Read a ``.params`` file: a dict name -> NDArray when it holds
    names, else a list (JAX counterpart: ``ndarray/__init__.py:228``). The
    arrays land on the CPU, the context every record of the format names.
    """
    try:
        arrays, names = dmlc_load(fname)
    except NotDmlcFile:
        raise MXNetError(f"{fname} is not a saved NDArray file") from None
    if names:
        if len(names) != len(arrays):
            raise MXNetError(f"{fname}: name/array count mismatch")
        return {n: _from_host(a) for n, a in zip(names, arrays)}
    return [_from_host(a) for a in arrays]


def _from_host(a) -> NDArray:
    # keep the file's dtype exactly (no float64/int64 narrowing)
    return array(a, ctx="cpu", dtype=None if a.dtype.names else a.dtype)


def __getattr__(name):
    # mx.nd.contrib is mx.contrib.nd (JAX counterpart:
    # ndarray/__init__.py:255-259), so hybrid_forward's F.contrib.<op>
    # works; imported on first use, as contrib imports this package
    if name == "contrib":
        from ..contrib import nd as _contrib_nd
        return _contrib_nd
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
