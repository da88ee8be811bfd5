"""``mx.nd``: the NDArray namespace.

Counterpart: the JAX package's ``ndarray/__init__.py`` (``:102-243``): the
``NDArray`` class, the factories (``zeros``, ``ones``, ``full``, ``empty``,
``arange``, ``concatenate``), ``save``/``load`` of ``.params`` files, and
the ops of :mod:`.op`, which are also the ``F`` of ``hybrid_forward``.
Factories without ``ctx`` use the current context (``gpu(0)`` unless a
``with ctx:`` says otherwise), which raises without a card.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, torch_dtype
from ..context import as_context
from .ndarray import NDArray, array
from .op import *  # noqa: F401,F403
from .op import __all__ as _OPS
from .serialization import NotDmlcFile, dmlc_load, dmlc_save

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "save", "load"] + list(_OPS)


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


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return concat(*arrays, dim=axis)  # noqa: F405


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
