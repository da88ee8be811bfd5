"""Sparse NDArrays: the ``row_sparse`` and ``csr`` storage types.

Counterpart: the JAX package's ``ndarray/sparse.py`` (``:1-212``), with its
semantics: a facade whose compressed structure is built on the host and
whose values stay dense on the device, so every op of ``mx.nd`` computes on
the dense array. :class:`RowSparseNDArray` keeps the row indices,
:class:`CSRNDArray` the ``indptr``, column indices and values (duplicate
entries add up); :func:`dot` (JAX ``:162``) computes ``csr @ dense`` (and
``csr.T @ dense``) on the nonzero structure only, a gather of the dense
rows by column index and an ``index_add_`` by row. :func:`cast_storage`
(JAX ``:193``) and ``NDArray.tostype`` convert between the types.

Materialising the dense array is refused past ``MXTPU_SPARSE_DENSE_LIMIT``
bytes (default 2 GiB; 0 disables), as in the JAX package (``:26``): a
row-sparse view of an embedding table of millions of rows would otherwise
allocate the whole table.
"""
from __future__ import annotations

import os

import numpy as onp
import torch

from ..base import MXNetError, dtype_name, torch_dtype
from ..context import as_context
from .ndarray import NDArray

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array",
           "csr_matrix", "cast_storage", "dot", "zeros"]

#: numpy's default integer and float widths narrowed, as the JAX package's
#: ``jnp.asarray`` narrows them (64-bit types are off there)
_NARROW = {"float64": "float32", "int64": "int32", "uint64": "uint32"}


def _check_dense_budget(shape, dtype) -> None:
    """Refuse to materialise a dense ``shape`` past the byte budget (JAX
    counterpart: ``:26``)."""
    limit = int(os.environ.get("MXTPU_SPARSE_DENSE_LIMIT",
                               str(2 * 1024 ** 3)))
    if limit <= 0:
        return
    n = 1
    for d in shape:
        n *= int(d)
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    if nbytes > limit:
        raise MXNetError(
            f"sparse facade: materializing dense {tuple(shape)} "
            f"({nbytes / 1e9:.2f} GB) exceeds MXTPU_SPARSE_DENSE_LIMIT "
            f"({limit / 1e9:.2f} GB). This build's sparse storage is a "
            "dense facade; for large embedding tables use dense parameters "
            "(the default Embedding path), or raise the limit explicitly "
            "via MXTPU_SPARSE_DENSE_LIMIT (0 disables).")


def _host(x, dtype=None) -> onp.ndarray:
    """``x`` (an NDArray, tensor or array-like) as a host array, in
    ``dtype`` or else its own with 64-bit types narrowed."""
    if isinstance(x, NDArray):
        a = x.asnumpy()
    elif isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
    else:
        a = onp.asarray(x)
    if dtype is not None:
        return a.astype(dtype_name(torch_dtype(dtype)))
    return a.astype(_NARROW.get(a.dtype.name, a.dtype))


class BaseSparseNDArray(NDArray):
    """Common base: behaves as its dense equivalent for compute."""

    __slots__ = ()


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` of a ``shape`` array hold ``data``; the others are
    zero."""

    __slots__ = ("_indices",)

    def __init__(self, data, indices, shape=None, ctx=None, dtype=None):
        rows = _host(data, dtype)
        idx = _host(indices, "int32")
        if shape is None:
            shape = rows.shape
        dt = torch_dtype(rows.dtype)
        _check_dense_budget(shape, dt)
        dev = as_context(ctx).torch_device
        dense = torch.zeros(tuple(shape), dtype=dt, device=dev)
        ti = torch.from_numpy(idx).to(dev, torch.long)
        dense[ti] = torch.from_numpy(rows).to(dev)
        super().__init__(dense, ctx=as_context(ctx))
        self._indices = ti.to(torch.int32)

    @property
    def stype(self) -> str:
        return "row_sparse"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices)

    @property
    def data(self) -> NDArray:
        return NDArray(self._data[self._indices.long()])

    def tostype(self, stype: str) -> NDArray:
        if stype == "row_sparse":
            return self
        if stype == "default":
            return NDArray(self._data, ctx=self.context)
        raise MXNetError(f"cast_storage row_sparse->{stype} unsupported")


class CSRNDArray(BaseSparseNDArray):
    """A 2-D array in compressed sparse rows: ``data`` at columns
    ``indices``, row ``r`` holding the entries ``indptr[r]:indptr[r+1]``."""

    __slots__ = ("_indptr", "_col_indices", "_values", "_row_indices")

    def __init__(self, data, indptr, indices, shape, ctx=None, dtype=None):
        vals = _host(data, dtype)
        ip = _host(indptr, "int32")
        col = _host(indices, "int32")
        dt = torch_dtype(vals.dtype)
        _check_dense_budget(shape, dt)
        rows = onp.repeat(onp.arange(int(shape[0])), onp.diff(ip))
        dense = onp.zeros(tuple(shape), dtype=vals.dtype)
        # duplicate (row, col) entries add up, as dot() adds them
        onp.add.at(dense, (rows, col), vals)
        dev = as_context(ctx).torch_device
        super().__init__(torch.from_numpy(dense).to(dev), ctx=as_context(ctx))
        self._indptr = torch.from_numpy(ip).to(dev)
        self._col_indices = torch.from_numpy(col).to(dev)
        self._values = torch.from_numpy(vals).to(dev)
        self._row_indices = torch.from_numpy(rows.astype("int32")).to(dev)

    @property
    def stype(self) -> str:
        return "csr"

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._indptr)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._col_indices)

    @property
    def data(self) -> NDArray:
        return NDArray(self._values)

    def tostype(self, stype: str) -> NDArray:
        if stype == "csr":
            return self
        if stype == "default":
            return NDArray(self._data, ctx=self.context)
        raise MXNetError(f"cast_storage csr->{stype} unsupported")


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None
                     ) -> RowSparseNDArray:
    """A row-sparse array from ``(data, indices)`` or from a dense array
    (its rows with a nonzero kept)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(data, indices, shape=shape, ctx=ctx,
                                dtype=dtype)
    dense = _host(arg1)
    nz = onp.where(onp.abs(dense).reshape(dense.shape[0], -1).sum(axis=1)
                   > 0)[0]
    return RowSparseNDArray(dense[nz], nz, shape=dense.shape, ctx=ctx,
                            dtype=dtype)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """A CSR array from ``(data, indices, indptr)`` or from a dense 2-D
    array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indptr, indices, shape, ctx=ctx, dtype=dtype)
    dense = _host(arg1)
    rows, cols = onp.nonzero(dense)
    vals = dense[rows, cols]
    counts = onp.bincount(rows, minlength=dense.shape[0])
    indptr = onp.concatenate([[0], onp.cumsum(counts)])
    return CSRNDArray(vals.astype(dense.dtype), indptr, cols, dense.shape,
                      ctx=ctx, dtype=dtype)


def dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False
        ) -> NDArray:
    """``csr @ rhs`` (or ``csr.T @ rhs``) on the nonzero structure: each
    nonzero ``(r, c)`` adds ``A[r, c] * B[c]`` into row ``r`` of the
    output (``B[r]`` into row ``c`` under ``transpose_a``), a gather and
    an ``index_add_`` on the device (JAX counterpart: ``:162``). ``rhs``
    is any NDArray (a row-sparse one computes on its dense values)."""
    if transpose_b:
        raise MXNetError("sparse dot: transpose_b is unsupported (reference "
                         "csr kernels are lhs-sparse only)")
    if not isinstance(lhs, CSRNDArray):
        raise MXNetError("sparse dot needs a CSR lhs; use dense dot otherwise")
    B = rhs._data if isinstance(rhs, NDArray) else \
        torch.as_tensor(onp.asarray(rhs), device=lhs._data.device)
    vals = lhs._values
    rows, cols = lhs._row_indices.long(), lhs._col_indices.long()
    out_dtype = torch.result_type(vals, B)
    contrib_shape = tuple(vals.shape) + (1,) * (B.dim() - 1)
    if transpose_a:
        out_rows, gather, scatter = int(lhs.shape[1]), rows, cols
    else:
        out_rows, gather, scatter = int(lhs.shape[0]), cols, rows
    contrib = vals.reshape(contrib_shape).to(out_dtype) * \
        B[gather].to(out_dtype)
    out = torch.zeros((out_rows,) + tuple(B.shape[1:]), dtype=out_dtype,
                      device=B.device)
    out.index_add_(0, scatter, contrib)
    return NDArray(out)


def cast_storage(arr: NDArray, stype: str) -> NDArray:
    """``arr`` in storage ``stype`` (``default``, ``row_sparse`` or ``csr``,
    2-D)."""
    if stype == "default":
        return NDArray(arr._data, ctx=arr.context)
    if stype == "row_sparse":
        return row_sparse_array(arr, ctx=arr.context)
    if stype == "csr":
        if arr.ndim != 2:
            raise MXNetError("csr requires 2-D")
        return csr_matrix(arr, ctx=arr.context)
    raise MXNetError(f"unknown stype {stype}")


def zeros(stype: str, shape, ctx=None, dtype=None) -> NDArray:
    """All-zero array of storage ``stype``."""
    if stype == "row_sparse":
        return row_sparse_array(onp.zeros(shape), ctx=ctx, dtype=dtype)
    if stype == "csr":
        return csr_matrix(onp.zeros(shape), ctx=ctx, dtype=dtype)
    from . import zeros as dense_zeros
    return dense_zeros(shape, ctx=ctx, dtype=dtype)
