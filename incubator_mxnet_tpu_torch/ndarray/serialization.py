"""dmlc-stream NDArray serialization: the upstream ``.params`` format.

Counterpart: the JAX package's ``ndarray/serialization.py`` (``:39-256``),
kept here as the port's own copy in numpy, so that files move both ways
between the two packages and upstream MXNet 1.x. Wire layout (all
little-endian):

File (kMXAPINDArrayListMagic list container)::

    uint64  0x112 (list magic)      uint64  0 (reserved)
    uint64  n_arrays                n_arrays × <NDArray record>
    uint64  n_names                 n_names × (uint64 len + utf-8 bytes)

NDArray record (V2 0xF993FAC9 / V3 0xF993FACA; V1 0xF993FAC8 and the
pre-magic legacy layout are load-only)::

    uint32  version magic
    int32   storage type (0 = dense; sparse records are load-rejected)
    uint32  ndim   +  int64 × ndim          (TShape, dim_t = int64 in 1.x)
    int32   dev_type   int32   dev_id       (Context::Save)
    int32   type flag (kFloat32=0 ... kBfloat16=12)
    raw     data bytes, C-contiguous

Writing always emits V2 dense records with the Python writer of the JAX
package, byte for byte. numpy has no bfloat16: such an array travels as
:data:`BFLOAT16`, one little-endian ``uint16`` field with the raw bits.
"""
from __future__ import annotations

import os
import struct
from typing import List, Sequence

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["dmlc_save", "dmlc_load", "DMLC_LIST_MAGIC", "NotDmlcFile",
           "BFLOAT16", "to_host", "from_host"]


class NotDmlcFile(MXNetError):
    """The file is not a dmlc .params container at all (magic mismatch /
    too short for the header)."""


DMLC_LIST_MAGIC = 0x112
_ND_V1 = 0xF993FAC8
_ND_V2 = 0xF993FAC9
_ND_V3 = 0xF993FACA

# mshadow type flags (include/mxnet/base.h TypeFlag)
_FLAG_TO_DTYPE = {
    0: "float32", 1: "float64", 2: "float16", 3: "uint8", 4: "int32",
    5: "int8", 6: "int64", 7: "bool", 8: "int16", 9: "uint16",
    10: "uint32", 11: "uint64", 12: "bfloat16",
}
_DTYPE_TO_FLAG = {v: k for k, v in _FLAG_TO_DTYPE.items()}

#: the numpy stand-in for bfloat16: the raw 16 bits of each value
BFLOAT16 = onp.dtype([("bfloat16", "<u2")])


def to_host(t) -> onp.ndarray:
    """A tensor as a numpy array (a copy on the host); bfloat16 as
    :data:`BFLOAT16`."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BFLOAT16)
    return t.numpy()


def from_host(a, device) -> "torch.Tensor":
    """A numpy array as a tensor on ``device``: bfloat16 as either package
    writes it (:data:`BFLOAT16`, or the JAX package's numpy ``bfloat16``,
    2 bytes wide)."""
    a = onp.asarray(a)
    if a.dtype == BFLOAT16 or a.dtype.name == "bfloat16":
        bits = onp.ascontiguousarray(a).view("<i2")
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(onp.array(a)).to(device)


def _dtype_name(arr: onp.ndarray) -> str:
    return "bfloat16" if arr.dtype == BFLOAT16 else arr.dtype.name


def _np_dtype(name: str) -> onp.dtype:
    return BFLOAT16 if name == "bfloat16" else onp.dtype(name)


def _write_ndarray(f, arr: onp.ndarray) -> None:
    name = _dtype_name(arr)
    if name not in _DTYPE_TO_FLAG:
        raise MXNetError(f"dtype {name} has no dmlc type flag")
    arr = onp.ascontiguousarray(arr)
    if arr.ndim == 0:
        # upstream has no 0-d arrays (ndim==0 marks a "none" record that
        # carries no ctx/dtype/data): promote scalars as nd.array does
        arr = arr.reshape(1)
    f.write(struct.pack("<I", _ND_V2))
    f.write(struct.pack("<i", 0))                       # kDefaultStorage
    f.write(struct.pack("<I", arr.ndim))
    f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
    f.write(struct.pack("<ii", 1, 0))                   # Context: cpu(0)
    f.write(struct.pack("<i", _DTYPE_TO_FLAG[name]))
    f.write(byte_view(arr))


def byte_view(arr: onp.ndarray) -> onp.ndarray:
    """The bytes of a C-contiguous array, as a flat uint8 view (no copy):
    what ``f.write`` and ``zlib.crc32`` take."""
    return arr.reshape(-1).view(onp.uint8)


def _read_exact(f, n: int) -> bytes:
    # a crafted record can declare a 2^45-element shape: never allocate
    # more than the file can supply (checked for large reads only)
    if n > (1 << 20):
        try:
            remaining = os.fstat(f.fileno()).st_size - f.tell()
        except (OSError, AttributeError):
            remaining = None
        if remaining is not None and n > remaining:
            raise MXNetError("truncated dmlc NDArray stream")
    b = f.read(n)
    if len(b) != n:
        raise MXNetError("truncated dmlc NDArray stream")
    return b


def _read_ndarray(f) -> onp.ndarray:
    (magic,) = struct.unpack("<I", _read_exact(f, 4))
    if magic in (_ND_V2, _ND_V3):
        (stype,) = struct.unpack("<i", _read_exact(f, 4))
        if stype != 0:
            raise MXNetError(
                f"sparse storage type {stype} in .params is not supported "
                "(dense-convert it in the source framework)")
        (ndim,) = struct.unpack("<I", _read_exact(f, 4))
        if ndim == 0:  # upstream "none" record: nothing else follows
            return onp.zeros((0,), "float32")
        shape = struct.unpack(f"<{ndim}q", _read_exact(f, 8 * ndim))
    elif magic == _ND_V1:
        (ndim,) = struct.unpack("<I", _read_exact(f, 4))
        if ndim == 0:
            return onp.zeros((0,), "float32")
        shape = struct.unpack(f"<{ndim}q", _read_exact(f, 8 * ndim))
    else:
        # legacy pre-magic layout: the uint32 just read IS ndim (uint32 dims)
        ndim = magic
        if ndim > 32:
            raise MXNetError("unrecognized NDArray record magic "
                             f"0x{magic:08x}")
        shape = struct.unpack(f"<{ndim}I", _read_exact(f, 4 * ndim))
    _read_exact(f, 8)                                   # Context
    (flag,) = struct.unpack("<i", _read_exact(f, 4))
    if flag not in _FLAG_TO_DTYPE:
        raise MXNetError(f"unknown dmlc type flag {flag}")
    dt = _np_dtype(_FLAG_TO_DTYPE[flag])
    n = 1
    for s in shape:
        n *= int(s)
    data = _read_exact(f, n * dt.itemsize)
    return onp.frombuffer(data, dtype=dt).reshape(shape).copy()


def dmlc_save(fname: str, arrays: Sequence[onp.ndarray],
              names: Sequence[str]) -> None:
    """Write the kMXAPINDArrayListMagic container (upstream ``.params``).

    Atomic: the bytes go to a temporary file beside the target, which
    replaces it only after a flush and fsync, so a crash never leaves a
    truncated file where a good one stood. The chaos site ``nd.save``
    (``fault.inject``) dies with the temporary file half written (JAX
    counterpart: ``ndarray/serialization.py:171-194``)."""
    from ..fault import inject
    tmp = f"{fname}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<QQ", DMLC_LIST_MAGIC, 0))
            f.write(struct.pack("<Q", len(arrays)))
            for a in arrays:
                _write_ndarray(f, a)
            inject.crash("nd.save")
            f.write(struct.pack("<Q", len(names)))
            for s in names:
                b = s.encode("utf-8")
                f.write(struct.pack("<Q", len(b)))
                f.write(b)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def dmlc_load(fname: str):
    """Read an upstream ``.params`` file -> ``(list_of_arrays,
    list_of_names)``. Raises :class:`NotDmlcFile` if the list magic does
    not match, :class:`MXNetError` on a broken record."""
    with open(fname, "rb") as f:
        head = f.read(16)
        if len(head) != 16:
            raise NotDmlcFile(f"{fname}: too short for a dmlc .params file")
        magic, _reserved = struct.unpack("<QQ", head)
        if magic != DMLC_LIST_MAGIC:
            raise NotDmlcFile(f"{fname}: not a dmlc .params file")
        (n,) = struct.unpack("<Q", _read_exact(f, 8))
        arrays = [_read_ndarray(f) for _ in range(n)]
        names: List[str] = []
        rest = f.read(8)
        if rest:
            if len(rest) != 8:
                raise MXNetError("truncated dmlc NDArray stream")
            (nn,) = struct.unpack("<Q", rest)
            for _ in range(nn):
                (ln,) = struct.unpack("<Q", _read_exact(f, 8))
                names.append(_read_exact(f, ln).decode("utf-8"))
    return arrays, names
