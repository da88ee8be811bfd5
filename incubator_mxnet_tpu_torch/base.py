"""Errors and small helpers shared by the port.

Counterpart: the JAX package's ``base.py`` (``MXNetError`` at
``base.py:32``, ``_as_list`` at ``base.py:42``). Dtypes are named by string
as in the JAX package (``"float32"``, ``"bfloat16"`` ...) and map one to one
onto ``torch.dtype``.
"""
from __future__ import annotations

from typing import Union

import numpy as onp
import torch

__all__ = ["MXNetError", "torch_dtype", "dtype_name", "as_list"]


class MXNetError(RuntimeError):
    """Error raised by the framework (JAX counterpart: ``base.py:32``)."""


_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def torch_dtype(dtype: Union[str, torch.dtype, type, onp.dtype]
                ) -> torch.dtype:
    """A dtype name (``"float32"``, ``"bfloat16"`` ...), a numpy dtype or
    type, or a ``torch.dtype`` to a ``torch.dtype`` — the JAX package names
    dtypes by string (e.g. ``get_bert(dtype="bfloat16")`` at
    ``models/bert.py:215``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if name not in _DTYPES:
        try:
            name = onp.dtype(dtype).name
        except TypeError:
            pass
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def dtype_name(dtype) -> str:
    """The string name of any dtype :func:`torch_dtype` takes."""
    return _NAMES[torch_dtype(dtype)]


def as_list(obj) -> list:
    """``obj`` as a list: lists and tuples become lists, anything else a
    list of one (JAX counterpart: ``base.py:42``)."""
    return list(obj) if isinstance(obj, (list, tuple)) else [obj]
