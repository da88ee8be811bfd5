"""Gluon utilities (JAX counterpart: ``gluon/utils.py``): ``split_data``,
``split_and_load``, ``clip_global_norm``, ``check_sha1`` and
``download``, which, like the JAX one, only returns a file already on
disk (nothing is fetched)."""
from __future__ import annotations

import hashlib
import os
import warnings
from typing import List, Optional

import numpy as onp
import torch

from ..base import MXNetError
from ..ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """``num_slice`` slices along ``batch_axis``, the last taking the
    remainder (JAX counterpart: ``gluon/utils.py:19``)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's a multiple of {num_slice} or set even_split=False.")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        end = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(i * step, end)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """Split a batch and load slice ``i`` onto ``ctx_list[i]`` (JAX
    counterpart: ``gluon/utils.py:43``)."""
    if not isinstance(data, NDArray):
        data = array(onp.asarray(data), ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before, a Python float (JAX
    counterpart: ``gluon/utils.py:56``). The norm comes from one
    ``torch._foreach_norm`` (float32 per array, summed in float64, as the
    JAX one sums its float32 squares in Python floats) and one read to
    the host; the scaling from one ``torch._foreach_mul_``."""
    if not arrays:
        raise ValueError("arrays must not be empty")
    ts = [getattr(a, "_data", a) for a in arrays]
    norms = torch._foreach_norm(ts, 2, dtype=torch.float32)
    total_norm = float(torch.stack(norms).double().square().sum().sqrt())
    if check_isfinite and not onp.isfinite(total_norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            torch._foreach_mul_(ts, scale)
    return total_norm


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """Does the file's SHA-1 match ``sha1_hash``?"""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url: str, path: Optional[str] = None, overwrite: bool = False,
             sha1_hash: Optional[str] = None, retries: int = 5,
             verify_ssl: bool = True) -> str:
    """The local copy of ``url`` under ``path``, if it is there (and
    matches ``sha1_hash``); raises otherwise: nothing is fetched (JAX
    counterpart: ``gluon/utils.py:83``)."""
    fname = path if path and not os.path.isdir(path) else os.path.join(
        path or ".", url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(f"download({url}) unavailable: files are not fetched, "
                     f"and {fname} does not exist locally.")
