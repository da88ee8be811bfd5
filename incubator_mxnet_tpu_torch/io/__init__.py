"""``mx.io``: in-memory data iterators (JAX counterpart: ``io/__init__.py``
``:36-183``, which imports no JAX; the port keeps its own copy).

``DataDesc``, ``DataBatch``, the ``DataIter`` base and ``NDArrayIter``:
batches sliced on the host from numpy copies of the data, with
``shuffle`` (numpy's global stream, as in the reference) and
``last_batch_handle`` ``"pad"`` (the last batch wraps around to full size
and reports its ``pad``), ``"discard"`` or ``"roll_over"`` (the partial
last batch's rows start the next epoch). Each batch's arrays are ``mx.nd``
arrays on the current context. ``CSVIter``, ``LibSVMIter``, ``MNISTIter``,
``ImageRecordIter`` and the prefetching and resizing wrappers are not
ported yet.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Optional

import numpy as onp

from ..base import MXNetError
from ..ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Name, shape, dtype and layout of one input (JAX counterpart:
    ``io/__init__.py:36``)."""

    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout: Optional[str]) -> int:
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One batch: ``data`` and ``label`` lists, ``pad`` rows of filler
    (JAX counterpart: ``io/__init__.py:45``)."""

    def __init__(self, data, label=None, pad: int = 0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __repr__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        return f"DataBatch: data shapes {shapes} pad {self.pad}"


class DataIter:
    """Iterator base (JAX counterpart: ``io/__init__.py:60``)."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self) -> int:
        return 0


def _as_named_arrays(data, default_name: str):
    """Normalize array|list|dict into an ordered [(name, ndarray)] list."""
    if data is None:
        return []
    if isinstance(data, dict):
        items = list(data.items())
    elif isinstance(data, (list, tuple)):
        items = [(f"{default_name}" if i == 0 else f"{default_name}{i}", d)
                 for i, d in enumerate(data)]
    else:
        items = [(default_name, data)]
    out = []
    for name, d in items:
        if isinstance(d, NDArray):
            d = d.asnumpy()
        out.append((name, onp.asarray(d)))
    return out


class NDArrayIter(DataIter):
    """In-memory iterator over arrays, lists or dicts of them (JAX
    counterpart: ``io/__init__.py:116``)."""

    def __init__(self, data, label=None, batch_size: int = 1,
                 shuffle: bool = False, last_batch_handle: str = "pad",
                 data_name: str = "data", label_name: str = "softmax_label"):
        super().__init__(batch_size)
        self.data = _as_named_arrays(data, data_name)
        self.label = _as_named_arrays(label, label_name)
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        for _, d in self.data + self.label:
            if d.shape[0] != self.num_data:
                raise MXNetError("all data/label arrays must share dim 0")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._order = onp.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + d.shape[1:], d.dtype)
                for n, d in self.data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + d.shape[1:], d.dtype)
                for n, d in self.label]

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self._order)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data)
        else:
            self.cursor = -self.batch_size

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        for _, d in arrays:
            idx = self._order[max(0, self.cursor):
                              self.cursor + self.batch_size]
            chunk = d[idx]
            if chunk.shape[0] < self.batch_size:  # pad by wrapping
                extra = self._order[:self.batch_size - chunk.shape[0]]
                chunk = onp.concatenate([chunk, d[extra]], axis=0)
            out.append(array(chunk))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self) -> int:
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
