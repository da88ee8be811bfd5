"""Datasets (JAX counterpart: ``gluon/data/dataset.py``; reference:
``python/mxnet/gluon/data/dataset.py``). Samples are host arrays: nothing
here makes a tensor, so a dataset is safe to read in a forked
``DataLoader`` worker."""
from __future__ import annotations

import os
import threading
from typing import Callable, Sequence

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract random-access dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn: Callable) -> "Dataset":
        return SimpleDataset([s for s in self if fn(s)])

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """The ``index``-th of ``num_shards`` contiguous parts, the first
        ``len % num_shards`` parts one sample longer."""
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of [0, {num_shards})")
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count) -> "Dataset":
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        """``fn`` over each sample (over its fields when it is a tuple),
        at each read (``lazy``) or once, now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        """``fn`` over each sample's first field only."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data: Sequence):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Samples zipped from equal-length arrays or datasets; an ``NDArray``
    is read to the host once, here."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        from ...ndarray import NDArray
        self._length = len(args[0])
        self._data = []
        for data in args:
            if len(data) != self._length:
                raise ValueError(f"All arrays must have the same length; "
                                 f"{len(data)} != {self._length}")
            if isinstance(data, NDArray):
                data = data.asnumpy()
            self._data.append(data)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Each record of a ``.rec`` file, as bytes, by position in its
    ``.idx`` file (reference: ``gluon.data.RecordFileDataset``). Built on
    ``recordio.MXIndexedRecordIO``, as the reference is (the JAX class
    names an ``IndexedRecordIO`` its ``recordio`` lacks)."""

    def __init__(self, filename: str):
        self._reader = _RecordReader(filename)

    def __len__(self):
        return len(self._reader.keys)

    def __getitem__(self, idx):
        return self._reader.read(idx)


class _RecordReader:
    """Reads a ``.rec`` file's records by position in its ``.idx`` file. A
    seek and its read hold a lock (a thread-pool ``DataLoader`` reads from
    several threads), and a forked process opens its own handle: after a
    fork the two would share one file offset."""

    def __init__(self, filename: str):
        self._filename = filename
        self._idx_file = filename[: filename.rfind(".")] + ".idx"
        self._pid = None
        self._open()
        self.keys = self._record.keys

    def _open(self):
        from ... import recordio
        self._record = recordio.MXIndexedRecordIO(self._idx_file,
                                                  self._filename, "r")
        self._lock = threading.Lock()
        self._pid = os.getpid()

    def read(self, idx) -> bytes:
        if self._pid != os.getpid():
            self._open()
        with self._lock:
            return self._record.read_idx(self.keys[idx])
