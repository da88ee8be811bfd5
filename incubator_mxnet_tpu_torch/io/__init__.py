"""``mx.io``: data iterators (JAX counterpart: ``io/__init__.py``, which
imports no JAX; the port keeps its own copy).

``DataDesc``, ``DataBatch``, the ``DataIter`` base and ``NDArrayIter``:
batches sliced on the host from numpy copies of the data, with
``shuffle`` (numpy's global stream, as in the reference) and
``last_batch_handle`` ``"pad"`` (the last batch wraps around to full size
and reports its ``pad``), ``"discard"`` or ``"roll_over"`` (the partial
last batch's rows start the next epoch). Each batch's arrays are ``mx.nd``
arrays on the current context. ``CSVIter``, ``LibSVMIter`` and
``MNISTIter`` read their files into an ``NDArrayIter``.
``ImageRecordIter`` decodes and augments a ``.rec`` file with ``cv2`` on
a thread pool; its random draws are made in record order on one thread,
so any number of threads gives the batches of one.

``PrefetchingIter`` and ``PrefetchIter`` run the wrapped iterator on a
named daemon thread, under the context current where they were made.
``PrefetchIter`` also runs ``place`` there (typically
``ShardedTrainer.place``) and shards the stream across hosts. On a
machine with a card, the worker issues the wrapped iterator's and
``place``'s device work on a CUDA stream of its own and records an event
after each batch; :meth:`PrefetchIter.next` makes the consumer's current
stream wait on that event and marks every tensor of the batch as used on
that stream (``record_stream``), so the copies overlap the step that
consumes the previous batch, and no batch's memory is reused while the
step still reads it. The JAX iterator's telemetry (``mxtpu_io_wait_ms``,
``mxtpu_io_queue_depth``, the goodput ledger's ``input_wait``) is not
ported yet.
"""
from __future__ import annotations

import os
import queue as _queue
import struct
import threading
from collections import namedtuple
from typing import Dict, Optional, Tuple

import numpy as onp
import torch

from .. import recordio as rec_mod
from ..base import MXNetError
from ..context import current_context
from ..fault import inject as _inject
from ..ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "MNISTIter", "ImageRecordIter", "PrefetchingIter",
           "PrefetchIter", "ResizeIter"]


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


class CSVIter(NDArrayIter):
    """CSV-backed iterator (JAX counterpart: ``io/__init__.py:185``;
    reference: ``src/io/iter_csv.cc``)."""

    def __init__(self, data_csv: str, data_shape: Tuple[int, ...],
                 label_csv: Optional[str] = None,
                 label_shape: Tuple[int, ...] = (1,),
                 batch_size: int = 1, **kwargs):
        data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv:
            label = onp.loadtxt(label_csv, delimiter=",", dtype=onp.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size=batch_size, **kwargs)


class LibSVMIter(NDArrayIter):
    """LibSVM-format iterator (JAX counterpart: ``io/__init__.py:200``;
    reference: ``src/io/iter_libsvm.cc``): ``label idx:val ...`` lines,
    the features dense ``(n, *data_shape)`` float32, as in the JAX
    package (the reference yields CSR batches)."""

    def __init__(self, data_libsvm: str, data_shape: Tuple[int, ...],
                 label_libsvm: Optional[str] = None,
                 label_shape: Tuple[int, ...] = (1,),
                 batch_size: int = 1, **kwargs):
        feat_dim = int(onp.prod(data_shape))
        labels, rows, cols, vals = [], [], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    idx, val = tok.split(":")
                    rows.append(len(labels) - 1)
                    cols.append(int(idx))
                    vals.append(float(val))
        n = len(labels)
        data = onp.zeros((n, feat_dim), dtype=onp.float32)
        if rows:
            if max(cols) >= feat_dim or min(cols) < 0:
                raise MXNetError(
                    f"libsvm feature index out of range [0, {feat_dim}): "
                    f"[{min(cols)}, {max(cols)}]")
            data[rows, cols] = vals
        data = data.reshape((-1,) + tuple(data_shape))
        if label_libsvm:
            lab = []
            with open(label_libsvm) as f:
                for line in f:
                    if line.split():
                        lab.append([float(x) for x in line.split()])
            label = onp.asarray(lab, dtype=onp.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = onp.asarray(labels, dtype=onp.float32)
        super().__init__(data, label, batch_size=batch_size, **kwargs)


class MNISTIter(NDArrayIter):
    """idx-format MNIST reader (JAX counterpart: ``io/__init__.py:245``;
    reference: ``src/io/iter_mnist.cc``): images scaled to [0, 1],
    ``(n, 1, 28, 28)`` or flat."""

    def __init__(self, image: str, label: str, batch_size: int = 128,
                 shuffle: bool = False, flat: bool = False, **kwargs):
        imgs = _read_idx_images(image)
        labs = _read_idx_labels(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, 28, 28)
        super().__init__(imgs.astype(onp.float32) / 255.0,
                         labs.astype(onp.float32),
                         batch_size=batch_size, shuffle=shuffle,
                         label_name="softmax_label", **kwargs)


def _idx_open(path: str):
    import gzip
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx_images(path: str) -> onp.ndarray:
    with _idx_open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError(f"{path} is not an MNIST image idx file")
        return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(n, rows, cols)


def _read_idx_labels(path: str) -> onp.ndarray:
    with _idx_open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError(f"{path} is not an MNIST label idx file")
        return onp.frombuffer(f.read(), dtype=onp.uint8)


class ImageRecordIter(DataIter):
    """A ``.rec`` image pipeline with threaded decode and augmentation
    (JAX counterpart: ``io/__init__.py:285``; reference:
    ``src/io/iter_image_recordio_2.cc``): ``resize`` (short side),
    ``rand_crop`` (else a center crop), ``rand_mirror``, ``data_shape``,
    ``mean_r/g/b``, ``std_r/g/b``, ``shuffle``; full batches only.

    The draws come from ``RandomState(seed)`` in the JAX iterator's order
    (the shuffle at each reset; per record, in batch order, the crop's
    row and column where the image is larger, then the mirror). The JAX
    iterator draws them from its decode threads, so with more than one
    thread its order depends on which thread runs first; the port decodes
    on ``preprocess_threads`` threads, draws on the calling thread in
    record order, then crops and normalises on the threads again: its
    batches equal the JAX iterator's with one thread, whatever the
    number of threads."""

    def __init__(self, path_imgrec: str, data_shape: Tuple[int, int, int],
                 batch_size: int, path_imgidx: Optional[str] = None,
                 shuffle: bool = False, rand_crop: bool = False,
                 rand_mirror: bool = False, resize: int = -1,
                 mean_r: float = 0.0, mean_g: float = 0.0, mean_b: float = 0.0,
                 std_r: float = 1.0, std_g: float = 1.0, std_b: float = 1.0,
                 preprocess_threads: int = 4, round_batch: bool = True,
                 seed: int = 0, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        self._mean = onp.array([mean_r, mean_g, mean_b], onp.float32)
        self._std = onp.array([std_r, std_g, std_b], onp.float32)
        self._rng = onp.random.RandomState(seed)
        self._shuffle = shuffle
        self._threads = max(1, preprocess_threads)
        self._pool = None
        # the record offsets once; records decode lazily per batch
        idx = path_imgidx or (path_imgrec[:-4] + ".idx")
        if os.path.isfile(idx):
            self._rec = rec_mod.MXIndexedRecordIO(idx, path_imgrec, "r")
            self._keys = list(self._rec.keys)
        else:
            self._rec = rec_mod.MXRecordIO(path_imgrec, "r")
            self._keys = None
            self._records = []
            while True:
                r = self._rec.read()
                if r is None:
                    break
                self._records.append(r)
        self._order = None
        self._pos = 0
        self.reset()

    def reset(self):
        n = len(self._keys) if self._keys is not None else len(self._records)
        self._order = onp.arange(n)
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0

    def _fetch(self, i: int) -> bytes:
        if self._keys is not None:
            return self._rec.read_idx(self._keys[i])
        return self._records[i]

    def _decode(self, raw: bytes):
        """Decode and the short-side resize: no draw."""
        import cv2
        header, img = rec_mod.unpack_img(raw, iscolor=1)
        if self._resize > 0:
            h, w = img.shape[:2]
            scale = self._resize / min(h, w)
            img = cv2.resize(img, (int(w * scale + 0.5), int(h * scale + 0.5)))
        return header, img

    def _draw(self, img) -> tuple:
        """The crop's corner and the mirror, from the iterator's stream."""
        _, H, W = self.data_shape
        h, w = img.shape[:2]
        if self._rand_crop:
            # a random offset where the image is larger, 0 where it is
            # smaller (the resize in _finish fixes undersized dims)
            y = self._rng.randint(0, h - H + 1) if h > H else 0
            x = self._rng.randint(0, w - W + 1) if w > W else 0
        else:
            y, x = max(0, (h - H) // 2), max(0, (w - W) // 2)
        mirror = bool(self._rand_mirror and self._rng.rand() < 0.5)
        return y, x, mirror

    def _finish(self, item):
        import cv2
        (header, img), (y, x, mirror) = item
        _, H, W = self.data_shape
        img = img[y:y + H, x:x + W]
        if img.shape[:2] != (H, W):
            img = cv2.resize(img, (W, H))
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(onp.float32)
        if mirror:
            img = img[:, ::-1]
        img = (img - self._mean) / self._std
        label = header.label if onp.ndim(header.label) else float(header.label)
        return img.transpose(2, 0, 1), onp.float32(label)

    def _map(self, fn, items) -> list:
        if self._threads == 1:
            return [fn(i) for i in items]
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(self._threads,
                                            thread_name_prefix="mx-imgrec")
        return list(self._pool.map(fn, items))

    def iter_next(self) -> bool:
        return self._pos + self.batch_size <= len(self._order)

    def next(self) -> DataBatch:
        if not self.iter_next():
            raise StopIteration
        idxs = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        raws = [self._fetch(int(i)) for i in idxs]
        decoded = self._map(self._decode, raws)
        draws = [self._draw(img) for _, img in decoded]
        done = self._map(self._finish, list(zip(decoded, draws)))
        data = onp.stack([d for d, _ in done])
        label = onp.stack([lab for _, lab in done])
        return DataBatch([array(data)], [array(label)], pad=0)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one iterator (JAX counterpart:
    ``io/__init__.py:396``; reference: ``iter_prefetcher.h``); the thread
    runs under the context current at construction."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth: int = 2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter here wraps a single iterator")
        self._it = iters[0]
        super().__init__(self._it.batch_size)
        self._depth = prefetch_depth
        self._ctx = current_context()
        self._queue: _queue.Queue = _queue.Queue(maxsize=prefetch_depth)
        self._worker = None
        self._gen = 0
        self._start()

    def _start(self):
        gen = self._gen
        q = self._queue

        def run():
            # a stale generation (reset() bumped self._gen) stops touching
            # the shared iterator and exits without the sentinel
            done = False
            try:
                with self._ctx:
                    while gen == self._gen:
                        try:
                            b = self._it.next()
                        except StopIteration:
                            done = True
                            break
                        while gen == self._gen:
                            try:
                                q.put(b, timeout=0.05)
                                break
                            except _queue.Full:
                                continue
            finally:
                if done and gen == self._gen:
                    q.put(None)

        self._worker = threading.Thread(target=run, name="mx-io-prefetch",
                                        daemon=True)
        self._worker.start()

    def reset(self):
        self._gen += 1
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._worker is not None:
            self._worker.join(timeout=5)
        self._it.reset()
        self._queue = _queue.Queue(maxsize=self._depth)
        self._start()

    def next(self) -> DataBatch:
        b = self._queue.get()
        if b is None:
            raise StopIteration
        return b

    def iter_next(self) -> bool:
        raise MXNetError("PrefetchingIter supports iteration via next() only")

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label


class _IterableIter:
    """``next``/``reset`` over a plain iterable (a ``gluon.data.DataLoader``):
    each reset starts a new pass with ``iter()``, on the calling thread."""

    def __init__(self, iterable):
        self._src = iterable
        self.batch_size = getattr(iterable, "batch_size", None) or 0
        self._iter = iter(iterable)

    def next(self):
        return next(self._iter)

    def reset(self):
        self.close()
        self._iter = iter(self._src)

    def close(self):
        """End the current pass (a ``DataLoader`` pass frees its batches in
        flight)."""
        close = getattr(self._iter, "close", None)
        if close is not None:
            close()


def _tensors(tree):
    """Every tensor of a batch: tensors, NDArrays, ``DataBatch``, and
    tuples, lists and dicts of them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, NDArray):
        yield tree._data
    elif isinstance(tree, DataBatch):
        for part in (tree.data, tree.label):
            yield from _tensors(part or [])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class PrefetchIter(DataIter):
    """Asynchronous device prefetch over a :class:`DataIter` or any
    iterable, such as a ``gluon.data.DataLoader`` (JAX counterpart:
    ``io/__init__.py:474``).

    A worker thread (``mx-io-device-prefetch``, a daemon) pulls batch
    ``N+1`` (and ``N+2``, with the default ``depth=2``) and runs ``place``
    on it while the step consumes batch ``N``::

        it = mx.io.PrefetchIter(loader, place=lambda b: trainer.place(*b))
        for placed in it:
            trainer.step(*placed)

    ``place`` takes the wrapped iterator's batch and may return anything
    (default: the batch as it is). Batches arrive strictly in the wrapped
    iterator's order. An exception of the wrapped iterator or of
    ``place`` is kept on the worker and re-raised by :meth:`next`, never
    swallowed. The worker runs under the context current at construction,
    and, on a machine with a card, its device work runs on a CUDA stream
    of this iterator (module docstring): :meth:`next` orders the
    consumer's current stream after the batch's copies and records the
    batch's tensors on it. Making the stream or the event raises; nothing
    drops to synchronous copies. The chaos site ``slow_input``
    (``fault.inject``) delays the worker before each pull.

    **Host sharding**: :meth:`shard` keeps host ``process_index``'s
    round-robin share (global batch ``g`` belongs to it iff ``g %
    process_count == process_index``); the worker consumes every batch but
    delivers (and places) only this host's. :meth:`shard_state` returns
    the pod-wide consumed-through cursor, which a trainer banks in its
    checkpoint's meta (``data_state``), and :meth:`restore_shard`
    restarts the wrapped iterator and skips past that cursor, under the
    same or a new membership: no batch replayed, none dropped.
    :meth:`close` (or leaving a ``with``) stops and joins the worker;
    :meth:`reset` restarts the stream from the wrapped iterator's top.
    """

    _DONE = object()

    def __init__(self, data_iter, place=None, depth: int = 2):
        if depth < 1:
            raise MXNetError("PrefetchIter depth must be >= 1")
        if not hasattr(data_iter, "next") or not hasattr(data_iter, "reset"):
            data_iter = _IterableIter(data_iter)
        super().__init__(getattr(data_iter, "batch_size", 0))
        self._it = data_iter
        self._place = place
        self._depth = depth
        self._ctx = current_context()
        self._stream = self._device = None
        if torch.cuda.is_available():
            dev = self._ctx.torch_device
            self._device = dev if dev.type == "cuda" else torch.device(
                "cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=self._device)
        self._queue: _queue.Queue = _queue.Queue(maxsize=depth)
        self._worker: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._done = False           # stream ended (worker queued _DONE)
        self._gen = 0
        self._closed = False
        # the host-shard view (identity by default), written only while
        # the worker is stopped (shard/restore_shard/reset)
        self._shard_index = 0
        self._shard_count = 1
        self._shard_base = 0      # global index the round-robin starts at
        self._skip_to = 0         # globals below this are already consumed
        self._boundary = 0        # pod-wide consumed-through cursor
        self._start()

    def _pull(self, ours: bool):
        """The wrapped iterator's next batch, placed when ``ours``, and,
        with the iterator's stream, an event after its device work."""
        if self._stream is None:
            b = self._it.next()
            if ours and self._place is not None:
                b = self._place(b)
            return b, None
        with torch.cuda.stream(self._stream):
            b = self._it.next()
            if ours and self._place is not None:
                b = self._place(b)
            event = torch.cuda.Event()
            event.record(self._stream)
        return b, event

    def _start(self):
        gen = self._gen
        q = self._queue
        # the shard view, fixed while this worker runs; g counts batches
        # pulled since the wrapped iterator's reset: the GLOBAL index
        sh_index, sh_count = self._shard_index, self._shard_count
        sh_base, sh_skip = self._shard_base, self._skip_to

        def run():
            # a stale generation (reset()/close() bumped self._gen) stops
            # touching the shared iterator and exits without its sentinel
            tail = None
            g = 0
            try:
                with self._ctx:
                    while gen == self._gen:
                        _inject.maybe_delay("slow_input")
                        g_cur, g = g, g + 1
                        ours = g_cur >= sh_skip and (
                            sh_count == 1
                            or (g_cur - sh_base) % sh_count == sh_index)
                        try:
                            b, event = self._pull(ours)
                        except StopIteration:
                            tail = PrefetchIter._DONE
                            break
                        except BaseException as e:  # noqa: BLE001  re-raised by next()
                            self._exc = e
                            tail = PrefetchIter._DONE
                            break
                        if not ours:
                            # consumed, not delivered: below a restored
                            # boundary, or another host's batch
                            continue
                        while gen == self._gen:
                            try:
                                q.put((g_cur, b, event), timeout=0.05)
                                break
                            except _queue.Full:
                                continue
            finally:
                while tail is not None and gen == self._gen:
                    try:
                        q.put(tail, timeout=0.05)
                        break
                    except _queue.Full:
                        continue

        self._worker = threading.Thread(target=run,
                                        name="mx-io-device-prefetch",
                                        daemon=True)
        self._worker.start()

    def _stop_worker(self) -> bool:
        """Signal and join the worker; True when it exited."""
        self._gen += 1
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._worker is not None:
            self._worker.join(timeout=5)
            if self._worker.is_alive():
                return False
            self._worker = None
        return True

    def _restart(self, what: str) -> None:
        if self._closed:
            raise MXNetError("PrefetchIter is closed")
        if not self._stop_worker():
            # the old worker is blocked inside the wrapped iterator or
            # place(): a second one would drive the same iterator from
            # two threads
            raise MXNetError(
                "PrefetchIter worker did not stop within 5s (the wrapped "
                f"iterator or place() is blocked); cannot {what} safely")
        self._exc = None
        self._done = False
        self._it.reset()
        self._queue = _queue.Queue(maxsize=self._depth)
        self._start()

    def reset(self):
        """Restart from the wrapped iterator's top; the shard membership
        stays, a restored fast-forward does not."""
        self._shard_base = self._skip_to = self._boundary = 0
        self._restart("reset")

    @property
    def depth(self) -> int:
        """The prefetch queue's capacity."""
        return self._depth

    def set_depth(self, depth: int) -> int:
        """Resize the queue's bound live, with no restart and no batch
        dropped or replayed (the queue reads ``maxsize`` under its mutex at
        every put); returns the previous depth."""
        depth = int(depth)
        if depth < 1:
            raise MXNetError("PrefetchIter depth must be >= 1")
        if self._closed:
            raise MXNetError("PrefetchIter is closed")
        prev, q = self._depth, self._queue
        with q.mutex:
            q.maxsize = depth
            q.not_full.notify_all()
        self._depth = depth
        return prev

    def shard(self, process_index: int, process_count: int) -> "PrefetchIter":
        """Keep host ``process_index``'s round-robin share of the stream,
        restarted from the wrapped iterator's top; returns ``self``."""
        process_index, process_count = int(process_index), int(process_count)
        if process_count < 1 or not 0 <= process_index < process_count:
            raise MXNetError(
                f"invalid shard view ({process_index}, {process_count}): "
                "need 0 <= process_index < process_count")
        if self._closed:
            raise MXNetError("PrefetchIter is closed")
        self._shard_index = process_index
        self._shard_count = process_count
        self._shard_base = self._skip_to = self._boundary = 0
        self._restart("reshard")
        return self

    def shard_state(self) -> Dict[str, int]:
        """The checkpointable boundary: ``next_global`` is the pod-wide
        consumed-through cursor (hosts in lockstep have together consumed
        batches ``[0, next_global)``), with the membership and the batch
        size."""
        return {"next_global": self._boundary,
                "index": self._shard_index,
                "count": self._shard_count,
                "batch_size": int(self.batch_size)}

    def restore_shard(self, state: Dict[str, int],
                      index: Optional[int] = None,
                      count: Optional[int] = None) -> "PrefetchIter":
        """Resume from a :meth:`shard_state` under the saved membership or
        a new ``(index, count)``: the wrapped iterator restarts, the
        worker skips the ``next_global`` batches already consumed, and the
        round-robin restarts at that boundary; returns ``self``."""
        state = dict(state or {})
        idx = int(state.get("index", 0)) if index is None else int(index)
        n = int(state.get("count", 1)) if count is None else int(count)
        if n < 1 or not 0 <= idx < n:
            raise MXNetError(
                f"invalid shard view ({idx}, {n}): need 0 <= index < count")
        boundary = max(0, int(state.get("next_global", 0)))
        if self._closed:
            raise MXNetError("PrefetchIter is closed")
        self._shard_index = idx
        self._shard_count = n
        self._shard_base = self._skip_to = self._boundary = boundary
        self._restart("restore shard")
        return self

    def close(self):
        """Stop and join the worker (idempotent). Batches it read ahead are
        consumed from the wrapped iterator, as with any prefetcher; the
        pass of a wrapped iterable (a ``DataLoader``) is closed."""
        if self._closed:
            return
        self._closed = True
        if self._stop_worker() and isinstance(self._it, _IterableIter):
            self._it.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def next(self):
        if self._closed:
            raise MXNetError("PrefetchIter is closed")
        if self._done:
            # the worker queued its sentinel once and exited: keep raising
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        item = self._queue.get()
        if item is PrefetchIter._DONE:
            self._done = True
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        g, batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(batch):
                if t.is_cuda:
                    t.record_stream(stream)
        # consuming our batch of round r means the pod (in lockstep)
        # consumed every global through the end of that round
        r = (g - self._shard_base) // self._shard_count
        self._boundary = self._shard_base + (r + 1) * self._shard_count
        return batch

    def iter_next(self) -> bool:
        raise MXNetError("PrefetchIter supports iteration via next() only")

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label


class ResizeIter(DataIter):
    """Exactly ``size`` batches of a wrapped iterator, restarting it when
    it ends early (JAX counterpart: ``io/__init__.py:838``)."""

    def __init__(self, data_iter, size: int, reset_internal: bool = True):
        super().__init__(data_iter.batch_size)
        self._it = data_iter
        self._size = size
        self._reset_internal = reset_internal
        self._cur = 0

    def reset(self):
        self._cur = 0
        if self._reset_internal:
            self._it.reset()

    def next(self) -> DataBatch:
        if self._cur >= self._size:
            raise StopIteration
        self._cur += 1
        try:
            return self._it.next()
        except StopIteration:
            self._it.reset()
            return self._it.next()

    def iter_next(self) -> bool:
        return self._cur < self._size

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label
