"""``DataLoader`` with worker processes or threads (JAX counterpart:
``gluon/data/dataloader.py``; reference: ``python/mxnet/gluon/data/
dataloader.py``).

``num_workers > 0`` forks a ``multiprocessing`` pool when the loader is
made, as the JAX package does. A worker builds each batch on numpy and
writes its arrays into named POSIX shared memory (``native.ShmSegment``);
only ``(name, shape, dtype)`` crosses the pipe, and the consumer attaches,
copies out and unlinks. Without the native library, or with
``MXTPU_DATALOADER_SHM=0``, batches travel pickled through the pipe.

A forked worker must never touch CUDA (the parent has usually made its
CUDA context, and a child's first CUDA call raises): datasets, transforms
and the worker-side batchify stay on numpy, and no worker makes a tensor.
Batches become ``NDArray``\\ s in the consumer only, on the context
current where ``iter()`` was called; with ``pin_memory=True`` on a card
they are copied into pinned memory and sent with ``non_blocking=True``
(on the current stream: ``io.PrefetchIter`` gives them its own).

Forked workers share the parent's numpy random state at fork time, so
random transforms draw the same sequence in every worker, as in the JAX
package and MXNet 1.x.

A pass's batch order is drawn when ``iter()`` is called, on the calling
thread (numpy's global stream for a shuffle), so a seed set just before
it fixes the pass. At most ``prefetch`` batches (default ``2 *
num_workers``) are in flight.
A worker that dies (a ``SIGBUS`` from a full ``/dev/shm``, say) raises
:class:`MXNetError` at the next batch, as does a batch not ready within
``timeout`` seconds; a dataset's exception is re-raised in the consumer.
A consumer that abandons an iterator (``break``, an exception, dropping
it) makes it wait for the batches in flight and unlink their segments.
"""
from __future__ import annotations

import collections
import multiprocessing
import os
import queue as queue_mod
import threading
import time
import uuid
import weakref
from typing import Callable, Optional

import numpy as onp
import torch

from ...base import MXNetError
from ...context import current_context
from ...ndarray import NDArray, array
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


# ---------------------------------------------------------------------------
# the shared-memory batch transport
# ---------------------------------------------------------------------------

def _shm_available() -> bool:
    if os.environ.get("MXTPU_DATALOADER_SHM", "1") == "0":
        return False
    from ... import native
    return native.available()


_SHM_TAG = "__mxtpu_shm__"
#: numpy dtypes that an NDArray keeps (``nd.array`` narrows the others)
_KEPT = {onp.dtype(d) for d in ("float32", "float16", "uint8", "int8",
                                "int16", "int32", "bool")}


def _to_shm(tree):
    """Worker side: each array into a named segment, which the consumer
    unlinks; the pipe carries descriptors."""
    from ...native import ShmSegment
    if isinstance(tree, (list, tuple)):
        return [_to_shm(t) for t in tree]
    if isinstance(tree, onp.ndarray) and tree.nbytes > 0:
        arr = onp.ascontiguousarray(tree)
        name = f"/mxtpu_dl_{os.getpid()}_{uuid.uuid4().hex[:12]}"
        seg = ShmSegment(name, arr.nbytes, create=True)
        seg.as_numpy(arr.shape, arr.dtype)[...] = arr
        seg.close(unlink=False)
        return (_SHM_TAG, name, arr.shape, str(arr.dtype))
    return tree


def _is_shm_desc(tree) -> bool:
    return (isinstance(tree, (list, tuple)) and len(tree) == 4
            and isinstance(tree[0], str) and tree[0] == _SHM_TAG)


def _from_shm(tree, pin: bool = False):
    """Consumer side: attach, copy out (into pinned memory when ``pin``
    and the dtype is one an NDArray keeps), unlink."""
    from ...native import ShmSegment
    if _is_shm_desc(tree):
        _, name, shape, dtype = tree
        dtype = onp.dtype(dtype)
        n = max(1, int(onp.prod(shape))) * dtype.itemsize
        seg = ShmSegment(name, n, create=False)
        try:
            view = seg.as_numpy(shape, dtype)
            if pin and dtype in _KEPT:
                return torch.from_numpy(view).pin_memory()
            return onp.array(view)
        finally:
            seg.close(unlink=True)
    if isinstance(tree, (list, tuple)):
        return [_from_shm(t, pin) for t in tree]
    return tree


def _unlink_shm(tree) -> None:
    """Unlink a descriptor tree's segments unread (batches the consumer
    abandoned: a named segment outlives its processes)."""
    from ...native import ShmSegment
    if _is_shm_desc(tree):
        _, name, shape, dtype = tree
        n = max(1, int(onp.prod(shape))) * onp.dtype(dtype).itemsize
        try:
            ShmSegment(name, n, create=False).close(unlink=True)
        except MXNetError:
            pass        # already gone
        return
    if isinstance(tree, (list, tuple)):
        for t in tree:
            _unlink_shm(t)


# ---------------------------------------------------------------------------
# batchify
# ---------------------------------------------------------------------------

def default_batchify_fn(data):
    """Stack samples into a batch of NDArrays on the current context
    (reference: ``default_batchify_fn``); tuples batch per field."""
    if isinstance(data[0], NDArray):
        return array(onp.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    return array(onp.asarray(data))


def _numpy_batchify(data):
    """Worker-side batchify: numpy only (no tensor crosses a process)."""
    if isinstance(data[0], tuple):
        return [_numpy_batchify(d) for d in zip(*data)]
    if isinstance(data[0], NDArray):
        return onp.stack([d.asnumpy() for d in data])
    return onp.asarray(data)


default_mp_batchify_fn = _numpy_batchify


def _as_nd(batch, ctx, pin: bool):
    """Host batch -> NDArrays on ``ctx``; with ``pin``, through pinned
    memory and a ``non_blocking`` copy. PyTorch's pinned-memory cache
    keeps a pinned buffer from reuse until the copy reading it is done."""
    if isinstance(batch, (list, tuple)):
        return [_as_nd(b, ctx, pin) for b in batch]
    if isinstance(batch, torch.Tensor):       # pinned by _from_shm
        return NDArray(batch.to(ctx.torch_device, non_blocking=True))
    if isinstance(batch, onp.ndarray):
        if pin and batch.dtype in _KEPT:
            t = torch.from_numpy(onp.ascontiguousarray(batch)).pin_memory()
            return NDArray(t.to(ctx.torch_device, non_blocking=True))
        return array(batch, ctx=ctx)
    return batch


_worker_dataset = None


def _worker_init(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _worker_fn(samples, batchify_fn, use_shm=False):
    batch = batchify_fn([_worker_dataset[i] for i in samples])
    return _to_shm(batch) if use_shm else batch


_END = object()


class DataLoader:
    """Mini-batches of a :class:`Dataset`, shuffled or not, built on
    ``num_workers`` forked processes (``thread_pool=True``: threads), or
    on one background thread when ``num_workers`` is 0 (module
    docstring)."""

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 last_batch: Optional[str] = None,
                 batch_sampler: Optional[Sampler] = None,
                 batchify_fn: Optional[Callable] = None,
                 num_workers: int = 0, pin_memory: bool = False,
                 prefetch: Optional[int] = None, thread_pool: bool = False,
                 timeout: int = 120):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self.batch_size = batch_size
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers or 2)
        self._thread_pool = thread_pool
        self._batchify_fn = batchify_fn if batchify_fn is not None \
            else _numpy_batchify
        self._pool = None
        self._procs = []
        #: live multi-worker passes, closed (segments freed) before the
        #: pool stops
        self._passes = weakref.WeakSet()
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool
                self._pool = ThreadPool(self._num_workers)
            else:
                ctx = multiprocessing.get_context("fork")
                self._pool = ctx.Pool(
                    self._num_workers, initializer=_worker_init,
                    initargs=(self._dataset,))
                # the pool replaces a dead worker silently; these are the
                # ones it started with, and none of them exits on its own
                self._procs = list(self._pool._pool)

    def __len__(self):
        return len(self._batch_sampler)

    def __iter__(self):
        """One pass. Its batches' order is drawn here, on the calling
        thread, from the sampler (numpy's global stream for a shuffle),
        so a seed set just before ``iter()`` fixes the pass, whichever
        thread then builds its batches."""
        ctx = current_context()
        pin = self._pin_memory and ctx.device_type == "gpu"
        batches = list(self._batch_sampler)
        if self._pool is not None:
            it = self._multi_worker_iter(batches, ctx, pin)
            self._passes.add(it)
            return it
        return self._prefetch_iter(batches, ctx, pin)

    def _load(self, samples):
        return self._batchify_fn([self._dataset[i] for i in samples])

    def _prefetch_iter(self, batches, ctx, pin):
        """Batches built on one background thread, ``prefetch`` ahead; its
        exception is re-raised here."""
        q: "queue_mod.Queue" = queue_mod.Queue(self._prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                for samples in batches:
                    if not put((True, self._load(samples))):
                        return
                tail = _END
            except BaseException as e:  # noqa: BLE001  re-raised by the consumer
                tail = (False, e)
            put(tail)

        t = threading.Thread(target=producer,
                             name="mx-dataloader-prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                ok, value = item
                if not ok:
                    raise value
                yield _as_nd(value, ctx, pin)
        finally:
            stop.set()

    def _get(self, result):
        """A dispatched batch; raises when a worker died or ``timeout``
        passed."""
        if not self._procs:
            try:
                return result.get(self._timeout)
            except multiprocessing.TimeoutError:
                raise MXNetError(f"DataLoader: no batch within "
                                 f"{self._timeout} s") from None
        deadline = time.monotonic() + self._timeout
        while True:
            try:
                return result.get(0.05)
            except multiprocessing.TimeoutError:
                pass
            dead = [p for p in self._procs if p.exitcode is not None]
            if dead:
                codes = ", ".join(f"pid {p.pid} exit code {p.exitcode}"
                                  for p in dead)
                raise MXNetError(
                    f"DataLoader worker died ({codes}); a SIGBUS (-7) "
                    "usually means /dev/shm is full: fewer workers or a "
                    "smaller prefetch")
            if time.monotonic() > deadline:
                raise MXNetError(f"DataLoader: no batch within "
                                 f"{self._timeout} s")

    def _multi_worker_iter(self, batches, ctx, pin):
        use_shm = not self._thread_pool and _shm_available()
        samplers = iter(batches)
        pending = collections.deque()

        def dispatch() -> bool:
            samples = next(samplers, None)
            if samples is None:
                return False
            if self._thread_pool:
                pending.append(self._pool.apply_async(self._load,
                                                      (samples,)))
            else:
                pending.append(self._pool.apply_async(
                    _worker_fn, (samples, self._batchify_fn, use_shm)))
            return True

        try:
            while len(pending) < max(1, self._prefetch) and dispatch():
                pass
            while pending:
                batch = self._get(pending.popleft())
                if use_shm:
                    batch = _from_shm(batch, pin)
                dispatch()
                yield _as_nd(batch, ctx, pin)
        finally:
            self._drain(pending, use_shm)

    def _drain(self, pending, use_shm: bool) -> None:
        """An abandoned pass: wait for the batches in flight and free
        their segments, so no worker is left writing a batch (a pool
        stopped while a worker writes a large result into its pipe can
        deadlock) and no segment outlives the pass. A batch lost with a
        dead worker is waited for one second."""
        for r in pending:
            dead = any(p.exitcode is not None for p in self._procs)
            r.wait(1.0 if dead else self._timeout)
            if not r.ready():
                continue
            try:
                batch = r.get(0)
            except Exception:  # noqa: BLE001  the batch failed: nothing to free
                continue
            if use_shm:
                _unlink_shm(batch)
        pending.clear()

    def close(self) -> None:
        """Close the passes still open (their batches in flight are
        awaited and their segments unlinked), then stop the worker pool
        (idempotent)."""
        for it in list(self._passes):
            try:
                it.close()
            except ValueError:
                pass          # running in another thread: it cleans up
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  a finalizer must not raise
            pass
