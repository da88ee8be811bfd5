"""DynamicBatcher: deadline-bounded request coalescing.

Counterpart: the JAX package's ``serve/batcher.py`` (``stack_examples``
``:63``, ``ServeFuture`` ``:100``, ``DynamicBatcher`` ``:151-470``,
``make_registry_batcher`` ``:51``).
``submit(*arrays)`` enqueues one example without the batch dim and returns
a :class:`ServeFuture`; a worker thread flushes when the batch reaches the
largest batch bucket (or ``max_batch``) or when the oldest request has
waited ``max_delay_ms``. A flush stacks the requests, pads their bucketed
axes to the batch maximum, runs :meth:`CompiledModel.predict` and routes
row ``i`` of every output, sliced to the request's own sizes, to request
``i``'s future as numpy arrays (JAX ``:440``). The telemetry events and
trace spans of the JAX batcher come with the ``telemetry/`` port.

Env knobs (read at construction): ``MXTPU_SERVE_DEADLINE_MS`` (5 ms),
``MXTPU_SERVE_QUEUE_LIMIT`` (1024), ``MXTPU_SERVE_MAX_BATCH`` (0 = the
table's largest batch bucket).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as onp

from ..base import MXNetError
from ..util import getenv
from .compiled import CompiledModel, _as_numpy
from .metrics import ServeMetrics

__all__ = ["DynamicBatcher", "ServeFuture", "QueueFullError",
           "stack_examples", "make_registry_batcher"]


def make_registry_batcher(registry, name: str, **batcher_kw
                          ) -> "DynamicBatcher":
    """One started batcher for model ``name`` whose thunk resolves through
    ``registry`` at flush time, so a version swap redirects the very next
    batch: the shared creation path of ``Server.batcher`` and
    ``Replica._batcher`` (JAX counterpart: ``serve/batcher.py:51``). An
    unknown model raises here (the constructor resolves the thunk once for
    the model's signature)."""
    return DynamicBatcher(lambda: registry.get(name),
                          metrics=ServeMetrics(model=name),
                          **batcher_kw).start()


def stack_examples(model: CompiledModel,
                   examples_per_request: Sequence[Sequence[onp.ndarray]]
                   ) -> List[onp.ndarray]:
    """Stack per-request examples (no batch dim) along a new batch axis,
    padding each request's bucketed non-batch axes to the batch maximum
    with the model's pad values (JAX counterpart:
    ``serve/batcher.py:63``)."""
    stacked = []
    for i in range(model._n_in):
        spec = model._input_axes[i]
        pv = model._pad_values[i]
        dtype = model._in_avals[i][1]
        examples = [onp.asarray(req[i]) for req in examples_per_request]
        # non-batch bucketed axes in EXAMPLE coordinates (the request lacks
        # the batch dim, so model axis k > batch axis is example axis k-1)
        batch_axis = min(spec) if spec else 0
        var_axes = [a - (1 if a > batch_axis else 0)
                    for a in spec if a != batch_axis]
        if var_axes:
            maxes = {a: max(e.shape[a] for e in examples) for a in var_axes}
            padded = []
            for e in examples:
                widths = [(0, maxes.get(ax, e.shape[ax]) - e.shape[ax])
                          for ax in range(e.ndim)]
                padded.append(onp.pad(e, widths, mode="constant",
                                      constant_values=pv))
            examples = padded
        stacked.append(onp.stack(examples).astype(dtype, copy=False))
    return stacked


class QueueFullError(MXNetError):
    """The bounded request queue is full: backpressure; retry later or
    raise ``MXTPU_SERVE_QUEUE_LIMIT`` (JAX counterpart:
    ``serve/batcher.py:95``)."""


class ServeFuture:
    """Result handle for one submitted request (JAX counterpart:
    ``serve/batcher.py:100``)."""

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def set_result(self, result) -> None:
        self._result = result
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the result or exception lands (or ``timeout``);
        returns whether it did: the router's non-raising poll."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request still queued/in flight")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("arrays", "future", "t_enqueue")

    def __init__(self, arrays):
        self.arrays = arrays
        self.future = ServeFuture()
        self.t_enqueue = time.perf_counter()


class DynamicBatcher:
    """Coalesce single requests into bucket-sized batches for ``model``, a
    :class:`CompiledModel` or a zero-argument callable returning one (JAX
    counterpart: ``serve/batcher.py:151``). Requests are single examples
    WITHOUT the batch dim; their bucketed non-batch axes may differ."""

    def __init__(self, model, max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 block_secs: float = 0.0,
                 metrics: Optional[ServeMetrics] = None):
        self._model_thunk: Callable[[], CompiledModel] = (
            model if callable(model) and not isinstance(model, CompiledModel)
            else (lambda: model))
        m = self._model_thunk()
        self._batch_axis_name = m._primary_axis
        largest = m._table.sizes(self._batch_axis_name)[-1]
        if max_batch is None:
            max_batch = int(getenv("MXTPU_SERVE_MAX_BATCH"))
        # 0 = "the table's largest bucket" on both the env and param paths
        self.max_batch = min(int(max_batch) or largest, largest)
        self.max_delay_ms = float(
            getenv("MXTPU_SERVE_DEADLINE_MS")
            if max_delay_ms is None else max_delay_ms)
        self.queue_limit = int(
            getenv("MXTPU_SERVE_QUEUE_LIMIT")
            if queue_limit is None else queue_limit)
        self.block_secs = float(block_secs)
        self.metrics = metrics or ServeMetrics()
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._closed = False
        self._worker: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "DynamicBatcher":
        if self._worker is None or not self._worker.is_alive():
            self._stop = False
            self._closed = False
            self._worker = threading.Thread(target=self._run,
                                            name="mx-serve-batcher",
                                            daemon=True)
            self._worker.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop the worker; ``drain=True`` serves what is queued first.
        Whatever is still queued afterwards fails with "batcher stopped",
        and later submits are rejected (JAX counterpart:
        ``serve/batcher.py:206``)."""
        t0 = time.monotonic()
        self._closed = True  # reject new submits from this point on
        if self._worker is not None:
            if drain:
                while self.depth() and time.monotonic() - t0 < timeout:
                    time.sleep(0.005)
            self._stop = True
            self._wake.set()
            self._worker.join(timeout)
        with self._lock:  # closed above: nothing can enqueue after this
            leftovers = list(self._queue)
            self._queue.clear()
        for req in leftovers:
            req.future.set_exception(MXNetError("batcher stopped"))

    def worker_alive(self) -> bool:
        """True while the flush worker runs: the liveness bit a replica's
        heartbeat reports."""
        w = self._worker
        return w is not None and w.is_alive()

    def retry_after_s(self) -> float:
        """Backoff hint for a rejected or timed-out request: about the time
        the queue takes to drain at one deadline flush per batch."""
        batches = max(1, (self.depth() + self.max_batch - 1)
                      // self.max_batch)
        return round(max(0.05, batches * self.max_delay_ms / 1e3), 3)

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- client side ----------------------------------------------------
    def submit(self, *arrays) -> ServeFuture:
        """Enqueue one single-example request and return its future.
        Malformed requests (wrong input count, rank, fixed dims, or a
        bucketed dim beyond the table) are rejected here, before they can
        fail the requests they would be batched with. Raises
        :class:`QueueFullError` when the queue is full after ``block_secs``
        (JAX counterpart: ``serve/batcher.py:258``)."""
        model = self._model_thunk()
        if len(arrays) != model._n_in:
            raise MXNetError(
                f"request has {len(arrays)} inputs, model "
                f"takes {model._n_in}")
        req = _Request([_as_numpy(a) for a in arrays])
        for i, (a, (shape, _d)) in enumerate(
                zip(req.arrays, model._in_avals)):
            if a.ndim != len(shape) - 1:
                raise MXNetError(
                    f"request example has rank {a.ndim}; expected rank "
                    f"{len(shape) - 1} (the model input is {shape} with "
                    "the batch dim supplied by the batcher)")
            spec = model._input_axes[i]
            batch_axis = min(spec) if spec else 0
            ex_names = {ax - (1 if ax > batch_axis else 0): name
                        for ax, name in spec.items() if ax != batch_axis}
            ex_shape = tuple(s for k, s in enumerate(shape)
                             if k != batch_axis)
            for ex_ax, size in enumerate(a.shape):
                name = ex_names.get(ex_ax)
                if name is None:
                    if size != ex_shape[ex_ax]:
                        raise MXNetError(
                            f"request input {i} has size {size} on axis "
                            f"{ex_ax}; the model expects {ex_shape[ex_ax]} "
                            "(only bucketed axes may vary per request)")
                else:
                    model._table.bucket(name, size)  # raises on overflow
        deadline = time.time() + self.block_secs
        while True:
            with self._lock:
                if self._closed:
                    raise MXNetError("batcher stopped; submit rejected")
                if len(self._queue) < self.queue_limit:
                    self._queue.append(req)
                    self.metrics.record_depth(len(self._queue))
                    break
            if time.time() >= deadline:
                self.metrics.record_rejection()
                raise QueueFullError(
                    f"serve queue is full ({self.queue_limit} requests); "
                    "backpressure — retry with backoff or raise "
                    "MXTPU_SERVE_QUEUE_LIMIT")
            time.sleep(0.0005)
        self._wake.set()
        return req.future

    # -- worker side ----------------------------------------------------
    def _run(self) -> None:
        while not self._stop:
            batch = self._gather()
            if batch:
                self._flush(batch)
                continue
            with self._lock:
                if self._queue:
                    remaining = (self.max_delay_ms / 1e3
                                 - (time.perf_counter()
                                    - self._queue[0].t_enqueue))
                else:
                    remaining = None  # idle: sleep until a submit wakes us
            self._wake.wait(timeout=max(remaining, 0.0005)
                            if remaining is not None else None)
            self._wake.clear()

    def _gather(self) -> List[_Request]:
        """A full bucket immediately, or whatever is queued once the oldest
        request's deadline has passed (JAX counterpart:
        ``serve/batcher.py:355``)."""
        with self._lock:
            n = len(self._queue)
            if n == 0:
                return []
            oldest_wait_ms = (time.perf_counter()
                              - self._queue[0].t_enqueue) * 1e3
            if n < self.max_batch and oldest_wait_ms < self.max_delay_ms:
                return []
            take = min(n, self.max_batch)
            batch = [self._queue.popleft() for _ in range(take)]
            self.metrics.record_depth(len(self._queue))
            return batch

    def _flush(self, batch: List[_Request]) -> None:
        """Run one batch and resolve its futures (JAX counterpart:
        ``serve/batcher.py:371``)."""
        t0 = time.perf_counter()
        try:
            # resolve the model inside the try: a failed resolve must fail
            # THESE futures, not kill the worker and hang later submits
            model = self._model_thunk()
            stacked = stack_examples(model, [req.arrays for req in batch])
            outs = model.predict(*stacked)
            self._scatter(batch, outs, model)
        except Exception as e:  # noqa: BLE001 — routed to the futures
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            # failed batches must NOT count as served traffic
            self.metrics.record_failed_batch(len(batch))
            return
        dt_ms = (time.perf_counter() - t0) * 1e3
        bucket = model._table.bucket(self._batch_axis_name, len(batch))
        self.metrics.record_batch(len(batch), bucket, dt_ms)
        for req in batch:
            self.metrics.record_request(
                (time.perf_counter() - req.t_enqueue) * 1e3)

    def _scatter(self, batch: List[_Request], outs, model: CompiledModel
                 ) -> None:
        """Route row ``i`` of every output to request ``i``, sliced to that
        request's own sizes on its bucketed axes (JAX counterpart:
        ``serve/batcher.py:431``)."""
        multi = isinstance(outs, tuple)
        flat = list(outs) if multi else [outs]
        out_axes = model._output_axes
        if out_axes is None:
            out_axes = [{0: model._primary_axis}] * len(flat)
        host = [o.asnumpy() for o in flat]  # one device->host copy each
        for i, req in enumerate(batch):
            picks = []
            for o, spec in zip(host, out_axes):
                row = o[i]
                for axis, name in spec.items():
                    if axis == 0:
                        continue
                    true = self._request_size(req, model, name)
                    if true is not None and axis - 1 < row.ndim \
                            and row.shape[axis - 1] > true:
                        sl = [slice(None)] * row.ndim
                        sl[axis - 1] = slice(0, true)
                        row = row[tuple(sl)]
                picks.append(row)
            req.future.set_result(tuple(picks) if multi else picks[0])

    @staticmethod
    def _request_size(req: _Request, model: CompiledModel,
                      name: str) -> Optional[int]:
        for a, spec in zip(req.arrays, model._input_axes):
            batch_axis = min(spec) if spec else 0
            for axis, nm in spec.items():
                if nm == name and axis != batch_axis:
                    ex_axis = axis - (1 if axis > batch_axis else 0)
                    if ex_axis < a.ndim:
                        return a.shape[ex_axis]
        return None
