"""DecodeBatcher: continuous batching at token boundaries.

Counterpart: the JAX package's ``serve/decode/batcher.py``
(``TokenStream``, ``DecodeBatcher``). The one-shot ``DynamicBatcher``
drains a whole batch before admitting the next; generation would make a
short reply wait for its longest neighbour. The decode batcher keeps ONE
fixed-shape decode batch running and lets requests join and leave between
steps:

- ``submit(prompt)`` enqueues and returns a :class:`TokenStream`: tokens
  arrive as they are generated, ``result()`` waits for the whole sequence;
- the worker thread ("mx-decode-batcher") runs one engine step per token
  boundary; before each step it admits queued requests into free batch
  rows while the block pool has seats, running their bucketed prefill;
  the next token of each row is the greedy ``argmax`` of its logits on
  the host (numpy's first index on ties);
- a sequence leaves the moment it emits EOS or reaches its token budget;
  its pages and its row free, and the next queued request takes them on
  the next boundary.

An admission that meets :class:`~.blocks.CacheExhausted` goes back to the
queue at most ``MXTPU_DECODE_MAX_REQUEUES`` times, then its stream fails
loudly; a full queue raises :class:`~..batcher.QueueFullError`. ``qos`` is
any object with ``try_take(tenant, tokens) -> bool`` (the router's
:class:`~..router.TokenRateBudget`), consulted before a request queues; a
refusal raises :class:`~..router.ShedError`. The chaos site
``decode_replica_death`` (JAX ``:433-437``, ``:516-534``) kills the
replica mid-generation at a token boundary: every active and queued stream
fails with :class:`~..replica.ReplicaUnavailable`, the cache is reset, and
the batcher serves the next request. The telemetry events, spans and the
death's flight bundle wait for the ``telemetry/`` port.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as onp

from ...base import MXNetError
from ...fault import inject
from ...util import getenv
from ..batcher import QueueFullError
from ..replica import ReplicaUnavailable
from ..router import ShedError
from .blocks import CacheExhausted
from .engine import DecodeEngine
from .metrics import DecodeMetrics

__all__ = ["DecodeBatcher", "TokenStream", "ShedError"]

_STREAM_IDS = itertools.count(1)


class TokenStream:
    """Streaming result handle: tokens land one by one, the whole sequence
    at :meth:`result`; ``done``/``wait``/``result``/``set_exception`` as
    :class:`~..batcher.ServeFuture` (JAX counterpart: ``batcher.py:54``)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._read = 0
        self._finished = False
        self._reason: Optional[str] = None
        self._exc: Optional[BaseException] = None

    # -- producer side (the batcher's worker) ------------------------------
    def put_token(self, tok: int) -> None:
        with self._cond:
            self._tokens.append(int(tok))
            self._cond.notify_all()

    def finish(self, reason: str = "eos") -> None:
        with self._cond:
            self._finished = True
            self._reason = reason
            self._cond.notify_all()

    def set_exception(self, exc: BaseException) -> None:
        with self._cond:
            self._exc = exc
            self._finished = True
            self._cond.notify_all()

    def set_result(self, tokens) -> None:
        with self._cond:
            self._tokens = [int(t) for t in tokens]
            self._finished = True
            self._reason = "set_result"
            self._cond.notify_all()

    # -- consumer side ---------------------------------------------------------
    def next_token(self, timeout: Optional[float] = None) -> Optional[int]:
        """The next unread token, waiting for it; None once the stream has
        finished. Raises the stream's exception (a failed stream never
        hangs)."""
        with self._cond:
            while True:
                if self._exc is not None:
                    raise self._exc
                if self._read < len(self._tokens):
                    self._read += 1
                    return self._tokens[self._read - 1]
                if self._finished:
                    return None
                if not self._cond.wait(timeout):
                    raise TimeoutError("no token within timeout; stream "
                                       "still generating")

    def tokens(self) -> List[int]:
        with self._cond:
            return list(self._tokens)

    def done(self) -> bool:
        with self._cond:
            return self._finished

    def finish_reason(self) -> Optional[str]:
        with self._cond:
            return self._reason

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            self._cond.wait_for(lambda: self._finished, timeout)
            return self._finished

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """The whole generated sequence (BOS left out, EOS kept when
        emitted)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._finished, timeout):
                raise TimeoutError("generation still in flight")
            if self._exc is not None:
                raise self._exc
            return list(self._tokens)


class _DecodeRequest:
    __slots__ = ("src", "valid", "max_new", "tenant", "stream", "t_enqueue",
                 "rid", "requeues")

    def __init__(self, src, valid, max_new, tenant):
        self.src = src
        self.valid = valid
        self.max_new = max_new
        self.tenant = tenant
        self.stream = TokenStream()
        self.t_enqueue = time.perf_counter()
        self.rid = f"d{next(_STREAM_IDS)}"
        self.requeues = 0


class _Active:
    __slots__ = ("req", "row", "last_token", "produced", "t_last")

    def __init__(self, req: _DecodeRequest, row: int, bos: int):
        self.req = req
        self.row = row
        self.last_token = bos
        self.produced = 0
        self.t_last = time.perf_counter()


class DecodeBatcher:
    """Continuous batching over one :class:`~.engine.DecodeEngine` (JAX
    counterpart: ``batcher.py:166``). ``submit(prompt_tokens)`` ->
    :class:`TokenStream`. ``queue_limit`` and ``max_requeues`` default to
    ``MXTPU_DECODE_QUEUE_LIMIT`` and ``MXTPU_DECODE_MAX_REQUEUES``."""

    def __init__(self, engine: DecodeEngine,
                 queue_limit: Optional[int] = None,
                 max_requeues: Optional[int] = None,
                 block_secs: float = 0.0,
                 metrics: Optional[DecodeMetrics] = None,
                 qos=None):
        self.engine = engine
        self.qos = qos
        self.queue_limit = int(getenv("MXTPU_DECODE_QUEUE_LIMIT")
                               if queue_limit is None else queue_limit)
        self.max_requeues = int(getenv("MXTPU_DECODE_MAX_REQUEUES")
                                if max_requeues is None else max_requeues)
        self.block_secs = float(block_secs)
        self.metrics = metrics or DecodeMetrics()
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._active: List[Optional[_Active]] = [None] * engine.max_batch
        #: requests popped from the queue but not yet in a batch row:
        #: stop(drain=True) must not mistake this window for idle
        self._inflight_admits = 0
        self._stop = False
        self._closed = False
        self._worker: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "DecodeBatcher":
        if self._worker is None or not self._worker.is_alive():
            self._stop = False
            self._closed = False
            self._worker = threading.Thread(target=self._run,
                                            name="mx-decode-batcher",
                                            daemon=True)
            self._worker.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """``drain=True`` finishes in-flight generation and the queue first
        (within ``timeout`` on the monotonic clock); what is left fails
        with "batcher stopped"."""
        t0 = time.monotonic()
        self._closed = True
        if self._worker is not None:
            if drain:
                while ((self.depth() or self.active_sequences()
                        or self._admits_in_flight())
                       and time.monotonic() - t0 < timeout):
                    time.sleep(0.005)
            self._stop = True
            self._wake.set()
            self._worker.join(timeout)
        with self._lock:
            leftovers = list(self._queue)
            self._queue.clear()
        for req in leftovers:
            req.stream.set_exception(MXNetError("batcher stopped"))
        for act in list(self._active):
            if act is not None:
                self._retire(act, reason="stopped",
                             exc=MXNetError("batcher stopped"))

    def worker_alive(self) -> bool:
        w = self._worker
        return w is not None and w.is_alive()

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def active_sequences(self) -> int:
        with self._lock:
            return sum(1 for a in self._active if a is not None)

    def _admits_in_flight(self) -> int:
        with self._lock:
            return self._inflight_admits

    def retry_after_s(self) -> float:
        """Backoff hint: about one sequence's residence per queued wave of
        batch rows."""
        waves = max(1, (self.depth() + self.engine.max_batch - 1)
                    // self.engine.max_batch)
        return round(max(0.05, waves * 0.1), 3)

    def stats(self) -> dict:
        return {"metrics": self.metrics.snapshot(),
                "engine": self.engine.stats(),
                "queue_depth": self.depth(),
                "active_sequences": self.active_sequences()}

    # -- client side ---------------------------------------------------------
    def submit(self, src_tokens, valid_len: Optional[int] = None,
               max_new_tokens: Optional[int] = None,
               tenant: Optional[str] = None) -> TokenStream:
        """Enqueue one prompt; returns its stream. A prompt longer than the
        table's largest ``src`` bucket raises here; a full queue raises
        :class:`~..batcher.QueueFullError` (after waiting up to
        ``block_secs``)."""
        src = onp.asarray(src_tokens, "int32").reshape(-1)
        self.engine._table.bucket("src", src.shape[0])  # raises on overflow
        max_new = min(int(max_new_tokens or self.engine.max_target_len - 1),
                      self.engine.max_target_len - 1)
        req = _DecodeRequest(src, valid_len, max_new, tenant)
        if self.qos is not None and not self.qos.try_take(
                tenant or "default", max_new):
            self.metrics.record_shed()
            raise ShedError(
                f"tenant {tenant or 'default'!r} is over its tokens/sec "
                f"budget (est {max_new} tokens)",
                retry_after=self.retry_after_s(), reason="tenant_tokens")
        deadline = time.time() + self.block_secs
        while True:
            with self._lock:
                if self._closed:
                    raise MXNetError("batcher stopped; submit rejected")
                if len(self._queue) < self.queue_limit:
                    self._queue.append(req)
                    break
            if time.time() >= deadline:
                self.metrics.record_shed()
                raise QueueFullError(
                    f"decode queue is full ({self.queue_limit} requests); "
                    "backpressure — retry with backoff or raise "
                    "MXTPU_DECODE_QUEUE_LIMIT")
            time.sleep(0.0005)
        self._wake.set()
        return req.stream

    # -- worker side ---------------------------------------------------------
    def _run(self) -> None:
        while not self._stop:
            admitted = self._admit_pending()
            if any(a is not None for a in self._active):
                self._step_once()
                continue
            if not admitted:
                self._wake.wait(timeout=0.05 if self.depth() else None)
                self._wake.clear()

    def _free_row(self) -> Optional[int]:
        for i, a in enumerate(self._active):
            if a is None:
                return i
        return None

    def _admit_pending(self) -> bool:
        """Token-boundary join: queued requests into free batch rows while
        the block pool has seats, each through its bucketed prefill."""
        admitted = False
        while True:
            row = self._free_row()
            if row is None or not self.engine.pool.can_admit():
                return admitted
            with self._lock:
                if not self._queue:
                    return admitted
                req = self._queue.popleft()
                self._inflight_admits += 1
            try:
                try:
                    table = self.engine.pool.alloc_sequence(req.rid)
                except CacheExhausted as e:
                    self._bounce(req, e)
                    continue
                try:
                    cross_row, lp = self.engine.prefill_request(req.src,
                                                                req.valid)
                except Exception as e:  # noqa: BLE001 — to the stream
                    self.engine.pool.free_sequence(req.rid)
                    req.stream.set_exception(e)
                    self.metrics.record_failed()
                    continue
                self.engine.bind_row(row, cross_row, lp)
                self.engine.set_row_table(row, table)
                self._active[row] = _Active(req, row, self.engine.bos_id)
                admitted = True
            finally:
                with self._lock:
                    self._inflight_admits -= 1

    def _bounce(self, req: _DecodeRequest, exc: CacheExhausted) -> None:
        """An admission refused for cache pressure: back to the queue a
        bounded number of times, then shed loudly."""
        req.requeues += 1
        if req.requeues <= self.max_requeues:
            self.metrics.record_requeue()
            with self._lock:
                self._queue.append(req)
        else:
            self.metrics.record_shed()
            req.stream.set_exception(exc)

    def _step_once(self) -> None:
        """One token boundary: every active sequence one token further
        through the fixed-shape decode step."""
        if inject.should("decode_replica_death"):
            self._replica_death()
            return
        B = self.engine.max_batch
        positions = onp.zeros((B,), "int32")
        tokens = onp.zeros((B,), "int32")
        stepping: List[_Active] = []
        for act in self._active:
            if act is None:
                continue
            try:
                _page, _slot, table = self.engine.pool.append_token(
                    act.req.rid)
            except CacheExhausted as e:
                # unreachable with seat-based admission: fail the stream
                # loudly rather than truncate it silently
                self._retire(act, reason="cache_exhausted", exc=e)
                continue
            self.engine.set_row_table(act.row, table)
            positions[act.row] = (
                self.engine.pool.sequence_length(act.req.rid) - 1)
            tokens[act.row] = act.last_token
            stepping.append(act)
        if not stepping:
            return
        logits = self.engine.run_step(positions, tokens)
        self.metrics.record_step(len(stepping), B)
        now = time.perf_counter()
        for act in stepping:
            nxt = int(onp.argmax(logits[act.row]))
            if act.produced == 0:
                self.metrics.record_first_token(
                    (now - act.req.t_enqueue) * 1e3)
            self.metrics.record_token((now - act.t_last) * 1e3)
            act.t_last = now
            act.produced += 1
            act.last_token = nxt
            act.req.stream.put_token(nxt)
            if nxt == self.engine.eos_id:
                self._retire(act, reason="eos")
            elif act.produced >= act.req.max_new:
                self._retire(act, reason="length")

    def _retire(self, act: _Active, reason: str,
                exc: Optional[BaseException] = None) -> None:
        """Token-boundary leave: the pages and the batch row free; the next
        queued request joins on the following boundary."""
        self.engine.pool.free_sequence(act.req.rid)
        self.engine.clear_row(act.row)
        self._active[act.row] = None
        req = act.req
        if exc is None:
            self.metrics.record_stream_done(
                (time.perf_counter() - req.t_enqueue) * 1e3)
            req.stream.finish(reason)
        else:
            self.metrics.record_failed()
            req.stream.set_exception(exc)

    def _replica_death(self) -> None:
        """Chaos: the replica dies mid-generation. Every active and queued
        stream fails with ``ReplicaUnavailable`` (a router retries such a
        request elsewhere), the cache is reset, and the next request is
        served: nothing hangs, nothing is cut short silently."""
        exc = ReplicaUnavailable(
            "decode replica died mid-generation (chaos); stream aborted — "
            "requeue the request")
        for act in [a for a in self._active if a is not None]:
            self._retire(act, reason="replica_death", exc=exc)
        with self._lock:
            queued = list(self._queue)
            self._queue.clear()
        for req in queued:
            self.metrics.record_failed()
            req.stream.set_exception(exc)
        self.engine.reset_cache()
