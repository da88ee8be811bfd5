"""Token-level decode counters: the streaming sibling of ``ServeMetrics``.

Counterpart: the JAX package's ``serve/decode/metrics.py``
(``DecodeMetrics``), on the port's :class:`~..metrics.Histogram`:
time to first token (TTFT), inter-token latency (ITL), request latency,
tokens, requests, sheds, requeues, failures, steps and step occupancy
(active rows over batch rows). ``snapshot()`` has the JAX keys; the
Prometheus registry series come with the ``telemetry/`` port.
"""
from __future__ import annotations

import json
import threading
from typing import Dict

from ..metrics import Histogram, ServeMetrics, _j

__all__ = ["DecodeMetrics"]


class DecodeMetrics:
    """Thread-safe token and stream counters for one decode batcher."""

    def __init__(self, reservoir: int = 8192, model: str = "default"):
        self._lock = threading.Lock()
        self.model = model
        self._itl = Histogram(name="itl_ms", q=(50, 99), reservoir=reservoir)
        self._ttft = Histogram(name="ttft_ms", q=(50, 99),
                               reservoir=reservoir)
        self._latency = Histogram(name="latency_ms", q=(50, 95, 99),
                                  reservoir=reservoir)
        self.reset()

    # -- recording -------------------------------------------------------
    def record_token(self, itl_ms: float) -> None:
        with self._lock:
            self.tokens += 1
            self._itl.observe(itl_ms)

    def record_first_token(self, ttft_ms: float) -> None:
        with self._lock:
            self._ttft.observe(ttft_ms)

    def record_stream_done(self, latency_ms: float) -> None:
        with self._lock:
            self.requests += 1
            self._latency.observe(latency_ms)

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_requeue(self) -> None:
        with self._lock:
            self.requeued += 1

    def record_failed(self) -> None:
        with self._lock:
            self.failed += 1

    def record_step(self, active_rows: int, capacity_rows: int) -> None:
        with self._lock:
            self.steps += 1
            self.step_rows += active_rows
            self.step_capacity += capacity_rows

    # -- reporting -------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "requests": self.requests,
                "tokens": self.tokens,
                "shed": self.shed,
                "requeued": self.requeued,
                "failed": self.failed,
                "steps": self.steps,
                "step_occupancy": _j(self.step_rows / self.step_capacity, 4)
                if self.step_capacity else None,
                "itl": ServeMetrics._pcts(self._itl),
                "ttft": ServeMetrics._pcts(self._ttft),
                "latency": ServeMetrics._pcts(self._latency),
            }

    def dumps(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._itl.reset()
            self._ttft.reset()
            self._latency.reset()
            self.requests = self.tokens = self.shed = 0
            self.requeued = self.failed = self.steps = 0
            self.step_rows = self.step_capacity = 0
