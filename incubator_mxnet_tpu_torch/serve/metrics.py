"""Per-request serving counters.

Counterpart: the JAX package's ``serve/metrics.py`` (``ServeMetrics`` at
``:54``) and the reservoir of ``telemetry/metrics.py`` (``Histogram`` at
``:145``). ``snapshot()`` has the same keys. The Prometheus registry
series and trace exemplars come with the ``telemetry/`` port.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as onp

from ..util import nearest_rank_percentile

__all__ = ["Histogram", "ServeMetrics"]


class Histogram:
    """Bounded uniform reservoir (algorithm R, seeded) plus exact
    count/sum/min/max (JAX counterpart: ``telemetry/metrics.py:145``)."""

    def __init__(self, name: str = "", q=(50, 95, 99),
                 reservoir: int = 8192, seed: int = 0):
        self.name = name
        self.q = tuple(q)
        self.reservoir = int(reservoir)
        self._seed = int(seed)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._samples: List[float] = []
            self._seen = 0
            self._total = 0.0
            self._min = float("inf")
            self._max = float("-inf")
            self._rng = onp.random.RandomState(self._seed)

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._seen += 1
            self._total += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._samples) < self.reservoir:
                self._samples.append(v)
            else:
                j = int(self._rng.randint(0, self._seen))
                if j < self.reservoir:
                    self._samples[j] = v

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir; NaN when empty
        (JAX counterpart: ``telemetry/metrics.py:235``)."""
        with self._lock:
            samples = sorted(self._samples)
        return nearest_rank_percentile(samples, q)

    def summary(self) -> Dict[str, float]:
        """count/mean/min/max and the configured percentiles."""
        with self._lock:
            samples = sorted(self._samples)
            n, total = self._seen, self._total
            lo, hi = self._min, self._max
        out = {"count": n, "mean": total / n if n else float("nan"),
               "min": lo if n else float("nan"),
               "max": hi if n else float("nan")}
        for q in self.q:
            out[f"p{q:g}"] = nearest_rank_percentile(samples, q)
        return out


def _j(v, ndigits: int = 3):
    """JSON-safe number: NaN/inf (empty metrics) become null."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    if f != f or f in (float("inf"), float("-inf")):
        return None
    return round(f, ndigits)


class ServeMetrics:
    """Thread-safe serving counters for one model/batcher: latency
    percentiles, queue depth, rejections, batches and their occupancy
    (JAX counterpart: ``serve/metrics.py:54``)."""

    def __init__(self, reservoir: int = 8192, model: str = "default"):
        self._lock = threading.Lock()
        self.model = model
        self._latency = Histogram(name="latency_ms", q=(50, 95, 99),
                                  reservoir=reservoir)
        self._batch_ms = Histogram(name="batch_ms", q=(50, 95, 99),
                                   reservoir=reservoir)
        self.requests = 0
        self.rejected = 0
        self.failed = 0
        self.failed_batches = 0
        self.batches = 0
        self.rows = 0
        self.bucket_rows = 0
        self.depth = 0
        self.max_depth = 0
        self.last_occupancy = float("nan")

    def record_request(self, latency_ms: float) -> None:
        with self._lock:
            self.requests += 1
            self._latency.observe(latency_ms)

    def record_rejection(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_failed_batch(self, size: int) -> None:
        """A flush that errored: its requests got exceptions, not results."""
        with self._lock:
            self.failed += size
            self.failed_batches += 1

    def record_depth(self, depth: int) -> None:
        with self._lock:
            self.depth = depth
            self.max_depth = max(self.max_depth, depth)

    def record_batch(self, size: int, bucket: int, dt_ms: float) -> None:
        with self._lock:
            self.batches += 1
            self.rows += size
            self.bucket_rows += bucket
            self.last_occupancy = size / bucket if bucket else float("nan")
            self._batch_ms.observe(dt_ms)

    @staticmethod
    def _pcts(hist: Histogram) -> Dict:
        s = hist.summary()
        out = {f"{hist.name}_p{q:g}": _j(s[f"p{q:g}"]) for q in hist.q}
        out[f"{hist.name}_mean"] = _j(s["mean"])
        return out

    def snapshot(self, model=None) -> Dict:
        """JSON-ready dict of everything recorded; pass the served
        ``CompiledModel`` to inline its compile-cache counters (JAX
        counterpart: ``serve/metrics.py:141``)."""
        with self._lock:
            snap = {
                "requests": self.requests,
                "rejected": self.rejected,
                "failed": self.failed,
                "failed_batches": self.failed_batches,
                "queue_depth": self.depth,
                "queue_max_depth": self.max_depth,
                "batches": self.batches,
                "batch_occupancy": _j(self.rows / self.bucket_rows, 4)
                if self.bucket_rows else None,
                "latency": self._pcts(self._latency),
                "batch_latency": self._pcts(self._batch_ms),
            }
        if model is not None:
            snap["compile_cache"] = model.cache_info()
        return snap

    def reset(self) -> None:
        """Clear the window."""
        with self._lock:
            self._latency.reset()
            self._batch_ms.reset()
            self.requests = self.rejected = self.batches = 0
            self.failed = self.failed_batches = 0
            self.rows = self.bucket_rows = 0
            self.depth = self.max_depth = 0
            self.last_occupancy = float("nan")
