"""Training monitor: per-batch statistics of intermediate outputs.

Counterpart: the JAX package's ``monitor.py``, its Executor path
(``:77-80``, ``tic``/``toc``/``toc_print``): installed on an Executor
(``mod.fit(..., monitor=mon)``), it records a statistic (default
``||x|| / sqrt(x.size)``) of every op output whose name matches ``pattern``
every ``interval`` batches, read by ``Executor.capture_internals``, which
runs the forward's own evaluator. The Block path of the JAX monitor
(``:81-160``) bridges onto ``telemetry.numerics``, which the port has not
yet (ROADMAP queue A, item 8), so installing on a Gluon block raises.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Tuple

import numpy as onp

from .base import MXNetError

__all__ = ["Monitor"]


def _default_stat(arr: onp.ndarray) -> float:
    """``||x|| / sqrt(x.size)`` in float64."""
    a = onp.asarray(arr, dtype=onp.float64)
    return float(onp.linalg.norm(a) / max(onp.sqrt(a.size), 1.0))


class Monitor:
    """Statistics of the outputs named by ``pattern`` every ``interval``
    batches, each ``(batch, name, stat)``."""

    def __init__(self, interval: int = 1,
                 stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _default_stat
        self.pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue: List[Tuple[int, str, float]] = []
        self.logger = logging.getLogger(__name__)
        self._execs: List = []

    def install(self, target) -> None:
        """Attach to an Executor (anything with ``capture_internals``)."""
        if not hasattr(target, "capture_internals"):
            raise MXNetError(
                f"Monitor.install takes an Executor here; monitoring a "
                f"{type(target).__name__} bridges onto telemetry.numerics, "
                "which comes with ROADMAP queue A, item 8")
        if target not in self._execs:
            self._execs.append(target)

    def tic(self) -> None:
        """Start of a batch: decide whether it is monitored."""
        self.activated = (self.step % self.interval) == 0
        self.step += 1

    def toc(self) -> List[Tuple[int, str, float]]:
        """End of a batch: the statistics of a monitored one (read from
        every installed Executor now), else nothing."""
        if not self.activated:
            return []
        for exe in self._execs:
            for name, val in exe.capture_internals().items():
                if self.pattern.match(name):
                    self.queue.append((self.step - 1, name,
                                       self.stat_func(onp.asarray(val))))
        self.activated = False
        res, self.queue = self.queue, []
        if self.sort:
            res = sorted(res, key=lambda x: x[1])
        return res

    def toc_print(self) -> None:
        for step, name, stat in self.toc():
            self.logger.info("Batch: %7d %30s %g", step, name, stat)
