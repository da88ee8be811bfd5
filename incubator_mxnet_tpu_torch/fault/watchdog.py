"""Step watchdog: flags steps that run past a wall-clock deadline (JAX
counterpart: ``fault/watchdog.py``).

A daemon ``threading.Timer`` is armed around each step; past the deadline
it fires once for that step and records a :class:`WatchdogFlag`: the
elapsed time and the capture record of what was watched, that is the CUDA
graphs captured so far (a ``ShardedTrainer``'s fused step graphs, one per
batch signature, and each hybridized block's cached ops), the port's
counterpart of the JAX blocks' compile log. A capture in a step that
should only replay is the classic silent stall; a step with no new
capture that still stalls is blocked on data or on the device. The step
is not interrupted: the watchdog attributes, the caller decides
(checkpoint and restart).

The deadline is fixed (``deadline=`` seconds) or, by default, adaptive:
``ADAPTIVE_MULT`` times the moving average of recent step times, floored
at ``ADAPTIVE_FLOOR_S``; until the first step is seen the deadline is
``WARMUP_DEADLINE_S``, and the first watched step (eager run, capture) is
left out of the average. Usage (``ShardedTrainer(watchdog=Watchdog())``
does this itself)::

    wd = fault.Watchdog()
    with wd.watch(step=trainer.num_update, block=net):
        trainer.step(*batch)
    if wd.flags: ...

The JAX watchdog also publishes each flag as a telemetry event and writes
a flight bundle holding the elastic membership (``parallel.elastic.
snapshot()`` here): events and flight bundles are telemetry, which is not
ported yet (queue A, item 8).
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Callable, List, Optional

from ..lockcheck import make_lock

__all__ = ["Watchdog", "WatchdogFlag", "WARMUP_DEADLINE_S",
           "ADAPTIVE_MULT", "ADAPTIVE_FLOOR_S"]

#: adaptive deadline while no step time is known yet (the first step
#: runs eagerly and captures)
WARMUP_DEADLINE_S = 300.0
#: adaptive multiplier over the moving average of step time
ADAPTIVE_MULT = 50.0
#: adaptive floor, so that very short steps do not arm a hair trigger
ADAPTIVE_FLOOR_S = 2.0
#: smoothing of the moving average
_EMA_ALPHA = 0.2


class WatchdogFlag:
    """One deadline violation: the step, its deadline, the time elapsed
    when the timer fired, and the capture record at that moment."""

    def __init__(self, step: int, deadline: float, elapsed: float,
                 compiles: int, recent_signatures: List[str]):
        self.step = step
        self.deadline = deadline
        self.elapsed = elapsed
        self.compiles = compiles
        self.recent_signatures = recent_signatures

    def __str__(self):
        sig = (f"; {self.compiles} graph captures, most recent "
               f"{self.recent_signatures[-1]}" if self.compiles else
               "; no capture recorded (likely blocked on data or the "
               "device)")
        return (f"step {self.step} exceeded the {self.deadline:.1f}s "
                f"watchdog deadline ({self.elapsed:.1f}s elapsed{sig})")


class Watchdog:
    """Arms a timer per step; fires at most once per step.

    ``deadline``  seconds a step may take; ``None`` (default) is adaptive
                  (module docstring)
    ``on_flag``   optional callback ``(WatchdogFlag)``; every flag is also
                  ``warnings.warn``-ed
    """

    def __init__(self, deadline: Optional[float] = None,
                 on_flag: Optional[Callable[[WatchdogFlag], None]] = None):
        self.deadline = None if deadline is None else float(deadline)
        self.on_flag = on_flag
        self.flags: List[WatchdogFlag] = []
        self._timer: Optional[threading.Timer] = None
        self._ema_s: Optional[float] = None
        self._warmup_seen = False
        self._lock = make_lock("Watchdog._lock")

    def observe(self, wall_s: float) -> None:
        """Feed one completed step's wall time into the moving average."""
        with self._lock:
            self._ema_s = (float(wall_s) if self._ema_s is None else
                           (1 - _EMA_ALPHA) * self._ema_s
                           + _EMA_ALPHA * float(wall_s))

    def deadline_for_step(self) -> float:
        """The deadline the next watched step runs under."""
        if self.deadline is not None:
            return self.deadline
        with self._lock:
            ema = self._ema_s
        if ema is None:
            return WARMUP_DEADLINE_S
        return max(ADAPTIVE_FLOOR_S, ADAPTIVE_MULT * ema)

    @staticmethod
    def _compile_state(watched: Any):
        """The capture record of ``watched``: a trainer's fused-step
        graphs (one per batch signature) and every hybridized block's
        captured cached ops, as ``(count, the last three)``."""
        log = []
        if watched is not None:
            for sig, entry in getattr(watched, "_steps", {}).items():
                if getattr(entry, "graph", None) is not None:
                    log.append(("trainer.step", sig))
            for b in Watchdog._blocks(getattr(watched, "_block", watched)):
                for sig, op in b.__dict__.get("_cached_ops", {}).items():
                    if getattr(op, "fwd", None) is not None:
                        log.append((type(b).__name__, sig))
        return len(log), [repr(s)[:120] for s in log[-3:]]

    @staticmethod
    def _blocks(block):
        yield block
        for child in getattr(block, "_children", {}).values():
            yield from Watchdog._blocks(child)

    def _fire(self, step: int, t0: float, watched: Any,
              deadline: float) -> None:
        compiles, recent = self._compile_state(watched)
        flag = WatchdogFlag(step, deadline, time.monotonic() - t0,
                            compiles, recent)
        with self._lock:
            self.flags.append(flag)
            del self.flags[:-100]
        warnings.warn(f"[fault.watchdog] {flag}")
        if self.on_flag is not None:
            self.on_flag(flag)

    class _Watch:
        def __init__(self, wd: "Watchdog", step: int, watched: Any):
            self._wd, self._step, self._watched = wd, step, watched
            self._t0 = 0.0
            self._deadline = 0.0

        def __enter__(self):
            wd = self._wd
            self._t0 = t0 = time.monotonic()
            self._deadline = wd.deadline_for_step()
            wd._timer = threading.Timer(
                self._deadline, wd._fire,
                args=(self._step, t0, self._watched, self._deadline))
            wd._timer.name = f"mx-fault-watchdog-step{self._step}"
            wd._timer.daemon = True
            wd._timer.start()
            return wd

        def __exit__(self, *exc):
            wd = self._wd
            t = wd._timer
            wd._timer = None
            if t is not None:
                t.cancel()
            elapsed = time.monotonic() - self._t0
            if wd.deadline is None and not wd._warmup_seen:
                # the first watched step runs eagerly and captures: it
                # would hold the adaptive deadline far above steady state
                wd._warmup_seen = True
            elif elapsed < self._deadline:
                # only clean steps move the adaptive deadline
                wd.observe(elapsed)

    def watch(self, step: int, block: Any = None) -> "Watchdog._Watch":
        """Context manager arming the deadline around one step; ``block``
        is what the flag's capture record reads (a block or a
        ``ShardedTrainer``)."""
        return Watchdog._Watch(self, step, block)

    def __repr__(self):
        dl = "adaptive" if self.deadline is None else f"{self.deadline}"
        return f"Watchdog(deadline={dl}, flags={len(self.flags)})"
