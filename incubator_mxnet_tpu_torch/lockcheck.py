"""Named locks (JAX counterpart: ``lockcheck.py``, ``make_lock`` and
``make_rlock`` at ``:309-319``).

Every lock of the fault runtime (and, later, of the serving registry) is
made here under a stable name, as in the JAX package, so that a runtime
lock-order checker can wrap them without touching their callers. Here
they are plain ``threading.Lock``/``RLock`` objects: the checker itself
(tracked locks, the order graph, inversions and hold times) is not
ported yet.
"""
from __future__ import annotations

import threading

__all__ = ["make_lock", "make_rlock"]


def make_lock(name: str):
    """A lock named ``name`` (``Class._attr`` or ``module._VAR``)."""
    del name
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    del name
    return threading.RLock()
