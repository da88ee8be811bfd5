"""Named locks (JAX counterpart: ``lockcheck.py``, ``make_lock`` and
``make_rlock`` at ``:309-319``).

Every lock of the fault runtime and of the serving tier is
made here under a stable name, as in the JAX package, so that a runtime
lock-order checker can wrap them without touching their callers. Here
they are plain ``threading.Lock``/``RLock`` objects: the checker itself
(tracked locks, the order graph, inversions and hold times) is not
ported yet. :class:`LockOrderError` is, because the serving router
classifies a request's failure by it.
"""
from __future__ import annotations

import threading

__all__ = ["make_lock", "make_rlock", "LockOrderError"]


class LockOrderError(RuntimeError):
    """A tracked acquisition that is certain (same-thread re-acquire of a
    non-reentrant lock) or strongly suspected (bounded-timeout expiry on
    an inverted order) to deadlock (JAX counterpart: ``lockcheck.py:58``).
    The router treats it as poisoning the whole replica."""


def make_lock(name: str):
    """A lock named ``name`` (``Class._attr`` or ``module._VAR``)."""
    del name
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    del name
    return threading.RLock()
