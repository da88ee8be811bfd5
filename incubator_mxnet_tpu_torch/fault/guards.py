"""Step guards: anomaly detection with recovery policies (JAX counterpart:
``fault/guards.py``).

:func:`all_finite` answers "is every float value finite?" over any number
of tensors with one multi-tensor reduction per device and dtype and one
host read, and :class:`StepGuard` turns the answer into one of three
policies:

``warn``               count and ``warnings.warn``, keep the (bad) update
``skip_and_rollback``  restore the last good snapshot, drop the step
``halt``               raise :class:`NonFiniteError`

``ShardedTrainer(guard=...)`` owns the snapshot (device copies refreshed
every ``snapshot_every`` good steps) and reads its fused step's in-graph
verdict; the guard itself is state without a trainer, so
``amp.LossScaler`` and hand-written loops share the same policy object.
The JAX guard also publishes each trip as a telemetry event and writes a
flight bundle before a halt: the telemetry subsystem is not ported yet.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["StepGuard", "NonFiniteError", "all_finite", "POLICIES"]

POLICIES = ("warn", "skip_and_rollback", "halt")

#: elements per multi-tensor pass of :func:`all_finite` (bounds its
#: temporary to 256 MiB of float32)
_CHUNK = 1 << 26


class NonFiniteError(MXNetError):
    """A guarded step gave a non-finite loss or gradient under ``halt``
    (or past ``max_consecutive``)."""


def _leaves(tree, out: list) -> list:
    if isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _leaves(t, out)
    elif tree is not None:
        out.append(getattr(tree, "_data", tree))    # NDArray -> tensor
    return out


def _chunks(tensors: List[torch.Tensor]):
    """``tensors`` in runs of at most ``_CHUNK`` elements (a longer
    tensor alone)."""
    chunk, size = [], 0
    for t in tensors:
        if chunk and size + t.numel() > _CHUNK:
            yield chunk
            chunk, size = [], 0
        chunk.append(t)
        size += t.numel()
    if chunk:
        yield chunk


def all_finite(*trees) -> bool:
    """Is every float value in ``trees`` (tensors, NDArrays, numpy arrays
    and numbers, nested in lists, tuples and dicts) finite? Integer
    values are ignored. The tensors of each device and dtype go through
    one multi-tensor pass (``x * 0`` is 0 where ``x`` is finite, else
    NaN, and the norms of those are 0 or NaN), and the verdict is read
    once, however many arrays there are."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for leaf in _leaves(trees, []):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and leaf.numel():
                groups.setdefault((leaf.device, leaf.dtype),
                                  []).append(leaf.detach())
        else:
            a = onp.asarray(leaf)
            if a.dtype.kind in "fc" and not onp.isfinite(a).all():
                return False
    sums = []
    for tensors in groups.values():
        norms = [n.float() for chunk in _chunks(tensors) for n in
                 torch._foreach_norm(torch._foreach_mul(chunk, 0.0))]
        sums.append(torch.stack(norms).sum())
    if not sums:
        return True
    dev = sums[0].device
    return bool(torch.isfinite(torch.stack([v.to(dev) for v in sums]).sum()))


class StepGuard:
    """Policy and counters for one training loop (JAX counterpart:
    ``fault/guards.py:85``).

    ``policy``          one of :data:`POLICIES`
    ``grad_norm_limit`` optional: a finite global gradient norm above it
                        trips the guard as a NaN does
    ``snapshot_every``  how often, in good steps, the trainer refreshes its
                        rollback snapshot (1: exact rollback)
    ``max_consecutive`` under ``warn``/``skip_and_rollback``, more than
                        this many bad steps in a row raise
                        :class:`NonFiniteError` anyway
    ``on_trip``         optional callback ``(guard, info)`` on every trip
    """

    def __init__(self, policy: str = "warn",
                 grad_norm_limit: Optional[float] = None,
                 snapshot_every: int = 1, max_consecutive: int = 25,
                 on_trip: Optional[Callable[["StepGuard", dict],
                                            None]] = None):
        if policy not in POLICIES:
            raise MXNetError(f"unknown guard policy {policy!r}; "
                             f"choose from {POLICIES}")
        if snapshot_every < 1:
            raise MXNetError("snapshot_every must be >= 1")
        self.policy = policy
        self.grad_norm_limit = grad_norm_limit
        self.snapshot_every = snapshot_every
        self.max_consecutive = max_consecutive
        self.on_trip = on_trip
        #: steps that tripped the guard (any policy)
        self.tripped = 0
        #: steps rolled back under skip_and_rollback
        self.skipped = 0
        self._consecutive = 0
        #: (step, reason), newest last (the last 50)
        self.history: List[tuple] = []

    def is_bad(self, loss_finite: bool, grad_norm: Optional[float]
               ) -> Optional[str]:
        """Classify one step: a reason string, or None if clean."""
        if not loss_finite:
            return "non-finite loss/grad"
        if grad_norm is not None and self.grad_norm_limit is not None:
            if not (grad_norm <= self.grad_norm_limit):  # NaN-safe
                return (f"global grad norm {grad_norm:.3e} exceeds limit "
                        f"{self.grad_norm_limit:.3e}")
        return None

    def decide(self, step: int, reason: str, detail: str = "") -> str:
        """Record a tripped step and return what to do, ``"keep"`` or
        ``"rollback"``; ``halt`` and the ``max_consecutive`` escalation
        raise."""
        self.tripped += 1
        self._consecutive += 1
        self.history.append((step, reason))
        del self.history[:-50]
        info = {"step": step, "reason": reason, "policy": self.policy,
                "consecutive": self._consecutive, "detail": detail}
        if self.on_trip is not None:
            self.on_trip(self, info)
        msg = (f"[fault.guard] step {step}: {reason} "
               f"(policy={self.policy}, consecutive={self._consecutive})"
               + (f" {detail}" if detail else ""))
        if self.policy == "halt":
            raise NonFiniteError(msg)
        if self._consecutive > self.max_consecutive:
            raise NonFiniteError(
                msg + f"; {self._consecutive} consecutive bad steps exceeds "
                f"max_consecutive={self.max_consecutive}, halting anyway")
        warnings.warn(msg)
        if self.policy == "skip_and_rollback":
            self.skipped += 1
            return "rollback"
        return "keep"

    def good_step(self) -> None:
        self._consecutive = 0

    def __repr__(self):
        return (f"StepGuard(policy={self.policy!r}, tripped={self.tripped}, "
                f"skipped={self.skipped})")
