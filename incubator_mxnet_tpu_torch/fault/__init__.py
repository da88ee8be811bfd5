"""``mx.fault``: the fault-tolerant training runtime (JAX counterpart:
``fault/__init__.py``).

=====================  ====================================================
:mod:`~.checkpoint`    atomic, versioned, checksum-verified checkpoint
                       directories with retention (``save_checkpoint`` /
                       ``load_latest``), in the JAX package's layout; the
                       trainers round-trip their whole state through it
                       (parameters, optimizer states, step, learning rate,
                       the generators' states)
:mod:`~.guards`        a fused finite check (:func:`all_finite`) and
                       :class:`StepGuard`'s ``warn`` / ``skip_and_rollback``
                       / ``halt`` policies
:mod:`~.watchdog`      a per-step deadline timer that records the capture
                       state when a step stalls (:class:`Watchdog`)
:mod:`~.retry`         exponential backoff read from the environment
                       (:class:`RetryPolicy`)
:mod:`~.inject`        the seeded chaos harness: NaN batches, slow steps,
                       leaks, decode cache pressure and named crash points
=====================  ====================================================

Typical wiring::

    guard = mx.fault.StepGuard(policy="skip_and_rollback")
    trainer = mx.parallel.ShardedTrainer(net, loss_fn, "adamw", {...},
                                         guard=guard,
                                         watchdog=mx.fault.Watchdog())
    for step, batch in enumerate(batches):
        trainer.step(*batch)
        if step % 100 == 0:
            trainer.save_checkpoint("ckpts/", keep=3)
    # after a crash, in a new process:
    trainer.restore_checkpoint("ckpts/")     # the newest verified step
"""
from __future__ import annotations

from . import checkpoint  # noqa: F401
from . import guards  # noqa: F401
from . import inject  # noqa: F401
from . import retry  # noqa: F401
from . import watchdog as _watchdog_mod  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointCorruptError, CheckpointError, list_checkpoints,
    load_checkpoint, load_latest, save_checkpoint,
)
from .guards import NonFiniteError, StepGuard, all_finite  # noqa: F401
from .retry import RetryExhausted, RetryPolicy, call_with_retry  # noqa: F401
from .watchdog import Watchdog, WatchdogFlag  # noqa: F401

__all__ = ["checkpoint", "guards", "inject", "retry",
           "save_checkpoint", "load_checkpoint", "load_latest",
           "list_checkpoints", "CheckpointError", "CheckpointCorruptError",
           "StepGuard", "NonFiniteError", "all_finite",
           "Watchdog", "WatchdogFlag",
           "RetryPolicy", "RetryExhausted", "call_with_retry"]
