"""Replica: one independent serving worker of the HA tier.

Counterpart: the JAX package's ``serve/replica.py`` (``Replica``
``:66-360``). A :class:`Replica` is the in-process unit of failure the
:class:`~.router.Router` spreads traffic over: it owns a private
:class:`~.registry.ModelRegistry`, one :class:`~.batcher.DynamicBatcher`
per model, and so its own :class:`~.compiled.CompiledModel` graphs;
nothing is shared with its peers but the card (and, when their loaders
return one block, the weights), so a crash or a wedged batcher in one
replica cannot take the tier down.

Lifecycle::

    new ──start()──▶ loading ──▶ healthy ◀──────────────┐
                        │           │ kill()/worker died │
                        ▼           ▼                    │
                    unhealthy ◀─ crashed ──restart()──▶ restarting
                        │                                │ (loader
                        ▼                                │  re-run)
                     stopped ◀──stop()── draining ◀──────┘

- ``kill()`` simulates process death (the ``replica_kill`` chaos site
  raises it from the request path): queued futures fail fast, so the
  router can retry them on a surviving replica.
- ``restart()`` rebuilds from scratch, as a respawned process would: a
  fresh registry and fresh batchers, the loader run again (its models'
  bucket graphs captured again; two replicas on one card capture one at a
  time, :mod:`...ops.cuda.graphs`). A loader that loads through an
  :class:`~.artifact_cache.ArtifactCache` (``load(cache=)``) restarts from
  the verified artifact, with no Python model built.

The ``router.health`` events and the flight bundle of a kill wait for the
``telemetry`` port (ROADMAP queue A, item 8).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError
from ..fault import inject
from ..fault.inject import ChaosCrash
from ..lockcheck import make_lock
from .artifact_cache import ArtifactCache
from .batcher import (DynamicBatcher, QueueFullError, ServeFuture,
                      make_registry_batcher)
from .buckets import BucketTable
from .registry import ModelRegistry, ModelVersion, apply_weights

__all__ = ["Replica", "ReplicaUnavailable", "ReplicaCrashed"]

#: legal lifecycle states (the module docstring's state machine)
STATES = ("new", "loading", "healthy", "unhealthy", "draining",
          "restarting", "crashed", "stopped")


def _record_forward(block, example_args) -> None:
    """One inference forward of ``block`` on ``example_args`` as NDArrays
    on its parameters' device: the signature an export traces."""
    from ..ndarray import NDArray
    p = next(iter(block.parameters()), None)
    device = p.device if p is not None else torch.device("cpu")
    args = [NDArray(torch.as_tensor(onp.asarray(a)).to(device))
            for a in example_args]
    with autograd.pause(train_mode=False), torch.no_grad():
        block(*args)


class ReplicaUnavailable(MXNetError):
    """The replica cannot take this request now (not healthy, mid-restart,
    or its batcher closed under the submit): an infrastructure failure the
    router may retry elsewhere (JAX counterpart: ``replica.py:55``)."""


class ReplicaCrashed(ReplicaUnavailable):
    """The replica died taking this request (chaos ``replica_kill`` or a
    real worker death): failover territory."""


class Replica:
    """One serving worker: a private registry and batchers, a health
    surface and the crash/restart lifecycle (JAX counterpart:
    ``replica.py:66``).

    ``loader`` is a callable ``(replica) -> None`` that loads every model
    this replica serves (through :meth:`load`); it runs on :meth:`start`
    and again on every :meth:`restart`, into a fresh registry.
    """

    def __init__(self, name: str, loader: Callable[["Replica"], None],
                 max_delay_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 load_deadline_s: Optional[float] = None):
        self.name = name
        self._loader = loader
        #: staging deadline of every registry load this replica's loader
        #: makes: a hung loader during an unattended restart aborts (the
        #: replica lands unhealthy and is retried) instead of wedging the
        #: restarter thread
        self.load_deadline_s = load_deadline_s
        self._batcher_kw = dict(max_delay_ms=max_delay_ms,
                                queue_limit=queue_limit)
        self._lock = make_lock("Replica._lock")
        self.registry = ModelRegistry()
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._state = "new"
        self._reason = ""
        self.restarts = 0
        self.kills = 0

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def healthy(self) -> bool:
        return self.state == "healthy"

    def _transition(self, to: str, reason: str = "") -> None:
        assert to in STATES, to
        with self._lock:
            self._state = to
            self._reason = reason

    # -- loading --------------------------------------------------------
    def start(self) -> "Replica":
        """Run the loader (first boot, from ``new``); from ``stopped`` this
        is :meth:`restart` (the old registry still holds its versions)."""
        if self.state == "stopped":
            return self.restart()
        self._transition("loading")
        try:
            self._loader(self)
        except BaseException as e:
            self._transition("unhealthy", f"load failed: {e}")
            raise
        self._transition("healthy")
        return self

    def load(self, name: str, *, table: BucketTable,
             input_axes: Sequence[Dict[int, str]],
             factory: Optional[Callable] = None,
             artifacts: Optional[str] = None,
             cache: Optional[ArtifactCache] = None, version: int = 1,
             input_names: Optional[Sequence[str]] = None,
             example_args: Optional[Sequence] = None,
             output_axes: Optional[Sequence[Dict[int, str]]] = None,
             pad_values=0, analyze: bool = True,
             warmup: bool = True) -> ModelVersion:
        """Load one model into this replica's registry under its staging
        deadline, through the artifact cache when one is given (JAX
        counterpart: ``replica.py:140``).

        With ``cache`` and ``factory``: a verified hit loads the artifact
        (no Python model is built: the path a restart takes); a miss or a
        corrupt entry builds ``factory()``, runs it once on
        ``example_args`` if it has recorded no forward, writes the entry
        (:meth:`ArtifactCache.put`) and loads from that fresh artifact, so
        every boot serves the bytes a restart will."""
        if cache is not None and factory is not None:
            names = list(input_names or ["data"])
            got = cache.get(name, version, table, input_axes)
            if got is None:
                block = factory()
                if getattr(block, "_last_sig", None) is None \
                        and example_args is not None:
                    _record_forward(block, example_args)
                prefix = cache.put(name, version, block, table, input_axes,
                                   input_names=names)
                del block
            else:
                prefix, manifest = got
                names = list(manifest.get("input_names", names))
            return self.registry.load(
                name, table=table, input_axes=input_axes, artifacts=prefix,
                version=version, input_names=names, output_axes=output_axes,
                pad_values=pad_values, analyze=analyze, warmup=warmup,
                deadline_s=self.load_deadline_s)
        return self.registry.load(
            name, table=table, input_axes=input_axes, factory=factory,
            artifacts=artifacts, version=version, input_names=input_names,
            example_args=example_args, output_axes=output_axes,
            pad_values=pad_values, analyze=analyze, warmup=warmup,
            deadline_s=self.load_deadline_s)

    # -- request path ---------------------------------------------------
    def _batcher(self, name: str) -> DynamicBatcher:
        with self._lock:
            # the state is checked under the lock kill()/restart() clear
            # _batchers under: a submit racing a kill must not resurrect a
            # batcher on a crashed replica
            if self._state != "healthy":
                raise ReplicaUnavailable(
                    f"replica {self.name!r} is {self._state}"
                    + (f" ({self._reason})" if self._reason else ""))
            b = self._batchers.get(name)
            if b is None:
                b = make_registry_batcher(self.registry, name,
                                          **self._batcher_kw)
                self._batchers[name] = b
        return b

    def submit(self, model: str, *arrays) -> ServeFuture:
        """Enqueue one single-example request on this replica. The chaos
        probes run first: an armed or drawn ``replica_kill`` kills this
        replica (queued futures fail fast) and raises
        :class:`ReplicaCrashed`; ``slow_replica`` adds latency. State and
        batcher failures raise :class:`ReplicaUnavailable`; anything else
        is the request's own fault and is not retryable."""
        try:
            inject.crash("replica_kill")
            if inject.should("replica_kill"):
                raise ChaosCrash("replica_kill")
        except ChaosCrash as e:
            self.kill(reason="chaos: replica_kill")
            raise ReplicaCrashed(
                f"replica {self.name!r} killed mid-request") from e
        inject.maybe_delay("slow_replica")
        try:
            return self._batcher(model).submit(*arrays)
        except (QueueFullError, ReplicaUnavailable):
            raise
        except MXNetError as e:
            # a kill or restart racing this submit closes the batcher or
            # empties the registry under us: unavailability, not a
            # malformed request
            if not self.healthy() or "batcher stopped" in str(e):
                raise ReplicaUnavailable(
                    f"replica {self.name!r} became unavailable "
                    f"mid-submit: {e}") from e
            raise

    def push_weights(self, model: str, weights: Dict) -> int:
        """Write new weights into the active version in place: the
        router's training-to-serving pipe. Shapes match the captured
        graphs, so this is ``refresh_params`` with no capture; the model's
        lock keeps a replay from reading half-written weights. Returns how
        many parameters were written."""
        cm = self.registry.get(model)
        with cm._lock:
            applied = apply_weights(cm._block, weights)
            if not applied:
                raise MXNetError(
                    f"weight push onto replica {self.name!r} matched 0 of "
                    f"{model!r}'s parameters — name-scope mismatch?")
            cm.refresh_params()
        return applied

    # -- health surface -------------------------------------------------
    def queue_depth(self) -> int:
        with self._lock:
            batchers = list(self._batchers.values())
        return sum(b.depth() for b in batchers)

    def heartbeat(self) -> Dict:
        """One health probe: state, queue depth, flush progress (batches so
        far) and the workers' liveness. A healthy replica whose batcher
        worker died is marked crashed; stall judgement is the router's,
        from progress deltas."""
        with self._lock:
            state = self._state
            batchers = list(self._batchers.values())
        depth = sum(b.depth() for b in batchers)
        batches = sum(b.metrics.batches + b.metrics.failed_batches
                      for b in batchers)
        alive = all(b.worker_alive() for b in batchers)
        if state == "healthy" and batchers and not alive:
            self.kill(reason="batcher worker died")
            state = self.state
        return {"replica": self.name, "state": state, "depth": depth,
                "batches": batches, "workers_alive": alive,
                "ts": time.monotonic()}

    # -- lifecycle ------------------------------------------------------
    def kill(self, reason: str = "") -> None:
        """Simulated process death: serving stops now, queued futures fail
        fast (the router retries them elsewhere), and the state becomes
        ``crashed`` for the health loop to restart."""
        with self._lock:
            # only a serving(ish) replica can crash: a kill racing a drain,
            # restart or stop must not resurrect it through the health
            # loop's crashed -> restart path
            if self._state not in ("healthy", "loading", "unhealthy"):
                return
            self._state = "crashed"
            self._reason = reason
            batchers = list(self._batchers.values())
            self._batchers.clear()
            self.kills += 1
        for b in batchers:
            b.stop(drain=False, timeout=0.5)

    def restart(self) -> "Replica":
        """Full rebuild (a fresh registry and batchers, the loader run
        again), then healthy; the router calls it from its restarter
        thread."""
        with self._lock:
            if self._state == "restarting":
                return self
            self._state = "restarting"
            stale = list(self._batchers.values())
            self._batchers.clear()
            self.registry = ModelRegistry()
            self.restarts += 1
        for b in stale:
            b.stop(drain=False, timeout=0.5)
        try:
            self._loader(self)
        except BaseException as e:
            self._transition("unhealthy", f"restart load failed: {e}")
            raise
        self._transition("healthy", "restarted")
        return self

    def drain(self, timeout: float = 10.0) -> None:
        """Serve what is queued, then stop the batchers."""
        with self._lock:
            self._state = "draining"
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.stop(drain=True, timeout=timeout)

    def stop(self, timeout: float = 10.0) -> None:
        self.drain(timeout=timeout)
        self._transition("stopped")

    def snapshot(self) -> Dict:
        with self._lock:
            state = self._state
            batchers = dict(self._batchers)
        return {"replica": self.name, "state": state,
                "restarts": self.restarts, "kills": self.kills,
                "queue_depth": sum(b.depth() for b in batchers.values()),
                "models": {n: b.metrics.snapshot() for n, b in
                           sorted(batchers.items())}}

    def __repr__(self):
        return f"Replica({self.name!r}, {self.state})"
