"""Router: health-checked failover routing over a set of replicas.

Counterpart: the JAX package's ``serve/router.py`` (``TokenRateBudget``
``:63``, ``ShedError`` ``:126``, ``DeadlineExceeded`` ``:138``,
``ReplicaSet`` ``:149``, ``Router`` ``:193-855``). Policies, each read
from the environment (``MXTPU_SERVE_*``, :mod:`...util`):

- **Health**: a heartbeat loop (``MXTPU_SERVE_HEARTBEAT_MS``) probes each
  replica; a crash (chaos ``replica_kill``, a dead batcher worker, a
  ``LockOrderError`` from the request path) or a stall (queued requests
  with no flush for ``MXTPU_SERVE_STALL_S``) marks it, and a restarter
  thread rebuilds it (its bucket graphs captured again).
- **Failover**: idempotent requests retry on a surviving replica with
  capped exponential backoff (``MXTPU_SERVE_RETRIES`` x
  ``MXTPU_SERVE_RETRY_BACKOFF_MS``) inside the request's deadline; one
  optional **hedged** attempt (``MXTPU_SERVE_HEDGE_MS``) races a duplicate
  on a second replica when the first is slow.
- **Admission and shedding**: per-tenant inflight caps
  (``MXTPU_SERVE_TENANT_INFLIGHT``), a tokens/sec budget per tenant
  (:class:`TokenRateBudget`) and a queue-depth threshold
  (``MXTPU_SERVE_SHED_DEPTH``) refuse with :class:`ShedError` carrying
  ``retry_after``, above each replica's ``DynamicBatcher`` backpressure.
- **Weight pipe**: :meth:`Router.sync_weights_once` takes the newest
  verified checkpoint (``fault.checkpoint.load_latest``), checks that every
  float array is finite and that the names resolve, and writes it into
  every healthy replica in place: no capture.

The JAX router publishes each decision as a telemetry event, counter and
trace span; those wait for the ``telemetry`` port (ROADMAP queue A, item
8). ``stats`` and :meth:`Router.snapshot` carry the same counts.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as onp

from ..base import MXNetError
from ..lockcheck import LockOrderError, make_lock
from ..util import getenv
from .batcher import QueueFullError, ServeFuture
from .replica import Replica, ReplicaUnavailable

__all__ = ["Router", "ReplicaSet", "ShedError", "DeadlineExceeded",
           "TokenRateBudget"]


class TokenRateBudget:
    """Per-tenant tokens/sec QoS: a token bucket per tenant, ``rate``
    tokens/sec sustained and ``burst`` deep (default one second's worth).
    :meth:`try_take` is asked with a request's estimated token cost before
    it queues, so a tenant over budget is refused while the request is
    cheap. ``rate`` 0 is unlimited. Thread-safe; refill is lazy on the
    monotonic clock (JAX counterpart: ``serve/router.py:63``)."""

    def __init__(self, tokens_per_s: Optional[float] = None,
                 burst: Optional[float] = None):
        self.rate = float(getenv("MXTPU_SERVE_TENANT_TOKENS_PER_S")
                          if tokens_per_s is None else tokens_per_s)
        b = float(getenv("MXTPU_SERVE_TENANT_TOKEN_BURST")
                  if burst is None else burst)
        self.burst = b if b > 0 else max(self.rate, 1.0)
        self._lock = make_lock("TokenRateBudget._lock")
        self._level: Dict[str, float] = {}
        self._mark: Dict[str, float] = {}

    def enabled(self) -> bool:
        return self.rate > 0

    def try_take(self, tenant: str, tokens: float) -> bool:
        """Debit ``tokens`` from ``tenant``'s bucket if they fit; False is
        over budget (shed the request, do not queue it)."""
        if not self.enabled() or tokens <= 0:
            return True
        now = time.monotonic()
        with self._lock:
            level = self._level.get(tenant, self.burst)
            mark = self._mark.get(tenant, now)
            level = min(self.burst, level + (now - mark) * self.rate)
            self._mark[tenant] = now
            if tokens > level:
                self._level[tenant] = level
                return False
            self._level[tenant] = level - tokens
            return True

    def headroom(self, tenant: str) -> float:
        """The bucket's current level in tokens (monitoring only)."""
        if not self.enabled():
            return float("inf")
        now = time.monotonic()
        with self._lock:
            level = self._level.get(tenant, self.burst)
            mark = self._mark.get(tenant, now)
            return min(self.burst, level + (now - mark) * self.rate)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"tokens_per_s": self.rate, "burst": self.burst,
                    "tenants": {t: round(v, 3)
                                for t, v in self._level.items()}}


class ShedError(MXNetError):
    """A request refused by admission control, overload shedding or
    placement exhaustion; ``retry_after`` (seconds) is the client's backoff
    hint (JAX counterpart: ``serve/router.py:126``)."""

    def __init__(self, msg: str, retry_after: float, reason: str = "shed"):
        super().__init__(f"{msg} (retry_after={retry_after:.3f}s)")
        self.retry_after = retry_after
        self.reason = reason


class DeadlineExceeded(MXNetError):
    """The request's deadline passed before any replica answered; carries
    ``retry_after`` as :class:`ShedError` does (JAX counterpart:
    ``serve/router.py:138``)."""

    def __init__(self, msg: str, retry_after: float):
        super().__init__(f"{msg} (retry_after={retry_after:.3f}s)")
        self.retry_after = retry_after
        self.reason = "deadline"


class ReplicaSet:
    """A fixed set of uniquely named replicas with a least-loaded pick
    (JAX counterpart: ``serve/router.py:149``)."""

    def __init__(self, replicas: Sequence[Replica]):
        if not replicas:
            raise MXNetError("ReplicaSet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise MXNetError(f"replica names must be unique, got {names}")
        self._replicas: Tuple[Replica, ...] = tuple(replicas)
        self._rr = itertools.count()

    def __iter__(self):
        return iter(self._replicas)

    def __len__(self):
        return len(self._replicas)

    def get(self, name: str) -> Replica:
        for r in self._replicas:
            if r.name == name:
                return r
        raise MXNetError(f"no replica {name!r} (have "
                         f"{[r.name for r in self._replicas]})")

    def healthy(self) -> List[Replica]:
        return [r for r in self._replicas if r.healthy()]

    def pick(self, exclude: Sequence[str] = ()) -> Optional[Replica]:
        """The healthy replica with the shallowest queue; ties rotate
        round-robin so replicas of equal depth share the load."""
        cands = [r for r in self._replicas
                 if r.healthy() and r.name not in exclude]
        if not cands:
            return None
        rot = next(self._rr)
        return min(((r.queue_depth(), (i + rot) % len(cands), r)
                    for i, r in enumerate(cands)),
                   key=lambda t: (t[0], t[1]))[2]

    def states(self) -> Dict[str, str]:
        return {r.name: r.state for r in self._replicas}


class Router:
    """Front door of the HA tier: admission, placement, a deadline-bound
    wait, failover and hedging, plus the health loop and the weight pipe
    (JAX counterpart: ``serve/router.py:193``)."""

    def __init__(self, replicas, *,
                 heartbeat_ms: Optional[float] = None,
                 stall_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 shed_depth: Optional[int] = None,
                 tenant_inflight: Optional[int] = None,
                 tenant_tokens_per_s: Optional[float] = None,
                 tenant_token_burst: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 restart_backoff_s: float = 0.5):
        def knob(value, name, kind):
            return kind(getenv(name) if value is None else value)

        self.replicas = (replicas if isinstance(replicas, ReplicaSet)
                         else ReplicaSet(replicas))
        self.heartbeat_ms = knob(heartbeat_ms, "MXTPU_SERVE_HEARTBEAT_MS",
                                 float)
        self.stall_s = knob(stall_s, "MXTPU_SERVE_STALL_S", float)
        self.retries = knob(retries, "MXTPU_SERVE_RETRIES", int)
        self.backoff_ms = knob(backoff_ms, "MXTPU_SERVE_RETRY_BACKOFF_MS",
                               float)
        self.hedge_ms = knob(hedge_ms, "MXTPU_SERVE_HEDGE_MS", float)
        self.shed_depth = knob(shed_depth, "MXTPU_SERVE_SHED_DEPTH", int)
        self.tenant_inflight = knob(tenant_inflight,
                                    "MXTPU_SERVE_TENANT_INFLIGHT", int)
        self.token_budget = TokenRateBudget(tenant_tokens_per_s,
                                            tenant_token_burst)
        self.request_timeout_s = knob(request_timeout_s,
                                      "MXTPU_SERVE_REQUEST_TIMEOUT_S", float)
        self.restart_backoff_s = float(restart_backoff_s)
        self._lock = make_lock("Router._lock")
        self._stop_evt = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._sync_threads: Dict[str, threading.Thread] = {}
        self._restarting: set = set()
        self._restart_threads: Dict[str, threading.Thread] = {}
        self._inflight: Dict[str, int] = {}
        #: (model, ckpt_root) -> {"step", "fleet": {replica: restarts}}
        self._synced_steps: Dict[Tuple[str, str], Dict] = {}
        #: health-thread-private stall accounting {name: {batches, since}}
        self._progress: Dict[str, Dict] = {}
        self.health_errors = 0
        #: seconds of each restart the restarter made (newest last)
        self.restart_seconds: List[float] = []
        self.stats: Dict[str, int] = {
            "accepted": 0, "completed": 0, "shed": 0, "failed": 0,
            "deadline_exceeded": 0, "retries": 0, "failovers": 0,
            "hedges": 0, "hedge_wins": 0, "restarts": 0,
            "weight_syncs": 0}

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Router":
        for rep in self.replicas:
            state = rep.state
            if state == "new":
                rep.start()
            elif state == "stopped":
                # a stopped replica's registry still holds its versions;
                # rebooting it is the restart path
                rep.restart()
        if self._health_thread is None or not self._health_thread.is_alive():
            self._stop_evt.clear()
            self._health_thread = threading.Thread(
                target=self._health_loop, name="mx-serve-router-health",
                daemon=True)
            self._health_thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        # the health thread first: only it spawns restarters, and
        # _schedule_restart does nothing once the stop event is set
        if self._health_thread is not None and self._health_thread.is_alive():
            self._health_thread.join(timeout=30.0)
        self._health_thread = None
        with self._lock:
            syncers = list(self._sync_threads.values())
            self._sync_threads.clear()
            restarters = list(self._restart_threads.values())
            self._restart_threads.clear()
        # restarters are joined before the replicas stop, so a restart in
        # flight cannot flip a member back to healthy under a stopped tier
        for t in syncers + restarters:
            if t.is_alive():
                t.join(timeout=30.0)
        for rep in self.replicas:
            rep.stop()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def retry_after_s(self) -> float:
        """Client backoff hint: grows with the shallowest healthy queue;
        1 s when nothing is healthy (a restart is in flight)."""
        healthy = self.replicas.healthy()
        if not healthy:
            return 1.0
        depth = min(r.queue_depth() for r in healthy)
        return round(min(5.0, 0.05 * (1 + depth)), 3)

    # -- admission ------------------------------------------------------
    def _shed(self, reason: str, msg: str) -> ShedError:
        self._bump("shed")
        return ShedError(msg, retry_after=self.retry_after_s(),
                         reason=reason)

    def _deadline(self, msg: str) -> DeadlineExceeded:
        """An accepted request that timed out, counted as a shed one is."""
        self._bump("deadline_exceeded")
        return DeadlineExceeded(msg, self.retry_after_s())

    def set_overload_policy(self, hedge_ms: Optional[float] = None,
                            shed_depth: Optional[int] = None) -> Dict:
        """Change the overload knobs of a live router; both are read per
        request, so the next admission sees them. Returns the previous
        values."""
        prev = {"hedge_ms": self.hedge_ms, "shed_depth": self.shed_depth}
        if hedge_ms is not None:
            self.hedge_ms = float(hedge_ms)
        if shed_depth is not None:
            self.shed_depth = int(shed_depth)
        return prev

    def _admit(self, tenant: Optional[str], est_tokens: int = 0) -> None:
        healthy = self.replicas.healthy()
        if not healthy:
            raise self._shed("no_healthy_replica",
                             "no healthy replica to accept the request")
        if self.shed_depth and all(r.queue_depth() >= self.shed_depth
                                   for r in healthy):
            raise self._shed(
                "overloaded", f"every healthy replica is at/over the shed "
                f"depth ({self.shed_depth})")
        key = tenant or "default"
        if est_tokens and not self.token_budget.try_take(key, est_tokens):
            raise self._shed(
                "tenant_tokens",
                f"tenant {key!r} is over its tokens/sec budget "
                f"({self.token_budget.rate}/s, est {est_tokens} tokens)")
        if self.tenant_inflight:
            with self._lock:
                over = self._inflight.get(key, 0) >= self.tenant_inflight
                if not over:
                    self._inflight[key] = self._inflight.get(key, 0) + 1
            if over:
                raise self._shed(
                    "tenant_limit", f"tenant {key!r} is at its inflight cap "
                    f"({self.tenant_inflight})")
        self._bump("accepted")

    def _release(self, tenant: Optional[str]) -> None:
        if self.tenant_inflight:
            key = tenant or "default"
            with self._lock:
                self._inflight[key] = max(0, self._inflight.get(key, 0) - 1)

    # -- request path ---------------------------------------------------
    def call(self, model: str, *arrays, timeout_s: Optional[float] = None,
             tenant: Optional[str] = None, idempotent: bool = True,
             est_tokens: int = 0):
        """Route one single-example request and return the model's
        output(s). Raises :class:`ShedError` or :class:`DeadlineExceeded`
        (each with ``retry_after``), or the request's own validation error;
        every infrastructure failure in between is retried on a surviving
        replica when ``idempotent``, so an accepted request is never
        dropped silently."""
        return self.call_detailed(model, *arrays, timeout_s=timeout_s,
                                  tenant=tenant, idempotent=idempotent,
                                  est_tokens=est_tokens)[0]

    def call_detailed(self, model: str, *arrays,
                      timeout_s: Optional[float] = None,
                      tenant: Optional[str] = None,
                      idempotent: bool = True,
                      est_tokens: int = 0) -> Tuple[object, Dict]:
        """:meth:`call` and an info dict ``{replica, failovers, retries,
        hedged, latency_ms}``, which splits the failover path's latency
        from the happy path's."""
        t0 = time.perf_counter()
        timeout_s = (self.request_timeout_s if timeout_s is None
                     else float(timeout_s))
        t_deadline = time.monotonic() + timeout_s
        info: Dict = {"replica": None, "failovers": 0, "retries": 0,
                      "hedged": False}
        self._admit(tenant, est_tokens=est_tokens)
        try:
            val = self._call_admitted(model, arrays, t_deadline, idempotent,
                                      info)
        finally:
            self._release(tenant)
        info["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return val, info

    def _call_admitted(self, model: str, arrays, t_deadline: float,
                       idempotent: bool, info: Dict):
        exclude: set = set()
        attempt = 0
        last_err: Optional[BaseException] = None
        while True:
            if time.monotonic() >= t_deadline:
                raise self._deadline(
                    f"request deadline expired before completion "
                    f"(last error: {last_err})")
            rep = self.replicas.pick(exclude)
            if rep is None:
                # nowhere to place now: a restart may rejoin, so back off
                # and open the excluded replicas again, up to the retry
                # cap, then shed explicitly
                if attempt >= self.retries:
                    raise self._shed(
                        "placement_exhausted",
                        f"no replica completed the request after "
                        f"{attempt} retries (last error: {last_err})")
                attempt += 1
                self._bump("retries")
                info["retries"] += 1
                self._backoff(attempt, t_deadline)
                exclude.clear()
                continue
            try:
                fut = rep.submit(model, *arrays)
            except QueueFullError as e:
                last_err = e
                exclude.add(rep.name)
                continue
            except ReplicaUnavailable as e:
                last_err = e
                self._bump("failovers")
                info["failovers"] += 1
                exclude.add(rep.name)
                continue
            try:
                return self._await_result(rep, fut, model, arrays, exclude,
                                          t_deadline, info, idempotent)
            except _InfraFailure as e:
                last_err = e.cause
                self._bump("failovers")
                info["failovers"] += 1
                if isinstance(e.cause, LockOrderError):
                    # a lock-order inversion poisons the whole replica
                    rep.kill(reason=f"lock-order: {e.cause}")
                if not idempotent:
                    self._bump("failed")
                    raise e.cause
                exclude.add(rep.name)
                if attempt < self.retries:
                    attempt += 1
                    self._bump("retries")
                    info["retries"] += 1
                    self._backoff(attempt, t_deadline)
                    continue
                raise self._shed(
                    "retries_exhausted",
                    f"request failed on {attempt + 1} replica(s); last "
                    f"error: {e.cause}")

    def _backoff(self, attempt: int, t_deadline: float) -> None:
        """Capped exponential backoff, never sleeping past the request's
        deadline."""
        delay = min(self.backoff_ms * (2 ** (attempt - 1)), 200.0) / 1e3
        delay = min(delay, max(0.0, t_deadline - time.monotonic()))
        if delay > 0:
            time.sleep(delay)

    @staticmethod
    def _is_infra(exc: BaseException) -> bool:
        """Infrastructure failures (a crashed or stopped replica, a chaos
        kill, lock-order poison, I/O) are retryable on a surviving replica;
        anything else is the request's own error and reaches the caller
        unchanged: retrying a bad request would fail every replica."""
        from ..fault.inject import ChaosCrash
        if isinstance(exc, (ReplicaUnavailable, ChaosCrash, LockOrderError,
                            TimeoutError, ConnectionError, OSError)):
            return True
        return isinstance(exc, MXNetError) and "batcher stopped" in str(exc)

    def _await_result(self, rep: Replica, fut: ServeFuture, model: str,
                      arrays, exclude: set, t_deadline: float, info: Dict,
                      idempotent: bool):
        """Wait for ``fut`` under the request's deadline, racing ONE hedged
        duplicate on a second replica after ``hedge_ms`` (idempotent
        requests only: a hedge runs the request twice)."""
        hedge_at = (time.monotonic() + self.hedge_ms / 1e3
                    if self.hedge_ms > 0 and idempotent else None)
        racers: List[Tuple[Replica, ServeFuture]] = [(rep, fut)]
        hedged = False
        while True:
            now = time.monotonic()
            if now >= t_deadline:
                raise self._deadline(
                    f"replica {rep.name!r} produced no result within the "
                    "request deadline")
            if not hedged and hedge_at is not None and now >= hedge_at:
                hedged = True
                h = self.replicas.pick(exclude | {rep.name})
                if h is not None:
                    try:
                        racers.append((h, h.submit(model, *arrays)))
                        info["hedged"] = True
                        self._bump("hedges")
                    except MXNetError:
                        pass  # hedging is best effort
            for r, f in [t for t in racers if t[1].done()]:
                try:
                    val = f.result(timeout=0)
                except BaseException as e:  # noqa: BLE001 — classified
                    if not self._is_infra(e):
                        raise  # the request's own error: not retryable
                    racers = [t for t in racers if t[1] is not f]
                    if not racers:
                        raise _InfraFailure(e)
                    continue
                if f is not fut:
                    self._bump("hedge_wins")
                info["replica"] = r.name
                self._bump("completed")
                return val
            # block on the oldest racer up to the next event (the hedge's
            # time, the deadline), not spinning
            horizon = t_deadline
            if hedge_at is not None and not hedged:
                horizon = min(horizon, hedge_at)
            elif len(racers) > 1:
                horizon = min(horizon, now + 0.005)
            racers[0][1].wait(max(0.0, horizon - time.monotonic()))

    # -- health loop ----------------------------------------------------
    def _health_loop(self) -> None:
        interval = self.heartbeat_ms / 1e3
        while not self._stop_evt.wait(interval):
            try:
                self.health_check_once()
            except Exception:  # noqa: BLE001 — the loop outlives bugs
                with self._lock:
                    self.health_errors += 1

    def health_check_once(self) -> Dict[str, str]:
        """One heartbeat sweep (the loop's body, callable from tests):
        stall checks of healthy replicas, restarts of crashed or unhealthy
        ones. Returns the state map."""
        for rep in self.replicas:
            hb = rep.heartbeat()
            state = hb["state"]
            if state == "healthy":
                self._check_stall(rep, hb)
            elif state in ("crashed", "unhealthy"):
                self._schedule_restart(rep)
        return self.replicas.states()

    def _check_stall(self, rep: Replica, hb: Dict) -> None:
        """Queued requests and no flush for ``stall_s`` mean the replica is
        wedged (a hung capture, a deadlocked worker): kill it, and the
        restart path and the request retries take over. ``_progress`` is
        the health thread's alone."""
        prev = self._progress.get(rep.name)
        if prev is None or hb["batches"] != prev["batches"] \
                or hb["depth"] == 0:
            self._progress[rep.name] = {"batches": hb["batches"],
                                        "since": hb["ts"]}
            return
        if hb["ts"] - prev["since"] >= self.stall_s:
            self._progress.pop(rep.name, None)
            rep.kill(reason=f"stalled: {hb['depth']} queued, no flush "
                            f"for {self.stall_s:.1f}s")

    def _schedule_restart(self, rep: Replica) -> None:
        if self._stop_evt.is_set():
            return  # a stopping tier must not spawn restarters
        with self._lock:
            if rep.name in self._restarting:
                return
            self._restarting.add(rep.name)
            t = threading.Thread(target=self._restart_replica, args=(rep,),
                                 name=f"mx-serve-restart-{rep.name}",
                                 daemon=True)
            self._restart_threads[rep.name] = t
        t.start()

    def _restart_replica(self, rep: Replica) -> None:
        t0 = time.monotonic()
        try:
            rep.restart()
            with self._lock:
                self.stats["restarts"] += 1
                self.restart_seconds.append(time.monotonic() - t0)
        except Exception:  # noqa: BLE001 — the replica is marked
            # unhealthy; pace the retry so a broken loader cannot hot-loop
            self._stop_evt.wait(self.restart_backoff_s)
        finally:
            with self._lock:
                self._restarting.discard(rep.name)
                self._restart_threads.pop(rep.name, None)

    # -- training-to-serving weight pipe --------------------------------
    def sync_weights_once(self, model: str, ckpt_root: str) -> Dict:
        """Take the newest verified checkpoint under ``ckpt_root`` and
        write it into every healthy replica in place (no capture). Never
        swaps in bad weights: ``load_latest`` walks past checkpoints that
        fail their CRC, and the staging check here refuses non-finite
        float arrays and checkpoints whose names match no parameter.
        Returns an outcome dict."""
        from ..fault import checkpoint as fault_checkpoint
        from .registry import map_checkpoint_arrays
        try:
            arrays, meta, step = fault_checkpoint.load_latest(ckpt_root)
        except fault_checkpoint.CheckpointError as e:
            return {"outcome": "no_checkpoint", "error": str(e)[:200]}
        # "unchanged" must mean an unchanged fleet: a replica that failed
        # the last push or restarted since (its rebuild loads the factory's
        # weights) needs the step pushed again
        fleet = {r.name: r.restarts for r in self.replicas}
        with self._lock:
            prev = self._synced_steps.get((model, ckpt_root))
            if prev is not None and prev["step"] == step \
                    and prev["fleet"] == fleet:
                return {"outcome": "unchanged", "step": step}
        weights = map_checkpoint_arrays(arrays, meta)
        bad = sorted(k for k, v in weights.items()
                     if v.dtype.kind == "f" and not onp.isfinite(v).all())
        if bad:
            return {"outcome": "rejected", "step": step,
                    "reason": "non_finite", "arrays": bad[:4]}
        applied, failed, skipped = [], [], []
        for rep in self.replicas:
            if not rep.healthy():
                skipped.append(rep.name)
                continue
            try:
                rep.push_weights(model, weights)
                applied.append(rep.name)
            except MXNetError as e:
                failed.append({"replica": rep.name, "error": str(e)[:200]})
        if applied:
            with self._lock:
                # the fleet is recorded only when every replica took the
                # push: a partial fleet syncs again each cadence
                if not failed and not skipped:
                    self._synced_steps[(model, ckpt_root)] = {
                        "step": step, "fleet": fleet}
                else:
                    self._synced_steps.pop((model, ckpt_root), None)
                self.stats["weight_syncs"] += 1
        return {"outcome": "applied" if applied else "rejected",
                "step": step, "replicas": applied, "failed": failed}

    def start_weight_sync(self, model: str, ckpt_root: str,
                          interval_s: float) -> None:
        """:meth:`sync_weights_once` every ``interval_s`` on a thread of
        its own (one per model; it stops with the router)."""
        def loop():
            while not self._stop_evt.wait(interval_s):
                try:
                    self.sync_weights_once(model, ckpt_root)
                except Exception:  # noqa: BLE001 — the cadence survives
                    with self._lock:
                        self.health_errors += 1

        with self._lock:
            have = self._sync_threads.get(model)
            if have is not None and have.is_alive():
                return
            t = threading.Thread(target=loop,
                                 name=f"mx-serve-weight-sync-{model}",
                                 daemon=True)
            self._sync_threads[model] = t
        t.start()

    # -- reporting ------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            stats = dict(self.stats)
            inflight = dict(self._inflight)
        return {"replicas": self.replicas.states(),
                "stats": stats, "tenants_inflight": inflight,
                "token_budget": self.token_budget.snapshot(),
                "policy": {"retries": self.retries,
                           "backoff_ms": self.backoff_ms,
                           "hedge_ms": self.hedge_ms,
                           "shed_depth": self.shed_depth,
                           "tenant_inflight": self.tenant_inflight,
                           "tenant_tokens_per_s": self.token_budget.rate,
                           "heartbeat_ms": self.heartbeat_ms,
                           "stall_s": self.stall_s,
                           "request_timeout_s": self.request_timeout_s}}


class _InfraFailure(Exception):
    """A placed request failed for infrastructure reasons: retryable when
    the request is idempotent."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause
