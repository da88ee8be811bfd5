"""Elastic multi-process control plane: explicit membership over leases.

Counterpart: the JAX package's ``parallel/elastic.py`` (``:1-532``), on
``torch.distributed``'s key-value store instead of the JAX coordination
service. A rank that dies does not raise in its peers: they block in the
next collective until its timeout. This module puts the membership signal
back:

- **Leases**: every process banks a heartbeat lease under
  ``mxtpu/elastic/<generation>/lease/<index>`` every
  ``MXTPU_ELASTIC_HEARTBEAT_S`` seconds (default: a third of the lease),
  a JSON document with the JAX fields (``t``, ``step``, ``beats``,
  ``pid``, ``generation``, ``collective_ms``; the port keeps no goodput
  ledger, so ``collective_ms`` is 0.0). The write overwrites the
  process's own key: never a collective, never waiting on a peer.
- **Detection**: the lease watchdog (a daemon thread that
  ``dist.initialize`` starts when ``MXTPU_ELASTIC=1``) scans the lease
  table each beat. A peer whose newest lease is older than
  ``MXTPU_ELASTIC_LEASE_S`` is a detected loss, and so is a peer that
  never banked one a lease after the watchdog's own start (a grace
  period for a slow rendezvous). :func:`poll` (at the start of every
  ``ShardedTrainer.step``) raises :class:`HostLossError` at the next
  step boundary. The JAX watchdog also writes one flight bundle per dead
  index; flight bundles are telemetry (queue A, item 8), so here
  :func:`check` records what that bundle would hold (``bundles()``) and
  writes none.
- **Recovery**: :func:`recover` restores the trainer from the newest
  complete checkpoint (``ShardedTrainer.restore_checkpoint``, which
  places every global array onto the live mesh) and the data iterator's
  shard boundary (``io.PrefetchIter.restore_shard``) under the new
  membership, and bumps the restore generation, which namespaces the
  lease keys (``MXTPU_ELASTIC_GENERATION`` seeds it across restarts).

The live transport (:class:`StoreTransport`) is a ``torch.distributed``
store. A ``TCPStore`` has no prefix scan and its ``get`` blocks while a
key is missing, so a scan reads ``lease/<i>`` for each ``i < count``,
asking ``check`` before ``get``; and the transport holds a client of its
own to the process group's store (through a lock), so that a beat never
waits behind a blocking rendezvous call of the process group.
Everything is off by default (``MXTPU_ELASTIC`` unset): the trainer's
hook is one list read. :class:`LocalTransport` simulates an N-process pod
in one process, so the detection state machine is a unit test.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

from ..base import MXNetError
from ..lockcheck import make_lock

__all__ = ["HostLossError", "LocalTransport", "StoreTransport", "enabled",
           "configure", "lease_s", "heartbeat_s", "generation",
           "membership", "start", "stop", "active", "beat", "check", "poll",
           "snapshot", "bundles", "recover", "reset"]

_LEASE_PREFIX = "mxtpu/elastic"

_LOCK = make_lock("elastic._LOCK")
_ON_OVERRIDE: Optional[bool] = None
_LEASE_OVERRIDE: Optional[float] = None
_BEAT_OVERRIDE: Optional[float] = None
_TRANSPORT_OVERRIDE: Optional[Any] = None
#: the live transport over the process group's store, made once
_LIVE: List[Optional["StoreTransport"]] = [None]


def _new_state() -> Dict[str, Any]:
    return {
        "thread": None,          # the heartbeat/watchdog daemon
        "stop": None,            # its threading.Event
        "started_at": None,      # wall clock of the watchdog's start
        "beats": 0,              # leases banked by this process
        "stalled_beats": 0,      # beats held back by host_stall chaos
        "lost": set(),           # detected-dead process indices
        "pending": [],           # losses poll() has not raised yet
        "bundled": set(),        # indices already recorded in a bundle
        "bundles": [],           # what each flight bundle would hold
        "leases": {},            # last scanned lease table (idx -> doc)
        "last_scan": None,       # wall clock of the last check()
        "recoveries": 0,         # recover() calls in this process
    }


_S = _new_state()


class HostLossError(MXNetError):
    """A pod member's lease expired: a detected host loss. Carries the
    dead process indices and the membership generation, so the handler
    (or the launcher reading the message) can restart the survivors from
    the last checkpoint instead of hanging in a collective."""

    def __init__(self, lost: List[int], generation: int, lease: float):
        self.lost = sorted(int(p) for p in lost)
        self.generation = int(generation)
        super().__init__(
            f"elastic: host loss detected — process(es) "
            f"{self.lost} missed the {lease:g}s heartbeat lease "
            f"(membership generation {self.generation}). Surviving hosts "
            "recorded the dead index (elastic.bundles()); restart the run "
            "on the survivors and restore with "
            "fault.checkpoint.load_latest (elastic.recover).")


# ---------------------------------------------------------------------------
# knobs (JAX ``util.py:471-486``)
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """Is the control plane on? One environment read (``MXTPU_ELASTIC=1``;
    :func:`configure` overrides)."""
    if _ON_OVERRIDE is not None:
        return _ON_OVERRIDE
    return os.environ.get("MXTPU_ELASTIC", "0") == "1"


def lease_s() -> float:
    """Lease validity window (``MXTPU_ELASTIC_LEASE_S``, default 10): a
    peer whose newest lease is older than this is a detected loss."""
    if _LEASE_OVERRIDE is not None:
        return _LEASE_OVERRIDE
    try:
        return max(0.1, float(os.environ.get("MXTPU_ELASTIC_LEASE_S",
                                             "10")))
    except ValueError:
        return 10.0


def heartbeat_s() -> float:
    """Beat interval (``MXTPU_ELASTIC_HEARTBEAT_S``; default a third of
    the lease, floor 0.05 s): three missed beats expire a lease."""
    if _BEAT_OVERRIDE is not None:
        return _BEAT_OVERRIDE
    raw = os.environ.get("MXTPU_ELASTIC_HEARTBEAT_S", "")
    if raw:
        try:
            return max(0.05, float(raw))
        except ValueError:
            pass
    return max(0.05, lease_s() / 3.0)


def generation() -> int:
    """The restore generation: ``MXTPU_ELASTIC_GENERATION`` (stamped by
    the launcher on each elastic restart) plus this process's
    :func:`recover` count. It namespaces the lease keys and rides the
    checkpoint meta."""
    try:
        base = int(os.environ.get("MXTPU_ELASTIC_GENERATION", "0"))
    except ValueError:
        base = 0
    with _LOCK:
        return base + _S["recoveries"]


def configure(on: Optional[bool] = None,
              lease: Optional[float] = None,
              heartbeat: Optional[float] = None,
              transport: Optional[Any] = None) -> None:
    """Override the environment knobs and (tests, drills) the lease
    transport. With no arguments, clears every override."""
    global _ON_OVERRIDE, _LEASE_OVERRIDE, _BEAT_OVERRIDE, \
        _TRANSPORT_OVERRIDE
    if on is None and lease is None and heartbeat is None \
            and transport is None:
        _ON_OVERRIDE = _LEASE_OVERRIDE = _BEAT_OVERRIDE = None
        _TRANSPORT_OVERRIDE = None
        return
    if on is not None:
        _ON_OVERRIDE = bool(on)
    if lease is not None:
        _LEASE_OVERRIDE = max(0.1, float(lease))
    if heartbeat is not None:
        _BEAT_OVERRIDE = max(0.01, float(heartbeat))
    if transport is not None:
        _TRANSPORT_OVERRIDE = transport


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class StoreTransport:
    """Leases in the process group's ``torch.distributed`` store (module
    docstring): a ``TCPStore`` client of its own to the group's
    rendezvous, or the group's in-process store when it has no TCP
    address (a one-rank group). ``index``/``count``: this process's place
    in the pod (default: its rank and the world's size)."""

    def __init__(self, index: Optional[int] = None,
                 count: Optional[int] = None):
        from . import dist
        rank, world = dist.world()
        self.index = rank if index is None else int(index)
        self.count = world if count is None else int(count)
        self._store = _own_client()
        self._lock = threading.Lock()

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._store.set(key, value)

    def scan(self, prefix: str) -> Dict[str, str]:
        """The leases under ``prefix`` of indices ``0 .. count - 1``:
        ``check`` first, so a missing key is absence, never a wait."""
        out = {}
        with self._lock:
            for i in range(self.count):
                key = prefix + str(i)
                if self._store.check([key]):
                    out[key] = self._store.get(key).decode()
        return out


def _own_client():
    """A client of its own to the process group's store."""
    import torch.distributed as tdist
    from . import dist
    addr = dist.store_address()
    if addr is None:
        if not dist.initialized():
            raise MXNetError("elastic.StoreTransport: no process group; "
                             "call parallel.dist.initialize() first")
        return tdist.distributed_c10d._get_default_store()
    host, port = addr
    return tdist.TCPStore(host, port, is_master=False,
                          timeout=timedelta(seconds=dist.TIMEOUT_S))


class LocalTransport:
    """Dict-backed transport simulating an N-process pod inside one
    process (tests, the detection drills). Share one ``store`` dict across
    N instances, one per simulated process."""

    def __init__(self, store: Optional[Dict[str, str]] = None,
                 index: int = 0, count: int = 1):
        self.store = store if store is not None else {}
        self.index = int(index)
        self.count = int(count)

    def put(self, key: str, value: str) -> None:
        self.store[key] = value

    def scan(self, prefix: str) -> Dict[str, str]:
        return {k: v for k, v in self.store.items()
                if k.startswith(prefix)}


def _transport() -> Optional[Any]:
    """The active transport: a configured override, else the live store
    of a process group of more than one rank (made once), else None (a
    single-member pod)."""
    if _TRANSPORT_OVERRIDE is not None:
        return _TRANSPORT_OVERRIDE
    from . import dist
    if not dist.initialized() or dist.world()[1] <= 1:
        return None
    if _LIVE[0] is None:
        _LIVE[0] = StoreTransport()
    return _LIVE[0]


def membership() -> Tuple[int, int]:
    """``(process_index, process_count)`` as the control plane sees it."""
    t = _transport()
    if t is None:
        from . import dist
        return dist.world()
    return t.index, t.count


def _lease_key_prefix(gen: int) -> str:
    return f"{_LEASE_PREFIX}/{gen}/lease/"


def _dumps(doc) -> str:
    return json.dumps(doc, sort_keys=True, allow_nan=False)


def _loads(blob: str):
    def reject(tok):
        raise ValueError(f"non-strict JSON token {tok!r}")
    return json.loads(blob, parse_constant=reject)


# ---------------------------------------------------------------------------
# heartbeats + detection
# ---------------------------------------------------------------------------

def beat(step: Optional[int] = None) -> bool:
    """Bank one heartbeat lease for this process (an overwrite of its own
    key). Returns False when there is nothing to bank: no transport, or
    the seeded ``host_stall`` chaos knob holds the beat back while the
    process keeps running (the failure the lease watchdog must catch)."""
    t = _transport()
    if t is None:
        return False
    from ..fault import inject as _inject
    if _inject.heartbeat_stalled():
        with _LOCK:
            _S["stalled_beats"] += 1
        return False
    with _LOCK:
        _S["beats"] += 1
        n_beats = _S["beats"]
    doc = {"t": time.time(), "step": step, "beats": n_beats,
           "pid": os.getpid(), "generation": generation(),
           "collective_ms": 0.0}
    try:
        t.put(_lease_key_prefix(generation()) + str(t.index), _dumps(doc))
    except Exception as e:  # noqa: BLE001 - a dying store must not kill
        warnings.warn(f"[elastic] lease write failed: {e}")  # the beater
        return False
    return True


def check(raise_on_loss: bool = True,
          now: Optional[float] = None) -> Dict[str, Any]:
    """Scan the lease table and classify every pod member. Returns the
    membership snapshot; newly expired peers trip the watchdog (a record
    of the flight bundle each would get, once per dead index) and raise
    :class:`HostLossError` unless ``raise_on_loss=False`` (the daemon's
    mode: it leaves the loss for :func:`poll` to raise at the next step
    boundary)."""
    t = _transport()
    if t is None or t.count <= 1:
        return snapshot()
    now = time.time() if now is None else now
    lease = lease_s()
    raw = t.scan(_lease_key_prefix(generation()))
    table: Dict[int, Dict[str, Any]] = {}
    for key, blob in raw.items():
        try:
            idx = int(key.rsplit("/", 1)[-1])
            doc = _loads(blob)
        except (ValueError, TypeError):
            continue
        doc["age_s"] = round(max(now - float(doc.get("t") or 0.0), 0.0), 3)
        table[idx] = doc
    with _LOCK:
        started = _S["started_at"]
        _S["leases"] = table
        _S["last_scan"] = now
        fresh: List[int] = []
        for p in range(t.count):
            if p == t.index or p in _S["lost"]:
                continue
            ent = table.get(p)
            if ent is None:
                # never banked: a loss only a lease after the watchdog's
                # own start, so a slow rendezvous is not a false positive
                if started is not None and now - started > lease:
                    fresh.append(p)
                continue
            if ent["age_s"] > lease:
                fresh.append(p)
        _S["lost"].update(fresh)
        _S["pending"].extend(fresh)
    if fresh:
        _trip(fresh)
    if raise_on_loss:
        poll()
    return snapshot()


def _trip(lost: List[int]) -> None:
    """The detection path: what one flight bundle per dead index would
    hold (JAX ``_trip``: ``reason``, ``site``, the dead index and the
    membership), recorded exactly once per index, so a crash loop
    re-detecting the same corpse records nothing new. No bundle is
    written: flight bundles are telemetry, not ported yet."""
    snap = snapshot()
    for p in sorted(lost):
        with _LOCK:
            first = p not in _S["bundled"]
            _S["bundled"].add(p)
            if first:
                _S["bundles"].append({
                    "reason": "host_loss", "site": "elastic.check",
                    "context": {"lost_process": p}, "membership": snap})


def bundles() -> List[Dict[str, Any]]:
    """The flight bundles the detections would have written (module
    docstring), oldest first."""
    with _LOCK:
        return [dict(b) for b in _S["bundles"]]


def poll() -> None:
    """The trainer's hook: raise :class:`HostLossError` if the watchdog
    detected a loss since the last poll. One list read when nothing
    happened; never any I/O."""
    if not _S["pending"]:
        return
    with _LOCK:
        pending = list(_S["pending"])
        _S["pending"].clear()
    if pending:
        raise HostLossError(pending, generation(), lease_s())


# ---------------------------------------------------------------------------
# the heartbeat daemon
# ---------------------------------------------------------------------------

def start() -> bool:
    """Start the heartbeat/lease-watchdog daemon (idempotent), banking the
    first lease before it returns so a peer scanning right after its own
    start sees this one. False (nothing started) when elastic is off or
    the pod has a single member."""
    if not enabled():
        return False
    t = _transport()
    if t is None or t.count <= 1:
        return False
    with _LOCK:
        th = _S["thread"]
        if th is not None and th.is_alive():
            return True
        _S["started_at"] = time.time()
        stop_ev = _S["stop"] = threading.Event()
    beat()

    def _run() -> None:
        while not stop_ev.wait(heartbeat_s()):
            try:
                beat()
                check(raise_on_loss=False)
            except Exception as e:  # noqa: BLE001 - the watchdog outlives
                warnings.warn(f"[elastic] heartbeat tick failed: {e}")

    th = threading.Thread(target=_run, name="mx-elastic-heartbeat",
                          daemon=True)
    with _LOCK:
        _S["thread"] = th
    th.start()
    return True


def stop() -> None:
    """Stop the daemon (idempotent; ``dist.finalize`` calls it) and drop
    the live transport, whose store dies with the process group."""
    with _LOCK:
        th, ev = _S["thread"], _S["stop"]
        _S["thread"] = _S["stop"] = None
    if ev is not None:
        ev.set()
    if th is not None and th.is_alive():
        th.join(timeout=2.0)
    _LIVE[0] = None


def active() -> bool:
    th = _S["thread"]
    return th is not None and th.is_alive()


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------

def recover(trainer, root: str, data_iter=None,
            step: Optional[int] = None) -> int:
    """The survivor-side restart: restore ``trainer`` from the newest
    complete checkpoint under ``root`` (or ``step``) through
    ``ShardedTrainer.restore_checkpoint`` (global arrays placed onto the
    live mesh, so the ZeRO-1 partition follows the new rank count), then
    ``data_iter``'s shard boundary from the checkpoint meta under the new
    membership (``io.PrefetchIter.restore_shard``), so the resumed stream
    overlaps no consumed sample. Bumps the restore generation and clears
    the old membership's losses. Returns the restored step."""
    restored = trainer.restore_checkpoint(root, step=step)
    meta = getattr(trainer, "last_restore_meta", None) or {}
    if data_iter is not None and meta.get("data_state"):
        idx, count = membership()
        data_iter.restore_shard(meta["data_state"], index=idx, count=count)
    with _LOCK:
        _S["recoveries"] += 1
        # a recovered pod is a new membership: the old generation's dead
        # indices must not poison the new lease table
        _S["lost"].clear()
        _S["pending"].clear()
        _S["bundled"].clear()
        _S["leases"] = {}
    return restored


# ---------------------------------------------------------------------------
# snapshot / reset
# ---------------------------------------------------------------------------

def snapshot() -> Dict[str, Any]:
    """The membership state (JAX: the ``telemetry.snapshot()`` section):
    the lease table with the last heartbeat ages, the elected primary,
    the detected losses and the restore generation."""
    idx, count = membership()
    # knobs resolve before the lock: generation() takes _LOCK itself
    on, act = enabled(), active()
    gen, lease, hb = generation(), lease_s(), heartbeat_s()
    with _LOCK:
        leases = {str(p): dict(doc) for p, doc in
                  sorted(_S["leases"].items())}
        lost = sorted(_S["lost"])
        doc = {
            "enabled": on,
            "active": act,
            "process": {"index": idx, "count": count},
            "generation": gen,
            "lease_s": lease,
            "heartbeat_s": hb,
            "beats": _S["beats"],
            "stalled_beats": _S["stalled_beats"],
            "leases": leases,
            "lost": lost,
            "last_scan": _S["last_scan"],
            # the elected primary under membership change: the lowest
            # surviving index (process 0 unless it is the corpse)
            "elected": next((p for p in range(count) if p not in lost),
                            0),
        }
    return doc


def reset() -> None:
    """Stop the daemon and drop all state, overrides included (tests)."""
    global _S
    stop()
    with _LOCK:
        _S = _new_state()
    configure()
