"""Deterministic chaos injection: the fault runtime's test harness (JAX
counterpart: ``fault/inject.py``).

Every fault the ``mx.fault`` runtime defends against can be injected
deterministically, from seeded per-site streams, so the defences are
ordinary tests:

- **NaN batches** (``nan_batch``): the trainer replaces the first float
  data argument of the batch with NaNs, which reach the loss and every
  gradient through the unchanged step, as a real overflow does.
- **Slow steps** (``slow_step``), **slow input**, **slow replicas** and
  **kvstore delays**: :func:`maybe_delay` sleeps ``delay_s``.
- **Numerics drift** (``grad_blowup``, ``activation_drift``): a seeded
  multiplicative ramp on the batch (:func:`scale_ramp`).
- **Leaks** (``leak``): :func:`maybe_leak` allocates and keeps device
  memory.
- **Decode cache pressure** (``decode_block_exhaustion``): the decode
  block pool raises ``CacheExhausted`` on an allocation.
- **Crash points** (:func:`crash`): a named site (``nd.save`` mid-write,
  ``checkpoint.arrays`` after the arrays and before the manifest,
  ``checkpoint.finalize`` before the atomic rename) raises
  :class:`ChaosCrash`, which for atomicity is what dying there is within
  one process.

Determinism: each site draws from its own ``numpy`` ``RandomState`` seeded
by ``(seed, site)``, so what fires depends only on the seed and the
site's call count, never on the interleaving of sites or threads (one
lock guards the streams); under one seed the draws are the JAX monkey's.
Enable it in code::

    with mx.fault.inject.chaos(seed=7, nan_prob=1.0):
        trainer.step(*batch)        # this step's batch is poisoned

or for a whole run with ``MXTPU_CHAOS="seed=7,nan_prob=0.01,crash=nd.save"``
(parsed by :func:`enable_from_env`, read once at the first hook).

The JAX monkey also publishes each fired draw as a telemetry event and a
counter, and writes a flight bundle before a crash; the telemetry
subsystem is not ported yet, so here the monkey's own ``log`` is the
record.
"""
from __future__ import annotations

import os
import time
import zlib
from typing import Dict, Iterable, Optional

import numpy as onp

from ..base import MXNetError
from ..lockcheck import make_lock

__all__ = ["ChaosMonkey", "ChaosCrash", "chaos", "enable", "disable",
           "active", "enable_from_env", "should", "maybe_delay",
           "maybe_leak", "scale_ramp", "crash", "armed", "poison",
           "note_step", "heartbeat_stalled"]


class ChaosCrash(MXNetError):
    """Raised at an armed crash point: dying at that site."""

    def __init__(self, site: str):
        super().__init__(f"chaos: injected crash at {site!r}")
        self.site = site


class ChaosMonkey:
    """One seeded fault plan (JAX counterpart: ``fault/inject.py:64``).
    The knobs are per-site probabilities in [0, 1]:

    ``nan_prob`` (``should('nan_batch')``), ``kv_drop``, ``slow_prob``
    (``maybe_delay('slow_step')``), ``kv_delay``, ``slow_input``,
    ``replica_kill``, ``slow_replica``, ``corrupt_artifact``,
    ``decode_block_exhaustion``, ``decode_replica_death``, ``leak``
    (``maybe_leak``: keep ``leak_bytes`` of device memory),
    ``collective_divergence``, and the ramps ``grad_blowup`` /
    ``activation_drift`` (each fired draw multiplies the site's scale by
    ``blowup_factor`` / ``drift_factor``). ``host_kill`` and
    ``host_stall`` are step numbers (-1 = off): at that step
    :meth:`note_step` SIGKILLs the process, or :meth:`heartbeat_stalled`
    turns true. ``crash_sites`` names the sites where :meth:`crash`
    raises (and :meth:`armed` consumes without raising), each at most
    ``crash_count`` times, so a retried save can succeed.
    """

    def __init__(self, seed: int = 0, nan_prob: float = 0.0,
                 kv_drop: float = 0.0, slow_prob: float = 0.0,
                 kv_delay: float = 0.0, delay_s: float = 0.0,
                 slow_input: float = 0.0,
                 replica_kill: float = 0.0, slow_replica: float = 0.0,
                 corrupt_artifact: float = 0.0,
                 decode_block_exhaustion: float = 0.0,
                 decode_replica_death: float = 0.0,
                 leak: float = 0.0, leak_bytes: float = 1 << 20,
                 collective_divergence: float = 0.0,
                 grad_blowup: float = 0.0, activation_drift: float = 0.0,
                 blowup_factor: float = 16.0, drift_factor: float = 1.5,
                 host_kill: int = -1, host_stall: int = -1,
                 crash_sites: Iterable[str] = (), crash_count: int = 1):
        self.seed = int(seed)
        self.probs: Dict[str, float] = {
            "nan_batch": float(nan_prob), "kv_drop": float(kv_drop),
            "slow_step": float(slow_prob), "kv_delay": float(kv_delay),
            "slow_input": float(slow_input),
            "replica_kill": float(replica_kill),
            "slow_replica": float(slow_replica),
            "corrupt_artifact": float(corrupt_artifact),
            "decode_block_exhaustion": float(decode_block_exhaustion),
            "decode_replica_death": float(decode_replica_death),
            "leak": float(leak),
            "collective_divergence": float(collective_divergence),
            "grad_blowup": float(grad_blowup),
            "activation_drift": float(activation_drift),
        }
        self.leak_bytes = int(leak_bytes)
        self._ramp_factor: Dict[str, float] = {
            "grad_blowup": float(blowup_factor),
            "activation_drift": float(drift_factor)}
        #: fired draws per ramp site (its scale is factor ** count)
        self._ramp: Dict[str, int] = {}
        #: allocations ``maybe_leak`` keeps for the monkey's lifetime
        self._leaked: list = []
        self.delay_s = float(delay_s)
        self.host_kill_step = int(host_kill)
        self.host_stall_step = int(host_stall)
        self._last_step: Optional[int] = None
        self._armed: Dict[str, int] = {s: int(crash_count)
                                       for s in crash_sites}
        self._streams: Dict[str, onp.random.RandomState] = {}
        self._lock = make_lock("ChaosMonkey._lock")
        #: ``(site, fired)`` in per-site call order: which faults a seed
        #: produced
        self.log: list = []

    def _stream(self, site: str) -> onp.random.RandomState:
        rs = self._streams.get(site)
        if rs is None:
            rs = onp.random.RandomState(
                (self.seed ^ zlib.crc32(site.encode())) & 0x7FFFFFFF)
            self._streams[site] = rs
        return rs

    def should(self, site: str) -> bool:
        """Draw this site's next fault decision (thread-safe)."""
        p = self.probs.get(site, 0.0)
        with self._lock:
            fired = bool(p > 0.0 and self._stream(site).uniform() < p)
            self.log.append((site, fired))
        return fired

    def maybe_delay(self, site: str) -> float:
        """Sleep ``delay_s`` when the site's draw fires; returns the
        delay."""
        if self.should(site) and self.delay_s > 0:
            time.sleep(self.delay_s)
            return self.delay_s
        return 0.0

    def maybe_leak(self, site: str, device=None) -> int:
        """When the ``leak`` draw fires at ``site``, allocate
        ``leak_bytes`` on ``device`` (default: the card if there is one)
        and keep it as long as the monkey lives. Returns the bytes leaked
        by this call (0 when the draw did not fire)."""
        if not self.should("leak"):
            return 0
        import torch
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        n = max(1, self.leak_bytes // 4)
        buf = torch.zeros((n,), dtype=torch.float32, device=device)
        with self._lock:
            self._leaked.append((site, buf))
        return int(n * 4)

    def scale_ramp(self, site: str) -> float:
        """Advance and return ``site``'s multiplicative ramp
        (``grad_blowup`` / ``activation_drift``): each fired draw
        multiplies the running scale by the site's factor. 1.0 while the
        site never fired (or its probability is 0)."""
        p = self.probs.get(site, 0.0)
        if p <= 0.0:
            return 1.0
        if self.should(site):
            with self._lock:
                self._ramp[site] = self._ramp.get(site, 0) + 1
        with self._lock:
            k = self._ramp.get(site, 0)
        return float(self._ramp_factor.get(site, 2.0) ** k) if k else 1.0

    def crash(self, site: str) -> None:
        """Raise :class:`ChaosCrash` if ``site`` is armed (then disarm
        one count)."""
        if self.armed(site):
            raise ChaosCrash(site)

    def armed(self, site: str) -> bool:
        """Consume one armed count for ``site``: the non-raising twin of
        :meth:`crash`, for faults the caller applies itself."""
        with self._lock:
            left = self._armed.get(site, 0)
            if left <= 0:
                return False
            self._armed[site] = left - 1
        return True

    def note_step(self, step: int) -> None:
        """The trainer's per-step hook: record the step (``host_stall``
        reads it) and, at the ``host_kill`` step, SIGKILL this process,
        announced on stderr first."""
        with self._lock:
            self._last_step = int(step)
        if self.host_kill_step >= 0 and int(step) == self.host_kill_step:
            import signal
            import sys
            print(f"[chaos] host_kill firing at step {step}: "
                  f"SIGKILL pid {os.getpid()}", file=sys.stderr,
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    def heartbeat_stalled(self) -> bool:
        """True once the trainer has noted a step at or past
        ``host_stall``."""
        if self.host_stall_step < 0:
            return False
        with self._lock:
            last = self._last_step
        return last is not None and last >= self.host_stall_step

    def poison(self, arr):
        """A NaN-filled copy of ``arr`` (float dtypes only; others come
        back as they are). Tensors stay on their device."""
        if hasattr(arr, "is_floating_point"):
            return arr.new_full(arr.shape, float("nan")) \
                if arr.is_floating_point() else arr
        a = onp.asarray(arr)
        if a.dtype.kind != "f":
            return arr
        return onp.full_like(a, onp.nan)


_ACTIVE: Optional[ChaosMonkey] = None
_ENV_CHECKED = False


def enable(seed: int = 0, **knobs) -> ChaosMonkey:
    """Install a process-wide :class:`ChaosMonkey` and return it."""
    global _ACTIVE
    _ACTIVE = ChaosMonkey(seed=seed, **knobs)
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def enable_from_env() -> Optional[ChaosMonkey]:
    """Parse ``MXTPU_CHAOS`` (comma-separated ``k=v``: ``seed=7,
    nan_prob=0.01,crash=nd.save``; ``crash`` may repeat) and enable it;
    nothing when the variable is unset."""
    spec = os.environ.get("MXTPU_CHAOS")
    if not spec:
        return None
    kw: Dict = {}
    sites = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise MXNetError(f"MXTPU_CHAOS: cannot parse {part!r}")
        k, v = part.split("=", 1)
        k = k.strip()
        if k == "crash":
            sites.append(v.strip())
        elif k in ("seed", "crash_count", "host_kill", "host_stall"):
            kw[k] = int(v)
        else:
            kw[k] = float(v)
    if sites:
        kw["crash_sites"] = sites
    return enable(**kw)


def active() -> Optional[ChaosMonkey]:
    """The installed monkey, or None; reads ``MXTPU_CHAOS`` once."""
    global _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        enable_from_env()
    return _ACTIVE


class chaos:
    """Scoped enable: ``with fault.inject.chaos(seed=7, nan_prob=1.0):``
    installs a monkey and puts back what was active before."""

    def __init__(self, seed: int = 0, **knobs):
        self._kw = dict(seed=seed, **knobs)
        self._prev = None
        self.monkey: Optional[ChaosMonkey] = None

    def __enter__(self) -> ChaosMonkey:
        global _ACTIVE
        self._prev = _ACTIVE
        self.monkey = _ACTIVE = ChaosMonkey(**self._kw)
        return self.monkey

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev


# -- the hooks call sites use: each does nothing while no monkey is on ----

def should(site: str) -> bool:
    m = active()
    return m.should(site) if m is not None else False


def maybe_delay(site: str) -> float:
    m = active()
    return m.maybe_delay(site) if m is not None else 0.0


def maybe_leak(site: str, device=None) -> int:
    m = active()
    return m.maybe_leak(site, device) if m is not None else 0


def scale_ramp(site: str) -> float:
    m = active()
    return m.scale_ramp(site) if m is not None else 1.0


def crash(site: str) -> None:
    m = active()
    if m is not None:
        m.crash(site)


def armed(site: str) -> bool:
    m = active()
    return m.armed(site) if m is not None else False


def poison(arr):
    m = active()
    return m.poison(arr) if m is not None else arr


def note_step(step: int) -> None:
    m = active()
    if m is not None:
        m.note_step(step)


def heartbeat_stalled() -> bool:
    m = active()
    return m.heartbeat_stalled() if m is not None else False
