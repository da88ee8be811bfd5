"""On-disk autotune cache: tuning winners kept per configuration.

Counterpart: the JAX package's ``autotune.py`` (``:1-280``). A winner is a
small dict of runtime knobs (for the port, the flash kernels' tiles
``MXTPU_FLASH_BQ``/``MXTPU_FLASH_BK``) kept per ``(model, mesh shape,
chip)`` key in the JAX entry format: one JSON file per key whose ``crc``
is the CRC-32 of the canonical (sorted-key) JSON of the rest, written to
a temporary file and finalised by one ``os.replace``. A corrupt entry is
evicted and counted as a miss, never applied. So one cache directory is
read and written by both packages; the port writes ``"torch"`` where the
JAX package writes ``"jax"`` (the version that wrote it, outside the key).

:func:`chip_kind` is ``torch.cuda.get_device_name()`` normalised as the
JAX one normalises its device kind (``"nvidia-h100-80gb-hbm3"``), so an
entry banked for a TPU never matches the card.

The consult sites, when ``MXTPU_AUTOTUNE_DIR`` names a directory (and
``MXTPU_AUTOTUNE`` is not ``0``):

- ``parallel.ShardedTrainer`` consults once, before its first step
  (site ``trainer.step``, JAX ``parallel/trainer.py:596-605``), and runs
  every step, fused or eager, under :func:`applied`: the kernels read the
  tile knobs at each launch, so an eager step outside the overlay would
  run other tiles than the fused step captured;
- ``serve.CompiledModel`` consults at construction (site
  ``serve.compiled``) and captures (on the CPU: runs) each bucket under
  :func:`applied` (JAX ``serve/compiled.py:93-105, 286``).

:func:`consult` checks the entry's tile knobs: a value outside
``1..MAX_TILE`` (64, ``ops/cuda/flash_attention.py``) raises
:class:`~.base.MXNetError` there, naming the knob and the limit, before
any step or capture (the JAX search banks ``MXTPU_FLASH_BK`` of 128, 256
and 512, which the port's kernels do not take). User-set environment
variables always win over a cached winner: :func:`applied` fills only the
knobs of :data:`TUNABLE_ENV` that the environment leaves unset. The
telemetry events of a consult and the cache's counters metric are item 8;
:attr:`AutotuneCache.stats` keeps the counts.
"""
from __future__ import annotations

import json
import os
import zlib
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch

from .base import MXNetError
from .lockcheck import make_lock

__all__ = ["AutotuneCache", "AutotuneCorruptError", "default_cache",
           "consult", "applied", "mesh_desc", "chip_kind", "enabled",
           "TUNABLE_ENV", "TILE_ENV"]

#: env knobs a cached winner may carry: the :func:`applied` allow-list, so
#: a corrupt or hostile entry can never set arbitrary variables
TUNABLE_ENV = (
    "MXTPU_FLASH_BK", "MXTPU_FLASH_BQ", "MXTPU_EMBED_ONEHOT_GRAD",
)
#: the knobs that are flash-kernel tiles, checked at :func:`consult`
TILE_ENV = ("MXTPU_FLASH_BQ", "MXTPU_FLASH_BK")

_FORMAT = 1


class AutotuneCorruptError(MXNetError):
    """A cache entry exists but fails CRC or format verification."""


def mesh_desc(mesh=None) -> str:
    """The mesh-shape part of a key: ``"dp2tp4"`` for a mesh with an axis
    of more than one rank, ``"single"`` otherwise; lookups fall back to
    ``"any"``, the key the tuning search banks under."""
    if mesh is None:
        return "single"
    shape = dict(getattr(mesh, "shape", {}) or {})
    if not shape or all(v == 1 for v in shape.values()):
        return "single"
    return "".join(f"{k}{v}" for k, v in sorted(shape.items()))


def chip_kind() -> str:
    """The accelerator kind of the first card (``"cpu"`` without one),
    lower-cased with dashes for spaces: the hardware part of a key."""
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"
    return str(kind).strip().lower().replace(" ", "-")


class AutotuneCache:
    """Directory of verified winners, one JSON file per key
    (``<root>/<model>/<mesh_shape>-<chip>.json``), each ``{"format",
    "model", "mesh", "chip", "torch" (or "jax"), "config": {"env": {...},
    "geometry": {...}}, "score", "meta", "crc"}``."""

    def __init__(self, root: str):
        self.root = root
        self._lock = make_lock("AutotuneCache._lock")
        self.stats = {"hits": 0, "misses": 0, "corrupt": 0, "puts": 0}

    @staticmethod
    def _safe(part: str) -> str:
        keep = [c if (c.isalnum() or c in "._-") else "_" for c in str(part)]
        return "".join(keep) or "_"

    def entry_path(self, model: str, mesh_shape: str, chip: str) -> str:
        return os.path.join(self.root, self._safe(model),
                            f"{self._safe(mesh_shape)}-{self._safe(chip)}"
                            ".json")

    def _note(self, outcome: str) -> None:
        key = {"hit": "hits", "miss": "misses", "corrupt": "corrupt",
               "put": "puts"}[outcome]
        with self._lock:
            self.stats[key] += 1

    @staticmethod
    def _payload_crc(doc: Dict[str, Any]) -> int:
        body = {k: v for k, v in doc.items() if k != "crc"}
        return zlib.crc32(
            json.dumps(body, sort_keys=True).encode("utf-8")) & 0xFFFFFFFF

    def put(self, model: str, mesh_shape: str, chip: str,
            config: Dict[str, Any], score: float,
            meta: Optional[Dict[str, Any]] = None) -> str:
        """Persist one winner atomically; returns the entry path."""
        path = self.entry_path(model, mesh_shape, chip)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        doc = {
            "format": _FORMAT, "model": str(model),
            "mesh": str(mesh_shape), "chip": str(chip),
            "torch": torch.__version__,
            "config": config, "score": float(score),
            "meta": dict(meta or {}),
        }
        doc["crc"] = self._payload_crc(doc)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._note("put")
        return path

    def get(self, model: str, mesh_shape: str = "single",
            chip: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """The verified entry, else None. Falls back from the exact mesh
        key to ``"any"``; a corrupt entry is evicted and counted as a
        miss."""
        chip = chip if chip is not None else chip_kind()
        for mesh_key in dict.fromkeys((mesh_shape, "any")):
            path = self.entry_path(model, mesh_key, chip)
            if not os.path.isfile(path):
                continue
            try:
                entry = self._verify(path)
            except (AutotuneCorruptError, OSError):
                self._note("corrupt")
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            self._note("hit")
            return entry
        self._note("miss")
        return None

    def _verify(self, path: str) -> Dict[str, Any]:
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, ValueError) as e:
            raise AutotuneCorruptError(
                f"{path}: unreadable entry: {e}") from e
        if not isinstance(entry, dict) or entry.get("format") != _FORMAT:
            raise AutotuneCorruptError(
                f"{path}: unknown format {entry.get('format')!r}"
                if isinstance(entry, dict) else f"{path}: not an object")
        if self._payload_crc(entry) != entry.get("crc"):
            raise AutotuneCorruptError(
                f"{path}: checksum mismatch (entry {entry.get('crc')}, "
                f"payload {self._payload_crc(entry)})")
        return entry

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)


def enabled() -> bool:
    """Do builds consult the cache (``MXTPU_AUTOTUNE_DIR`` set and
    ``MXTPU_AUTOTUNE`` not ``0``)?"""
    return bool(os.environ.get("MXTPU_AUTOTUNE_DIR")) \
        and os.environ.get("MXTPU_AUTOTUNE", "1") == "1"


def default_cache() -> Optional[AutotuneCache]:
    """The cache at ``MXTPU_AUTOTUNE_DIR``, or None when consulting is
    off."""
    if not enabled():
        return None
    return AutotuneCache(os.environ["MXTPU_AUTOTUNE_DIR"])


def _env_of(entry: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if not entry:
        return {}
    cfg = entry.get("config", entry)
    return dict(cfg.get("env") or {})


def _check_tiles(entry: Dict[str, Any], where: str) -> None:
    from .ops.cuda.flash_attention import MAX_TILE
    for knob, v in _env_of(entry).items():
        if knob not in TILE_ENV or v is None:
            continue
        try:
            t = int(v)
        except (TypeError, ValueError):
            t = None
        if t is None or not 1 <= t <= MAX_TILE:
            raise MXNetError(
                f"autotune entry {where}: {knob}={v!r} is outside the flash "
                f"kernels' tiles, 1..{MAX_TILE} (MAX_TILE, "
                "ops/cuda/flash_attention.py)")


def consult(site: str, model: str, mesh=None) -> Optional[Dict[str, Any]]:
    """The winning entry for ``model`` on this chip, or None (consulting
    off, or a miss); ``site`` names the caller (``trainer.step``,
    ``serve.compiled``). A tile knob outside ``1..MAX_TILE`` raises
    :class:`~.base.MXNetError` here."""
    cache = default_cache()
    if cache is None:
        return None
    entry = cache.get(model, mesh_desc(mesh))
    if entry is not None:
        _check_tiles(entry, f"for {model!r} at {site}")
    return entry


@contextmanager
def applied(entry: Optional[Dict[str, Any]], force: bool = False):
    """Overlay a winner's knobs on the environment for the scope: only
    keys of :data:`TUNABLE_ENV`, and (unless ``force``) only those the
    user did not set. The values are restored on exit."""
    env = {k: str(v) for k, v in _env_of(entry).items()
           if k in TUNABLE_ENV and v is not None
           and (force or k not in os.environ)}
    saved = {k: os.environ.get(k) for k in env}
    try:
        os.environ.update(env)
        yield env
    finally:
        for k, prev in saved.items():
            if prev is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = prev
