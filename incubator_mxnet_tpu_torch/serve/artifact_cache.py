"""On-disk artifact cache: a restart cold-loads a verified export.

Counterpart: the JAX package's ``serve/artifact_cache.py``. An entry is an
:func:`~.compiled.export_for_serving` bundle (the ``torch.export``
program, the ``.params`` weights and the manifest), so a restarted
:class:`~.replica.Replica` builds its :class:`~.compiled.CompiledModel`
from :class:`~..gluon.SymbolBlock` with no Python model.

Integrity as in ``fault.checkpoint``: every file's CRC-32 goes into
``manifest.json``, an entry is written into a temporary directory on the
same file system and made final by one ``os.replace``, and :meth:`get`
checks every checksum before it hands an entry out: a corrupt entry (bit
rot, a torn write, or the ``corrupt_artifact`` chaos site, which flips a
byte of the largest file on disk) is evicted and reported as a miss, never
served.

The key is (model, version, bucket geometry, torch version): the
geometry digests the table's ladders and the input-axis mapping, and
``torch.__version__`` stands where the JAX package keys its own version,
since a saved program is read by the torch that wrote it. ``stats`` counts
hits, misses, corrupt entries and puts (the ``serve.prewarm`` events and
counters wait for the ``telemetry`` port, ROADMAP queue A item 8).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zlib
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from ..fault import inject
from ..lockcheck import make_lock
from .buckets import BucketTable

__all__ = ["ArtifactCache", "ArtifactCorruptError", "signature_key"]

MANIFEST_FILE = "manifest.json"
_PREFIX = "art"          # files inside an entry: art-symbol.json, ...
_TMP_PREFIX = ".tmp-"


class ArtifactCorruptError(MXNetError):
    """A cached artifact exists but fails CRC/manifest verification."""


def signature_key(table: BucketTable,
                  input_axes: Sequence[Dict[int, str]]) -> str:
    """Digest of the bucket geometry an artifact was exported for: the
    table's named ladders, the per-input axis mapping and the torch
    version (JAX counterpart: ``serve/artifact_cache.py:50``)."""
    doc = {
        "ladders": {name: table.sizes(name) for name in sorted(table.axes)},
        "input_axes": [sorted((int(a), n) for a, n in spec.items())
                       for spec in input_axes],
        "torch": torch.__version__,
    }
    return hashlib.sha1(
        json.dumps(doc, sort_keys=True).encode("utf-8")).hexdigest()[:16]


def _crc_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


class ArtifactCache:
    """Directory of verified ``export_for_serving`` bundles.

    Layout (one directory per entry; the manifest is written last inside
    the temp dir, so a finalized entry always carries its checksums)::

        <root>/<model>/v<version>-<sigkey>/
          manifest.json          # files + CRC32s, input names, key doc
          art-symbol.json        # the export bundle, under one prefix
          art-0000.params
          art-symbol.pt2         # the program every bucket names
    """

    def __init__(self, root: str):
        self.root = root
        self._lock = make_lock("ArtifactCache._lock")
        self.stats = {"hits": 0, "misses": 0, "corrupt": 0, "puts": 0}

    # -- key / paths -----------------------------------------------------
    def entry_dir(self, model: str, version: int, sigkey: str) -> str:
        return os.path.join(self.root, model, f"v{int(version)}-{sigkey}")

    def _note(self, outcome: str) -> None:
        key = {"hit": "hits", "miss": "misses", "corrupt": "corrupt",
               "put": "puts"}[outcome]
        with self._lock:
            self.stats[key] += 1

    # -- write path ------------------------------------------------------
    def put(self, model: str, version: int, block, table: BucketTable,
            input_axes: Sequence[Dict[int, str]],
            input_names: Optional[Sequence[str]] = None) -> str:
        """Export ``block`` (hybridized, one forward recorded) for every
        bucket signature into the cache; returns the artifact prefix to
        load from. Atomic: the entry appears complete or not at all, and
        re-putting an existing key replaces it."""
        from .compiled import export_for_serving
        sigkey = signature_key(table, input_axes)
        final = self.entry_dir(model, version, sigkey)
        # pid+thread id: two restarter THREADS repairing the same evicted
        # key must not rmtree each other's half-written export
        tmp = os.path.join(os.path.dirname(final),
                           f"{_TMP_PREFIX}{os.path.basename(final)}-"
                           f"{os.getpid()}-{threading.get_ident()}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            prefix = os.path.join(tmp, _PREFIX)
            export_for_serving(block, prefix, table, input_axes)
            files = sorted(n for n in os.listdir(tmp)
                           if n != MANIFEST_FILE)
            manifest = {
                "model": model, "version": int(version), "sigkey": sigkey,
                "torch": torch.__version__,
                "input_names": list(input_names or ["data"]),
                "files": {n: _crc_file(os.path.join(tmp, n))
                          for n in files},
            }
            mpath = os.path.join(tmp, MANIFEST_FILE)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            if os.path.isdir(final):
                shutil.rmtree(final)
            try:
                os.replace(tmp, final)
            except OSError:
                if not os.path.isdir(final):
                    raise
                # a concurrent put of the same key won the rename
                # (ENOTEMPTY onto its fresh entry) — both exports came
                # from the same source, so the winner's copy serves
                shutil.rmtree(tmp, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._note("put")
        return os.path.join(final, _PREFIX)

    # -- read path -------------------------------------------------------
    def get(self, model: str, version: int, table: BucketTable,
            input_axes: Sequence[Dict[int, str]]
            ) -> Optional[Tuple[str, Dict]]:
        """Verified lookup → ``(artifact_prefix, manifest)`` on a hit,
        ``None`` on a miss. A corrupt entry (checksum/manifest mismatch —
        including one injected by the ``corrupt_artifact`` chaos site) is
        evicted and reported as a miss, so the caller falls back to the
        source model and repairs the cache with :meth:`put`."""
        sigkey = signature_key(table, input_axes)
        entry = self.entry_dir(model, version, sigkey)
        mpath = os.path.join(entry, MANIFEST_FILE)
        if not os.path.isfile(mpath):
            self._note("miss")
            return None
        if inject.armed("corrupt_artifact") \
                or inject.should("corrupt_artifact"):
            self._bitflip(entry)
        try:
            manifest = self._verify(entry, mpath)
        except (ArtifactCorruptError, OSError):
            # OSError covers a concurrent eviction/replace racing this
            # verify (files vanishing mid-CRC) — a miss, not a crash
            self._note("corrupt")
            shutil.rmtree(entry, ignore_errors=True)
            return None
        self._note("hit")
        return os.path.join(entry, _PREFIX), manifest

    def _verify(self, entry: str, mpath: str) -> Dict:
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise ArtifactCorruptError(
                f"{mpath}: unreadable manifest: {e}") from e
        declared = manifest.get("files", {})
        present = {n for n in os.listdir(entry) if n != MANIFEST_FILE}
        if set(declared) != present:
            raise ArtifactCorruptError(
                f"{entry}: manifest declares {sorted(declared)} but entry "
                f"holds {sorted(present)}")
        for name, crc in declared.items():
            got = _crc_file(os.path.join(entry, name))
            if got != crc:
                raise ArtifactCorruptError(
                    f"{entry}: checksum mismatch for {name!r} "
                    f"(manifest {crc}, file {got})")
        return manifest

    @staticmethod
    def _bitflip(entry: str) -> None:
        """Apply the ``corrupt_artifact`` chaos fault: flip one byte of
        the largest cached file (the weights, in practice) on disk, the
        same damage a torn write or bit rot would do."""
        files = [os.path.join(entry, n) for n in os.listdir(entry)
                 if n != MANIFEST_FILE]
        if not files:
            return
        try:
            victim = max(files, key=os.path.getsize)
            size = os.path.getsize(victim)
            if size == 0:
                return
            with open(victim, "r+b") as f:
                f.seek(size // 2)
                b = f.read(1)
                f.seek(size // 2)
                f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
        except OSError:
            pass  # chaos is best-effort; a racing eviction wins

    def snapshot(self) -> Dict:
        with self._lock:
            return dict(self.stats)
