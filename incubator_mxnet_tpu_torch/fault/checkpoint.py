"""Atomic, versioned, resumable checkpoint directories (JAX counterpart:
``fault/checkpoint.py``), in the JAX package's on-disk layout, so that each
package reads the other's checkpoints::

    <root>/
      step-0000000010/
        manifest.json        # format, step, meta, per-array shape/dtype/crc
        arrays.params        # one dmlc .params container (upstream format)
      step-0000000020/
      .tmp-step-0000000030-<pid>/     # a save in flight (readers skip it)

A checkpoint directory exists complete and verified, or not at all: the
arrays and the manifest go into a temporary directory on the same
filesystem, which is fsync'd and then renamed into place; retention keeps
the newest ``keep`` steps and removes stale temporaries.
:func:`load_checkpoint` verifies each array's CRC-32 before returning, and
:func:`load_latest` walks back past corrupt steps to the newest that
verifies.

The value layer is ``{name: numpy array}`` plus a JSON ``meta`` dict;
bfloat16 arrays travel as :data:`~..ndarray.serialization.BFLOAT16` (the
raw bits, named ``"bfloat16"`` in the manifest, as the JAX package names
them). The trainers own what goes in (``parallel.ShardedTrainer.
save_checkpoint``, ``gluon.Trainer.save_checkpoint``).

With more than one process the writer follows the JAX package's
multi-host commit protocol (``:261-420``): every rank writes its shard
(``arrays-p<i>.params``) and a fsync'd commit marker into one shared
staging directory; the primary waits for every marker (bounded by
``commit_timeout_s``, ``MXTPU_ELASTIC_COMMIT_TIMEOUT_S``, 60 s), checks
that arrays written by several ranks agree bit for bit, and writes the
manifest last, before the one rename. A save torn by a rank's death leaves
a staging directory without a manifest, which no reader sees. The reader
takes that layout from either package.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import warnings
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as onp

from ..base import MXNetError
from ..ndarray.serialization import BFLOAT16, byte_view
from . import inject

__all__ = ["save_checkpoint", "load_checkpoint", "load_latest",
           "list_checkpoints", "CheckpointError", "CheckpointCorruptError",
           "FORMAT_VERSION", "ARRAYS_FILE", "MANIFEST_FILE"]

FORMAT_VERSION = 1
ARRAYS_FILE = "arrays.params"
MANIFEST_FILE = "manifest.json"
_STEP_PREFIX = "step-"
_TMP_PREFIX = ".tmp-"
_OLD_SUFFIX = ".replaced"


class CheckpointError(MXNetError):
    """No usable checkpoint (missing directory, no completed step)."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint directory exists but fails verification (a bad
    manifest, a checksum mismatch, a truncated arrays file)."""


def _recover(root: str) -> None:
    """Heal a same-step replace that died between its two renames: the
    complete old copy sits at ``step-N.replaced`` with no ``step-N``;
    rename it back so the checkpoint is visible again."""
    if not os.path.isdir(root):
        return
    for name in os.listdir(root):
        if not name.endswith(_OLD_SUFFIX):
            continue
        final = os.path.join(root, name[:-len(_OLD_SUFFIX)])
        old = os.path.join(root, name)
        if _parse_step(name[:-len(_OLD_SUFFIX)]) is None:
            continue
        try:
            if not os.path.isdir(final) \
                    and os.path.isfile(os.path.join(old, MANIFEST_FILE)):
                os.replace(old, final)
            else:
                shutil.rmtree(old, ignore_errors=True)
        except OSError:
            pass  # the next reader tries again


def _step_dirname(step: int) -> str:
    if step < 0:
        raise CheckpointError(f"checkpoint step must be >= 0, got {step}")
    return f"{_STEP_PREFIX}{step:010d}"


def _parse_step(name: str) -> Optional[int]:
    if not name.startswith(_STEP_PREFIX):
        return None
    try:
        return int(name[len(_STEP_PREFIX):])
    except ValueError:
        return None


def _crc(a: onp.ndarray) -> int:
    return zlib.crc32(byte_view(onp.ascontiguousarray(a))) & 0xFFFFFFFF


def array_dtype(a: onp.ndarray) -> str:
    """The dtype name of a checkpoint array (``"bfloat16"`` for the raw
    bits of either package's bfloat16)."""
    return "bfloat16" if a.dtype == BFLOAT16 else a.dtype.name


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # no O_RDONLY directories here: the rename is still atomic
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def list_checkpoints(root: str) -> List[int]:
    """Completed checkpoint steps under ``root``, ascending. A step counts
    only if its manifest exists (the last file a save writes before the
    rename; temporary directories never appear)."""
    if not os.path.isdir(root):
        return []
    _recover(root)
    steps = []
    for name in os.listdir(root):
        step = _parse_step(name)
        if step is None:
            continue
        if os.path.isfile(os.path.join(root, name, MANIFEST_FILE)):
            steps.append(step)
    return sorted(steps)


def _write_json(path: str, doc: dict) -> None:
    """Write ``doc`` under a temporary name and rename it to ``path``: a
    rank's commit marker appears whole or not at all to the primary that
    polls for it."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _finalize_rename(root: str, tmp: str, final: str) -> None:
    inject.crash("checkpoint.finalize")   # died before the atomic rename
    if os.path.isdir(final):
        # a same-step replace: os.replace cannot clobber a non-empty
        # directory, so the old copy moves aside first, under a name
        # _recover() renames back if the second rename never happens
        old = final + _OLD_SUFFIX
        shutil.rmtree(old, ignore_errors=True)
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)
    _fsync_dir(root)


def _world() -> Tuple[int, int]:
    """``(process_index, process_count)``: ``torch.distributed``'s rank and
    world size once it is initialised, else the dmlc launcher's variables
    (JAX counterpart: ``parallel/dist.py:108``)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    try:
        idx = int(os.environ.get("DMLC_WORKER_ID", "0") or 0)
        n = int(os.environ.get("DMLC_NUM_WORKER", "1") or 1)
    except ValueError:
        return 0, 1
    return idx, max(n, 1)


def save_checkpoint(root: str, arrays: Dict[str, onp.ndarray],
                    meta: Optional[dict] = None, *, step: int,
                    keep: Optional[int] = 3,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None,
                    commit_timeout_s: Optional[float] = None) -> str:
    """Write one atomic checkpoint for ``step`` and return its directory.

    ``arrays`` maps names to host arrays; ``meta`` must be JSON-
    serialisable. ``keep`` prunes to the newest ``keep`` completed steps
    after a successful save (None keeps all). Saving an existing step
    again replaces it atomically. Crash sites: ``checkpoint.arrays``
    (after the arrays, before the manifest or marker),
    ``checkpoint.manifest`` (the primary, before the manifest) and
    ``checkpoint.finalize`` (before the rename); each leaves only a
    staging directory, which no reader sees.

    With more than one process (``process_count``, else
    ``torch.distributed``'s world size or ``DMLC_NUM_WORKER``) each rank
    passes the arrays it writes, and the multi-host protocol runs (module
    docstring); a rank other than the primary returns after its marker. A
    lone process with a non-zero rank writes nothing, as in the JAX
    package (only the primary writes)."""
    t_save0 = time.perf_counter()
    meta = dict(meta or {})
    widx, wcount = _world()
    idx = widx if process_index is None else int(process_index)
    count = wcount if process_count is None else int(process_count)
    final = os.path.join(root, _step_dirname(step))
    if count > 1:
        _save_multihost(root, arrays, meta, step=step, idx=idx, count=count,
                        timeout_s=(_commit_timeout_s()
                                   if commit_timeout_s is None
                                   else commit_timeout_s))
        if idx != 0:
            return final
    elif idx != 0:
        return final
    else:
        os.makedirs(root, exist_ok=True)
        tmp = os.path.join(
            root, f"{_TMP_PREFIX}{_step_dirname(step)}-{os.getpid()}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            host, entries = _write_entries(arrays)
            from ..ndarray.serialization import dmlc_save
            dmlc_save(os.path.join(tmp, ARRAYS_FILE),
                      list(host.values()), list(host.keys()))
            inject.crash("checkpoint.arrays")   # died: arrays, no manifest
            manifest = {"format": FORMAT_VERSION, "step": int(step),
                        "meta": meta, "arrays": entries}
            _write_json(os.path.join(tmp, MANIFEST_FILE), manifest)
            _fsync_dir(tmp)
            _finalize_rename(root, tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    if keep is not None:
        _prune(root, keep)
    from .. import profiler as _prof
    _prof.record_span("checkpoint.save",
                      (time.perf_counter() - t_save0) * 1e3, t0=t_save0)
    return final


def _shard_file(idx: int) -> str:
    return f"arrays-p{idx}.params"


def _marker_file(idx: int) -> str:
    return f"commit-p{idx}.json"


def _commit_timeout_s() -> float:
    from ..util import getenv
    try:
        return max(0.1, float(getenv("MXTPU_ELASTIC_COMMIT_TIMEOUT_S")))
    except ValueError:
        return 60.0


def _write_entries(arrays: Dict[str, onp.ndarray]
                   ) -> Tuple[Dict[str, onp.ndarray], Dict[str, dict]]:
    host = {name: onp.asarray(a) for name, a in arrays.items()}
    entries = {name: {"shape": list(a.shape), "dtype": array_dtype(a),
                      "crc32": _crc(a)} for name, a in host.items()}
    return host, entries


def _save_multihost(root: str, arrays: Dict[str, onp.ndarray], meta: dict,
                    *, step: int, idx: int, count: int,
                    timeout_s: float) -> str:
    """The shard half of the commit protocol (every rank) and the manifest
    half (the primary; JAX counterpart: ``_save_multihost``, ``:353``)."""
    final = os.path.join(root, _step_dirname(step))
    # one staging directory every rank shares, named by the step alone,
    # on the final name's filesystem (the rename stays atomic)
    tmp = os.path.join(root, f"{_TMP_PREFIX}{_step_dirname(step)}-shared")
    os.makedirs(tmp, exist_ok=True)
    host, entries = _write_entries(arrays)
    from ..ndarray.serialization import dmlc_save
    try:
        dmlc_save(os.path.join(tmp, _shard_file(idx)),
                  list(host.values()), list(host.keys()))
        inject.crash("checkpoint.arrays")   # died after shard, no marker
        marker = {"format": FORMAT_VERSION, "step": int(step),
                  "process": {"index": idx, "count": count},
                  "arrays": entries}
        _write_json(os.path.join(tmp, _marker_file(idx)), marker)
        _fsync_dir(tmp)
    except BaseException:
        # a rank that fails removes only its own files
        for f in (_shard_file(idx), _marker_file(idx)):
            try:
                os.unlink(os.path.join(tmp, f))
            except OSError:
                pass
        raise
    if idx != 0:
        return final
    markers = _gather_markers(tmp, count, timeout_s, step)
    merged = _merge_marker_entries(markers, step)
    inject.crash("checkpoint.manifest")  # died between shards and manifest
    manifest = {"format": FORMAT_VERSION, "step": int(step), "meta": meta,
                "arrays": merged,
                "shards": {str(p): {"file": _shard_file(p),
                                    "arrays": sorted(markers[p]["arrays"])}
                           for p in sorted(markers)}}
    _write_json(os.path.join(tmp, MANIFEST_FILE), manifest)
    _fsync_dir(tmp)
    _finalize_rename(root, tmp, final)
    return final


def _gather_markers(tmp: str, count: int, timeout_s: float,
                    step: int) -> Dict[int, dict]:
    """The primary's commit barrier: poll the staging directory until
    every rank's marker is there (each is the last file its rank fsyncs);
    a rank that never writes it is a timeout naming its index, not a
    hang."""
    deadline = time.monotonic() + timeout_s
    while True:
        missing = [p for p in range(count) if not os.path.isfile(
            os.path.join(tmp, _marker_file(p)))]
        if not missing:
            break
        if time.monotonic() >= deadline:
            raise CheckpointError(
                f"multi-host checkpoint commit for step {step} timed out "
                f"after {timeout_s:g}s: process(es) {missing} never wrote "
                "their shard commit marker (died mid-shard or never reached "
                "the save); the torn save stays in its staging directory, "
                "which no reader sees")
        time.sleep(0.05)
    markers: Dict[int, dict] = {}
    for p in range(count):
        with open(os.path.join(tmp, _marker_file(p))) as f:
            markers[p] = json.load(f)
    return markers


def _merge_marker_entries(markers: Dict[int, dict],
                          step: int) -> Dict[str, dict]:
    """The manifest's array table from the ranks' markers; an array that
    several ranks wrote must carry the same bytes in each (else the ranks
    diverged, and the save refuses to commit either copy)."""
    merged: Dict[str, dict] = {}
    for p in sorted(markers):
        for name, ent in markers[p].get("arrays", {}).items():
            if name in merged:
                if merged[name]["crc32"] != ent["crc32"]:
                    raise CheckpointError(
                        f"multi-host checkpoint for step {step}: ranks "
                        f"wrote different bytes for array {name!r} (crc "
                        f"{merged[name]['crc32']} vs process {p}'s "
                        f"{ent['crc32']}); refusing to commit")
                continue
            merged[name] = dict(ent, file=_shard_file(p))
    return merged


def _prune(root: str, keep: int) -> None:
    steps = list_checkpoints(root)
    for step in steps[:-keep] if keep > 0 else steps:
        shutil.rmtree(os.path.join(root, _step_dirname(step)),
                      ignore_errors=True)
    for name in os.listdir(root):
        if name.startswith(_TMP_PREFIX):
            # stale directories of saves that died: never loadable
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def load_checkpoint(root: str, step: int, verify: bool = True
                    ) -> Tuple[Dict[str, onp.ndarray], dict, int]:
    """Load one step as ``(arrays, meta, step)``, checksum-verified unless
    ``verify=False``. Raises :class:`CheckpointCorruptError` on any
    disagreement between the manifest and the arrays. Takes single-host
    directories and the JAX package's multi-host ones (each array read
    from the shard the manifest names)."""
    _recover(root)
    path = os.path.join(root, _step_dirname(step))
    mpath = os.path.join(path, MANIFEST_FILE)
    if not os.path.isfile(mpath):
        raise CheckpointError(f"no completed checkpoint for step {step} "
                              f"under {root!r}")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{mpath}: unreadable manifest: {e}") from e
    if manifest.get("format") != FORMAT_VERSION:
        raise CheckpointCorruptError(
            f"{mpath}: unsupported checkpoint format "
            f"{manifest.get('format')!r} (this build reads "
            f"{FORMAT_VERSION})")
    from ..ndarray.serialization import dmlc_load
    declared = manifest.get("arrays", {})
    # single-host manifests name no file per array (all live in
    # ARRAYS_FILE); multi-host ones name the shard of the host that wrote
    # each, and a shard may hold more names than the manifest gives it
    by_file: Dict[str, List[str]] = {}
    for name, ent in declared.items():
        by_file.setdefault(ent.get("file", ARRAYS_FILE), []).append(name)
    if not by_file:
        by_file[ARRAYS_FILE] = []
    arrays: Dict[str, onp.ndarray] = {}
    for fname in sorted(by_file):
        apath = os.path.join(path, fname)
        try:
            values, names = dmlc_load(apath)
        except (OSError, MXNetError) as e:
            raise CheckpointCorruptError(f"{apath}: {e}") from e
        held = dict(zip(names, values))
        missing = [n for n in by_file[fname] if n not in held]
        if missing:
            raise CheckpointCorruptError(
                f"{path}: container {fname} is missing declared "
                f"array(s) {sorted(missing)}")
        if fname == ARRAYS_FILE and "shards" not in manifest:
            arrays.update(held)
        else:
            for n in by_file[fname]:
                arrays[n] = held[n]
    if set(arrays) != set(declared):
        raise CheckpointCorruptError(
            f"{path}: manifest declares {sorted(declared)} but arrays file "
            f"holds {sorted(arrays)}")
    for name, ent in declared.items():
        a = arrays[name]
        # the dmlc container writes 0-d arrays as shape (1,); the manifest
        # keeps the shape (same bytes, same checksum)
        if list(a.shape) != ent["shape"]:
            if a.size == int(onp.prod(ent["shape"], dtype=onp.int64)):
                a = arrays[name] = a.reshape(ent["shape"])
            else:
                raise CheckpointCorruptError(
                    f"{path}: array {name!r} is {array_dtype(a)}{a.shape}, "
                    f"manifest says {ent['dtype']}{tuple(ent['shape'])}")
        if verify:
            if array_dtype(a) != ent["dtype"]:
                raise CheckpointCorruptError(
                    f"{path}: array {name!r} is {array_dtype(a)}{a.shape}, "
                    f"manifest says {ent['dtype']}{tuple(ent['shape'])}")
            if _crc(a) != ent["crc32"]:
                raise CheckpointCorruptError(
                    f"{path}: checksum mismatch for array {name!r}")
    return arrays, manifest.get("meta", {}), int(manifest["step"])


def load_latest(root: str, verify: bool = True
                ) -> Tuple[Dict[str, onp.ndarray], dict, int]:
    """Load the newest checkpoint that verifies, walking back past corrupt
    steps (each skip warns). Raises :class:`CheckpointError` when nothing
    under ``root`` loads: the caller decides whether a cold start will
    do."""
    steps = list_checkpoints(root)
    if not steps:
        raise CheckpointError(f"no completed checkpoints under {root!r}")
    last_err: Optional[Exception] = None
    for step in reversed(steps):
        try:
            return load_checkpoint(root, step, verify=verify)
        except CheckpointCorruptError as e:
            warnings.warn(f"skipping corrupt checkpoint step {step}: {e}")
            last_err = e
    raise CheckpointError(
        f"all {len(steps)} checkpoints under {root!r} failed verification; "
        f"last error: {last_err}")
