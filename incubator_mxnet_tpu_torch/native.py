"""ctypes bindings of the C++ runtime shim, ``native/mxtpu_native.cc``
(JAX counterpart: ``native.py``, the same C ABI, ``:48-137``).

The shim is no part of either package: it is plain C++ with a C interface
(the reference's ``libmxnet.so`` boundary). The port compiles its own copy
with the system ``g++`` and the flags of ``native/Makefile`` into
``build/native/libmxtpu_native-<hash>.so`` at the root of the checkout, the
hash covering the source and the flags, at the first call that needs it,
never at import. It never runs ``make`` in ``native/``, so the library
there is left as it is. When the library cannot be built (no compiler),
:func:`available` is False and ``recordio`` and the ``DataLoader`` take
their pure-Python paths, as in the JAX package.

Surfaces:

- :class:`NativeRecordReader` / :class:`NativeRecordWriter` /
  :func:`index_build`: the C++ recordio parser (dmlc framing, split
  records with an embedded magic);
- :class:`NativeIm2RecWriter`: im2rec's packing loop (header, framing,
  index) in one call per record;
- :class:`ShmSegment`: named POSIX shared memory, the ``DataLoader``
  workers' transport;
- :class:`NativeEngine`: a host dependency engine (concurrent readers,
  ordered exclusive writers, a task's exception re-raised at the next
  ``wait_all``);
- :func:`params_save` / :func:`params_load`: the dmlc ``.params``
  container.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from .base import MXNetError
from .lockcheck import make_lock

__all__ = ["available", "last_error", "library_path", "NativeRecordReader",
           "NativeRecordWriter", "NativeIm2RecWriter", "index_build",
           "ShmSegment", "NativeEngine", "params_save", "params_load"]

_REPO_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _REPO_ROOT / "native" / "mxtpu_native.cc"
BUILD_DIR = _REPO_ROOT / "build" / "native"
#: ``native/Makefile``'s ``CXXFLAGS`` and link line
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
             "-fvisibility=hidden", "-shared")
LIBS = ("-lrt",)

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = make_lock("native._LOAD_LOCK")
_LOAD_ERROR: Optional[str] = None

_TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libmxtpu_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise MXNetError("no C++ compiler (g++) to build the native shim")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"building the native shim failed (exit "
                         f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    sig = {
        "MXTPUGetLastError": (c.c_char_p, []),
        "MXTPURecordIOWriterCreate": (c.c_void_p, [c.c_char_p]),
        "MXTPURecordIOWriterWrite": (c.c_int, [
            c.c_void_p, c.c_char_p, c.c_uint64, c.POINTER(c.c_uint64)]),
        "MXTPURecordIOWriterTell": (c.c_uint64, [c.c_void_p]),
        "MXTPURecordIOWriterFree": (None, [c.c_void_p]),
        "MXTPURecordIOReaderCreate": (c.c_void_p, [c.c_char_p]),
        "MXTPURecordIOReaderSeek": (c.c_int, [c.c_void_p, c.c_uint64]),
        "MXTPURecordIOReaderNext": (c.c_int64, [
            c.c_void_p, c.POINTER(c.c_char_p), c.POINTER(c.c_int)]),
        "MXTPURecordIOReaderTell": (c.c_uint64, [c.c_void_p]),
        "MXTPURecordIOReaderFree": (None, [c.c_void_p]),
        "MXTPURecordIOIndexBuild": (c.c_int64, [
            c.c_char_p, c.POINTER(c.c_uint64), c.c_int64]),
        "MXTPUIm2RecCreate": (c.c_void_p, [c.c_char_p]),
        "MXTPUIm2RecWrite": (c.c_int, [
            c.c_void_p, c.c_uint64, c.POINTER(c.c_float), c.c_uint32,
            c.c_int, c.c_uint64, c.c_uint64, c.c_char_p, c.c_uint64]),
        "MXTPUIm2RecClose": (c.c_int, [c.c_void_p, c.c_char_p]),
        "MXTPUShmCreate": (c.c_void_p, [c.c_char_p, c.c_uint64]),
        "MXTPUShmAttach": (c.c_void_p, [c.c_char_p, c.c_uint64]),
        "MXTPUShmPtr": (c.c_void_p, [c.c_void_p]),
        "MXTPUShmSize": (c.c_uint64, [c.c_void_p]),
        "MXTPUShmFree": (None, [c.c_void_p, c.c_int]),
        "MXTPUEngineCreate": (c.c_void_p, [c.c_int]),
        "MXTPUEngineNewVar": (c.c_int64, [c.c_void_p]),
        "MXTPUEnginePush": (None, [
            c.c_void_p, _TASK_FN, c.c_void_p, c.POINTER(c.c_int64), c.c_int,
            c.POINTER(c.c_int64), c.c_int]),
        "MXTPUEngineWaitAll": (None, [c.c_void_p]),
        "MXTPUEngineFree": (None, [c.c_void_p]),
        "MXTPUParamsWriterCreate": (c.c_void_p, [c.c_char_p]),
        "MXTPUParamsWriterAdd": (c.c_int, [
            c.c_void_p, c.c_char_p, c.c_int32, c.c_uint32,
            c.POINTER(c.c_int64), c.c_void_p, c.c_uint64]),
        "MXTPUParamsWriterFinish": (c.c_int, [c.c_void_p]),
        "MXTPUParamsWriterFree": (None, [c.c_void_p]),
        "MXTPUParamsReaderCreate": (c.c_void_p, [c.c_char_p]),
        "MXTPUParamsReaderCount": (c.c_int64, [c.c_void_p]),
        "MXTPUParamsReaderGet": (c.c_int, [
            c.c_void_p, c.c_int64, c.POINTER(c.c_char_p),
            c.POINTER(c.c_int32), c.POINTER(c.c_uint32),
            c.POINTER(c.POINTER(c.c_int64)), c.POINTER(c.c_void_p),
            c.POINTER(c.c_uint64)]),
        "MXTPUParamsReaderFree": (None, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _lib() -> ctypes.CDLL:
    """The loaded shim, built first when needed; a failed build raises
    here and on every later call (it is not retried)."""
    global _LIB, _LOAD_ERROR
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is not None:
            return _LIB
        if _LOAD_ERROR is not None:
            raise MXNetError(f"native library unavailable: {_LOAD_ERROR}")
        try:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
        except (MXNetError, OSError, subprocess.SubprocessError) as e:
            _LOAD_ERROR = str(e)
            raise MXNetError(f"native library unavailable: {e}") from e
        _LIB = lib
        return _LIB


def available() -> bool:
    """Is the shim built (or buildable) and loaded?"""
    try:
        _lib()
        return True
    except MXNetError:
        return False


def last_error() -> str:
    return _lib().MXTPUGetLastError().decode()


# ---------------------------------------------------------------------------
# RecordIO
# ---------------------------------------------------------------------------

class NativeRecordWriter:
    """Appends dmlc records; a payload holding the magic is split into
    continuation parts, as dmlc's writer does."""

    def __init__(self, path: str):
        self._h = _lib().MXTPURecordIOWriterCreate(path.encode())
        if not self._h:
            raise MXNetError(last_error())

    def write(self, buf: bytes) -> int:
        """Append one record; returns its byte offset."""
        pos = ctypes.c_uint64()
        if _lib().MXTPURecordIOWriterWrite(self._h, buf, len(buf),
                                           ctypes.byref(pos)) != 0:
            raise MXNetError(last_error())
        return pos.value

    def tell(self) -> int:
        return _lib().MXTPURecordIOWriterTell(self._h)

    def close(self):
        if self._h:
            _lib().MXTPURecordIOWriterFree(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  a finalizer must not raise
            pass


class NativeIm2RecWriter:
    """im2rec's packing loop (reference: ``tools/im2rec.cc``): per record,
    the ``IRHeader``, the dmlc framing and the index entry in one native
    call; :meth:`close` writes the ``.idx`` file. Byte-identical to
    ``recordio.pack`` through ``MXIndexedRecordIO``."""

    def __init__(self, rec_path: str, idx_path: str):
        self._idx_path = idx_path
        self._h = _lib().MXTPUIm2RecCreate(rec_path.encode())
        if not self._h:
            raise MXNetError(last_error())

    def write(self, key: int, label, id_: int, payload: bytes,
              id2: int = 0) -> None:
        import numpy as onp
        multi = isinstance(label, (list, tuple, onp.ndarray))
        labels = [float(x) for x in onp.asarray(label).reshape(-1)] \
            if multi else [float(label)]
        arr = (ctypes.c_float * len(labels))(*labels)
        if _lib().MXTPUIm2RecWrite(self._h, key, arr, len(labels),
                                   int(multi), id_, id2,
                                   payload, len(payload)) != 0:
            raise MXNetError(last_error())

    def close(self):
        if self._h:
            rc = _lib().MXTPUIm2RecClose(self._h, self._idx_path.encode())
            self._h = None
            if rc != 0:
                raise MXNetError(last_error())

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  a finalizer must not raise
            pass


class NativeRecordReader:
    """Reads dmlc records, reassembling split ones."""

    def __init__(self, path: str):
        self._h = _lib().MXTPURecordIOReaderCreate(path.encode())
        if not self._h:
            raise MXNetError(last_error())

    def seek(self, pos: int) -> None:
        _lib().MXTPURecordIOReaderSeek(self._h, pos)

    def read(self) -> Optional[bytes]:
        """The next record, or None at the end of the file."""
        out = ctypes.c_char_p()
        eof = ctypes.c_int()
        n = _lib().MXTPURecordIOReaderNext(self._h, ctypes.byref(out),
                                           ctypes.byref(eof))
        if n < 0:
            raise MXNetError(last_error())
        if eof.value:
            return None
        return ctypes.string_at(out, n)

    def tell(self) -> int:
        return _lib().MXTPURecordIOReaderTell(self._h)

    def close(self):
        if self._h:
            _lib().MXTPURecordIOReaderFree(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  a finalizer must not raise
            pass


def index_build(path: str) -> List[int]:
    """Every record's byte offset: one pass counts (the C function takes a
    NULL buffer for that), a second fills an array of that size."""
    lib = _lib()
    n = lib.MXTPURecordIOIndexBuild(path.encode(), None, 0)
    if n < 0:
        raise MXNetError(last_error())
    if n == 0:
        return []
    arr = (ctypes.c_uint64 * n)()
    n2 = lib.MXTPURecordIOIndexBuild(path.encode(), arr, n)
    if n2 < 0:
        raise MXNetError(last_error())
    return list(arr[:n2])


# ---------------------------------------------------------------------------
# Shared memory
# ---------------------------------------------------------------------------

class ShmSegment:
    """Named POSIX shared memory, viewable as a numpy array without a
    copy. ``create=False`` attaches to a segment another handle (or
    process) made; :meth:`close` unlinks the name when this handle made it,
    unless told otherwise."""

    def __init__(self, name: str, size: int, create: bool = True):
        lib = _lib()
        fn = lib.MXTPUShmCreate if create else lib.MXTPUShmAttach
        self._h = fn(name.encode(), size)
        if not self._h:
            raise MXNetError(last_error())
        self.name = name
        self.size = size
        self._create = create

    def as_numpy(self, shape, dtype):
        """A numpy view of the segment; the view keeps the segment (and
        so the mapping) alive."""
        import numpy as onp

        class _ShmArray(onp.ndarray):
            pass

        ptr = _lib().MXTPUShmPtr(self._h)
        n = int(onp.prod(shape)) * onp.dtype(dtype).itemsize
        if n > self.size:
            raise MXNetError(f"shm segment too small: {n} > {self.size}")
        buf = (ctypes.c_char * n).from_address(ptr)
        arr = onp.frombuffer(buf, dtype=dtype).reshape(shape).view(_ShmArray)
        arr._segment = self
        return arr

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, unlink: Optional[bool] = None):
        """Unmap; unlink the name when ``unlink`` (default: when this
        handle made it). The shim unlinks only for the handle that made
        the segment, so an attached handle unlinks here (the JAX
        package's ``close(unlink=True)`` on an attached handle leaves the
        name in ``/dev/shm``)."""
        if self._h:
            if unlink is None:
                unlink = self._create
            _lib().MXTPUShmFree(self._h, 1 if unlink else 0)
            self._h = None
            if unlink and not self._create:
                import _posixshmem
                try:
                    _posixshmem.shm_unlink(self.name)
                except FileNotFoundError:
                    pass       # unlinked by another handle already

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  a finalizer must not raise
            pass


# ---------------------------------------------------------------------------
# Dependency engine
# ---------------------------------------------------------------------------

class NativeEngine:
    """Host-side asynchronous executor with read and write variables
    (ThreadedEngine semantics: concurrent readers, exclusive writers in
    push order). A task's exception is kept and re-raised at the next
    :meth:`wait_all` or :meth:`close`."""

    def __init__(self, num_workers: int = 0):
        self._h = _lib().MXTPUEngineCreate(num_workers)
        # callbacks stay referenced until wait_all(): freeing one inside
        # its own trampoline would unmap the closure a worker thread is
        # still returning through
        self._keepalive: list = []
        self._lock = make_lock("NativeEngine._lock")
        self._errors: list = []

    def new_var(self) -> int:
        return _lib().MXTPUEngineNewVar(self._h)

    def push(self, fn: Callable[[], None],
             read_vars: Sequence[int] = (),
             write_vars: Sequence[int] = ()) -> None:
        def trampoline(_ctx, _fn=fn):
            try:
                _fn()
            except BaseException as e:  # noqa: BLE001  re-raised at wait_all
                with self._lock:
                    self._errors.append(e)

        cfn = _TASK_FN(trampoline)
        with self._lock:
            self._keepalive.append(cfn)
        rv = (ctypes.c_int64 * max(1, len(read_vars)))(*read_vars)
        wv = (ctypes.c_int64 * max(1, len(write_vars)))(*write_vars)
        _lib().MXTPUEnginePush(self._h, cfn, None, rv, len(read_vars),
                               wv, len(write_vars))

    def _drain(self) -> None:
        with self._lock:
            self._keepalive.clear()
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def wait_all(self) -> None:
        _lib().MXTPUEngineWaitAll(self._h)
        self._drain()

    def close(self):
        """Drain and free; re-raises a task's exception as
        :meth:`wait_all` does."""
        if self._h:
            _lib().MXTPUEngineWaitAll(self._h)
            _lib().MXTPUEngineFree(self._h)
            self._h = None
            self._drain()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  a finalizer must not raise
            pass


# ---------------------------------------------------------------------------
# dmlc .params container
# ---------------------------------------------------------------------------

def params_save(path: str, arrays, names, dtype_flags) -> None:
    """Write the ``kMXAPINDArrayListMagic`` container: ``arrays`` are
    C-contiguous numpy arrays, ``dtype_flags`` their mshadow type flags;
    ``names`` may be shorter than ``arrays`` (an unnamed list save)."""
    lib = _lib()
    h = lib.MXTPUParamsWriterCreate(path.encode())
    if not h:
        raise MXNetError(last_error())
    try:
        for i, (a, flag) in enumerate(zip(arrays, dtype_flags)):
            name = names[i].encode() if i < len(names) else None
            shape = (ctypes.c_int64 * max(1, a.ndim))(*a.shape)
            if lib.MXTPUParamsWriterAdd(
                    h, name, flag, a.ndim, shape,
                    a.ctypes.data_as(ctypes.c_void_p), a.nbytes) != 0:
                raise MXNetError(last_error())
        if lib.MXTPUParamsWriterFinish(h) != 0:
            raise MXNetError(last_error())
    finally:
        lib.MXTPUParamsWriterFree(h)


def params_load(path: str):
    """Read a dmlc ``.params`` container: ``(arrays, names, flags)``, each
    array a ``(shape, raw bytes)`` pair. Raises :class:`MXNetError` on a
    layout the C++ reader does not cover (V1, legacy, sparse)."""
    lib = _lib()
    h = lib.MXTPUParamsReaderCreate(path.encode())
    if not h:
        raise MXNetError(last_error())
    try:
        n = lib.MXTPUParamsReaderCount(h)
        arrays, names, flags = [], [], []
        for i in range(n):
            name = ctypes.c_char_p()
            flag = ctypes.c_int32()
            ndim = ctypes.c_uint32()
            shape_p = ctypes.POINTER(ctypes.c_int64)()
            data_p = ctypes.c_void_p()
            nbytes = ctypes.c_uint64()
            if lib.MXTPUParamsReaderGet(
                    h, i, ctypes.byref(name), ctypes.byref(flag),
                    ctypes.byref(ndim), ctypes.byref(shape_p),
                    ctypes.byref(data_p), ctypes.byref(nbytes)) != 0:
                raise MXNetError(last_error())
            shape = tuple(shape_p[d] for d in range(ndim.value))
            raw = ctypes.string_at(data_p, nbytes.value) if nbytes.value \
                else b""
            arrays.append((shape, raw))
            if name.value is not None:
                names.append(name.value.decode())
            flags.append(flag.value)
        return arrays, names, flags
    finally:
        lib.MXTPUParamsReaderFree(h)
