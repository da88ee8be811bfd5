"""CUDA graphs over the port's kernels: capture, replay and launch counts.

The fused ``parallel.ShardedTrainer`` step and a hybridized Gluon block
(:mod:`...gluon.block`) capture their work once per input signature and
replay it (``torch.cuda.CUDAGraph``), the counterpart of the JAX package's
compiled programs (``parallel/trainer.py:412-515``, ``gluon/block.py:531``):
one host call per step instead of thousands of launches.

A kernel wrapper counts its launches on the host (``launches`` of its
module), and a replay runs no Python. So while :class:`Graph` captures, a
launch is noted in the graph's own tally instead of counted (the work does
not run during a capture), and each replay adds the tally to the counts:
the counts stay those of the kernels that ran. The tally is one for the
process, not per thread, because a captured backward launches its kernels
from autograd's device thread; a launch goes to it when its stream
captures, and captures run one at a time.

A graph draws random numbers from each generator registered with it
(``CUDAGraph.register_generator_state``; the default CUDA generator always
is), so two replays draw two masks. Capture runs on one side stream per
device (:func:`capture_stream`); a first run of the same work on that
stream, before the capture, initialises what the work creates lazily
(cuBLAS handles and workspaces, the kernels' shared-memory attributes).
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Dict, Iterable, Optional

import torch

from ...base import MXNetError

__all__ = ["Graph", "capture_stream", "count_launch",
           "run_on_capture_stream"]

_lock = threading.Lock()
#: held across a first run and a capture on the capture stream: a second
#: one waits for the first (reentrant: a run may build a nested one)
_capture_lock = threading.RLock()
#: what holds :data:`_capture_lock`, for the error of a wait that ends
_holder: Optional[str] = None
#: seconds a run or a capture waits for another thread's to end
CAPTURE_WAIT_S = 300.0
#: the tally of the graph being captured, else None
_tally: Optional[Dict[str, int]] = None
_streams: Dict[int, torch.cuda.Stream] = {}


def count_launch(launches: Dict[str, int], name: str) -> None:
    """Count one launch of kernel ``name`` in ``launches``, or, when it
    goes to a stream that a :class:`Graph` captures, in its tally; a
    launch during some other capture is not counted (it would never be
    replayed through us). Launches of other threads on streams that do
    not capture count as launches while a graph captures."""
    if torch.cuda.is_current_stream_capturing():
        if _tally is not None:
            _tally[name] = _tally.get(name, 0) + 1
    else:
        launches[name] += 1


@contextlib.contextmanager
def _holding(what: str):
    """Hold the capture stream for ``what``; raise :class:`MXNetError`
    naming the holder when it stays held :data:`CAPTURE_WAIT_S`."""
    global _holder
    if not _capture_lock.acquire(timeout=CAPTURE_WAIT_S):
        raise MXNetError(
            f"{what} waited {CAPTURE_WAIT_S:.0f} s for the CUDA capture "
            f"stream, held by {_holder} (a capture that never ends, such "
            "as a staged load left past its deadline, holds it for good)")
    outer, _holder = _holder, (f"thread "
                               f"{threading.current_thread().name!r} ({what})")
    try:
        yield
    finally:
        _holder = outer
        _capture_lock.release()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that captures (and first runs) work on
    ``device``."""
    index = torch.device(device).index or 0
    with _lock:
        s = _streams.get(index)
        if s is None:
            s = _streams[index] = torch.cuda.Stream(device=index)
        return s


class Graph:
    """One captured CUDA graph, with the kernel launches it replays. Its
    memory pool is its own, or ``share``'s: a graph that always replays
    right after ``share`` (a backward after its forward) may reuse the
    memory that ``share`` frees inside its capture."""

    def __init__(self, device: torch.device,
                 generators: Iterable[torch.Generator] = (),
                 share: Optional["Graph"] = None):
        self.device = torch.device(device)
        self.tally: Dict[str, int] = {}
        self.pool = share.pool if share is not None \
            else torch.cuda.graph_pool_handle()
        self._graph = torch.cuda.CUDAGraph()
        for g in {id(g): g for g in generators}.values():
            if g.device.type == "cuda":
                self._graph.register_generator_state(g)

    def capture(self, fn: Callable, warm: Optional[Callable] = None,
                what: str = "a CUDA graph capture"):
        """Capture ``fn()`` on the device's capture stream and return what
        it returned (tensors in the graph's memory, rewritten by every
        replay). ``warm()``, when given, first runs there eagerly (module
        docstring), its launches counted as launches. Launches inside the
        capture go to :attr:`tally`. A capture error raises; nothing falls
        back to running eagerly. The warm run and the capture hold the
        stream together (module docstring; ``what`` names this capture in
        the error of a wait that ends). Other threads may work on other
        streams meanwhile (thread-local capture mode). Python's cyclic
        garbage collector is held off meanwhile: an unreachable graph that
        it destroyed inside the capture would end the capture."""
        global _tally
        stream = capture_stream(self.device)
        with _holding(what):
            if warm is not None:
                _run_on(stream, warm)
            with _lock:
                _tally = self.tally
            try:
                return self._capture_on(stream, fn)
            finally:
                with _lock:
                    _tally = None

    def _capture_on(self, stream: torch.cuda.Stream, fn: Callable):
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread-local capture mode: an input pipeline's thread
            # (io.PrefetchIter, a DataLoader pinning batches) may copy,
            # allocate and record events on its own stream meanwhile,
            # which the global mode counts against this capture
            with torch.cuda.graph(self._graph, pool=self.pool,
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        return out

    def replay(self) -> None:
        """Run the graph on the current stream and count its launches."""
        from . import KERNELS
        self._graph.replay()
        for name, n in self.tally.items():
            KERNELS[name].launches[name] += n


def run_on_capture_stream(device: torch.device, fn: Callable,
                          what: str = "a run on the capture stream"):
    """``fn()`` on the capture stream of ``device``, ordered after the work
    already queued on the current stream and before the work queued after
    it, never beside another thread's capture there; returns what ``fn``
    returned."""
    with _holding(what):
        return _run_on(capture_stream(device), fn)


def _run_on(stream: torch.cuda.Stream, fn: Callable):
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out
