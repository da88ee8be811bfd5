"""Profiler facade over ``torch.profiler`` with a hierarchical span recorder.

Counterpart: the JAX package's ``profiler.py`` (``:1-488``).

- **The span recorder** (JAX ``:131-292``): every :class:`Scope`/
  :class:`Task`/:class:`Frame` exit appends a named wall-time span with
  its parent (the enclosing scope on this thread) and depth; every
  :meth:`Marker.mark` an instant. Runtime code that times its own phases
  publishes them with :func:`record_span`: ``parallel.ShardedTrainer.step``
  its ``step`` frame and the ``step.place``/``step.dispatch``/
  ``step.device_wait`` segments under it (JAX ``parallel/trainer.py:917``),
  ``fault.checkpoint.save_checkpoint`` a ``checkpoint.save`` span (JAX
  ``fault/checkpoint.py:344``). All timestamps come from one monotonic
  clock anchored to the wall clock once at import, so nested spans nest.
  :func:`span_records`/:func:`dumps` aggregate them (count, total, mean,
  min, max, p50, p95 and p99 per name, the JAX schema); :func:`step_report`
  splits each step frame into its segments plus the un-instrumented
  ``python`` remainder, with the host gap (the frame less its device
  segments and one-off compiles).
- **The MXNet facade** (JAX ``:293-383``): ``set_config(filename=)``,
  ``set_state("run"|"stop")``, ``pause``, ``resume``, ``dump``, ``dumps``.
  ``set_state("run")`` starts ``torch.profiler`` with CPU and, with a
  card, CUDA activity (the JAX package starts ``jax.profiler``; on a card
  it returns after one small launch and :data:`_EDGE_S`); stopping keeps
  the device events (kernels, copies, fills) it saw. CUPTI can miss the
  first milliseconds of a profile's device work: a caller that counts
  kernels runs one uncounted step first.
  :func:`dump` writes one chrome-trace JSON, atomically (a temporary file
  and ``os.replace``), to the configured file: the recent spans as
  complete events on track 1 and the device events on track 2, on the
  same wall-clock timeline.

The JAX package also stamps each span with the telemetry step and the
distributed-trace correlation (``:96-113``), and ``step_report``'s
``memory`` comes from its memory ledger; telemetry is ROADMAP item 8, so
here ``step`` is the one given, ``trace`` is ``None``, and ``memory`` is
the caching allocator's ``torch.cuda.memory_allocated()`` (0 without a
card) with no per-site attribution.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque as _deque
from collections import namedtuple
from typing import Dict, List, Optional

import torch

from .lockcheck import make_lock
from .util import nearest_rank_percentile

__all__ = ["set_config", "set_state", "pause", "resume", "dump", "dumps",
           "Scope", "Task", "Frame", "Marker", "scope", "span_records",
           "reset_spans", "recent_spans", "record_span", "step_report",
           "SpanRecord", "is_running"]

_STATE = {"running": False, "dir": ".", "aggregate": False,
          "started_at": None, "filename": "profile.json", "prof": None}

#: cap per span name so a long-lived server cannot grow without bound; the
#: aggregate counters keep counting past the cap, only raw samples drop
_MAX_SAMPLES_PER_NAME = 8192

_SPAN_LOCK = make_lock("profiler._SPAN_LOCK")
_SPANS: Dict[str, dict] = {}          # name -> {count, total_ms, samples[]}
_MARKERS: List[dict] = []
_MARKERS_DROPPED = [0]                # overflow count past the sample cap
#: device events of the finished ``torch.profiler`` runs since the last
#: ``reset_spans``: ``{"name", "ts", "dur"}`` in wall-clock microseconds
_DEVICE: List[dict] = []

#: one raw span on the shared timeline (JAX ``:77``): ``t_start`` in epoch
#: seconds from ``perf_counter`` and a fixed anchor; ``trace`` is None
#: until telemetry (item 8)
SpanRecord = namedtuple(
    "SpanRecord", ["name", "kind", "t_start", "dur_ms", "parent", "depth",
                   "step", "trace"], defaults=[None])

#: raw span ring for the chrome trace and step_report
_RECENT: "_deque[SpanRecord]" = _deque(maxlen=4096)

#: wall-clock anchor of the span timeline: wall ~ _EPOCH + perf_counter()
_EPOCH = time.time() - time.perf_counter()

_TLS = threading.local()              # per-thread open-scope stack


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _append(rec: SpanRecord) -> None:
    with _SPAN_LOCK:
        ent = _SPANS.get(rec.name)
        if ent is None:
            ent = _SPANS[rec.name] = {
                "kind": rec.kind, "count": 0, "total_ms": 0.0,
                "min_ms": float("inf"), "max_ms": 0.0, "samples": []}
        ent["count"] += 1
        ent["total_ms"] += rec.dur_ms
        ent["min_ms"] = min(ent["min_ms"], rec.dur_ms)
        ent["max_ms"] = max(ent["max_ms"], rec.dur_ms)
        if len(ent["samples"]) < _MAX_SAMPLES_PER_NAME:
            ent["samples"].append(rec.dur_ms)
        _RECENT.append(rec)


def record_span(name: str, dur_ms: float, kind: str = "scope",
                parent: Optional[str] = None, step: Optional[int] = None,
                t0: Optional[float] = None, depth: Optional[int] = None
                ) -> None:
    """Publish one already-measured span (JAX counterpart: ``:162``).
    ``t0`` is the ``time.perf_counter()`` reading at its start (default:
    now less the duration)."""
    if t0 is None:
        t0 = time.perf_counter() - dur_ms / 1e3
    if depth is None:
        depth = 0 if parent is None else 1
    _append(SpanRecord(name, kind, _EPOCH + t0, dur_ms, parent, depth,
                       step, None))


def recent_spans() -> List[SpanRecord]:
    """Newest-last raw :class:`SpanRecord` rows (a bounded ring; the
    aggregates of :func:`span_records` keep the full counts)."""
    with _SPAN_LOCK:
        return list(_RECENT)


def reset_spans() -> None:
    """Drop every recorded span, marker and device event."""
    with _SPAN_LOCK:
        _SPANS.clear()
        _MARKERS.clear()
        _RECENT.clear()
        _DEVICE.clear()
        _MARKERS_DROPPED[0] = 0


def span_records() -> Dict[str, dict]:
    """``{name: {kind, count, total_ms, mean_ms, min_ms, max_ms, p50_ms,
    p95_ms, p99_ms}}`` (JAX counterpart: ``:217``)."""
    out: Dict[str, dict] = {}
    with _SPAN_LOCK:
        for name, ent in _SPANS.items():
            samples = sorted(ent["samples"])
            min_ms = ent["min_ms"] if ent["min_ms"] != float("inf") else 0.0
            row = {"kind": ent["kind"], "count": ent["count"],
                   "total_ms": round(ent["total_ms"], 4),
                   "mean_ms": round(ent["total_ms"] / max(ent["count"], 1),
                                    4),
                   "min_ms": round(min_ms, 4),
                   "max_ms": round(ent["max_ms"], 4)}
            for q in (50, 95, 99):
                p = nearest_rank_percentile(samples, q)
                row[f"p{q}_ms"] = round(p, 4) if p == p else 0.0
            out[name] = row
    return out


#: step_report segments that are device time, not host time
_DEVICE_SEGMENTS = ("device_wait", "compute", "serve.compute")
#: one-off host work that is not a per-step host tax
_ONEOFF_SEGMENTS = ("serve.compile", "compile")


def _memory_segment() -> dict:
    live = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    return {"live_bytes": int(live), "live_arrays": None, "sites": {}}


def step_report(frame: str = "step", emit: bool = False) -> Dict:
    """Host-gap attribution over the recorded frames named ``frame`` (JAX
    counterpart: ``:262``): ``{frame, steps, wall_ms_total, wall_ms_mean,
    segments: {name: {total_ms, mean_ms, count, share_pct}},
    instrumented_pct, host_gap_ms_total, host_gap_ms_mean, memory}``. A
    frame's direct children are its segments (``place``, ``dispatch``,
    ``device_wait`` for the trainer); the remainder is ``python``.
    ``emit`` publishes a telemetry event in the JAX package and is taken
    for its signature (telemetry is item 8)."""
    spans = recent_spans()
    frames = [r for r in spans if r.kind == "frame" and r.name == frame]
    n = len(frames)
    wall_total = sum(r.dur_ms for r in frames)
    segs: Dict[str, dict] = {}
    child_total = 0.0
    pfx = frame + "."
    for r in spans:
        if r.parent != frame:
            continue
        key = r.name[len(pfx):] if r.name.startswith(pfx) else r.name
        ent = segs.setdefault(key, {"total_ms": 0.0, "count": 0})
        ent["total_ms"] += r.dur_ms
        ent["count"] += 1
        child_total += r.dur_ms
    if n:
        segs["python"] = {"total_ms": max(wall_total - child_total, 0.0),
                          "count": n}
    non_gap_ms = 0.0
    for key, ent in segs.items():
        if key in _DEVICE_SEGMENTS or key in _ONEOFF_SEGMENTS:
            non_gap_ms += ent["total_ms"]
        total = ent["total_ms"]
        ent["total_ms"] = round(total, 4)
        ent["mean_ms"] = round(total / max(n, 1), 4)
        ent["share_pct"] = (round(100.0 * total / wall_total, 2)
                            if wall_total else 0.0)
    instrumented = min(child_total, wall_total)
    host_gap = max(wall_total - non_gap_ms, 0.0)
    return {
        "frame": frame,
        "steps": n,
        "wall_ms_total": round(wall_total, 4),
        "wall_ms_mean": round(wall_total / max(n, 1), 4),
        "segments": segs,
        "instrumented_pct": (round(100.0 * instrumented / wall_total, 2)
                             if wall_total else 0.0),
        "host_gap_ms_total": round(host_gap, 4),
        "host_gap_ms_mean": round(host_gap / max(n, 1), 4),
        "memory": _memory_segment(),
    }


# ---------------------------------------------------------------------------
# the MXNet facade over torch.profiler
# ---------------------------------------------------------------------------

def set_config(filename: str = "profile.json", profile_all: bool = False,
               profile_symbolic: bool = True, profile_imperative: bool = True,
               profile_memory: bool = True, profile_api: bool = True,
               aggregate_stats: bool = False, **kwargs) -> None:
    """Takes the reference's keyword arguments; ``filename`` is where
    :func:`dump` writes the chrome-trace JSON."""
    _STATE["filename"] = filename
    _STATE["dir"] = os.path.dirname(os.path.abspath(filename))
    _STATE["aggregate"] = aggregate_stats


def is_running() -> bool:
    return _STATE["running"]


#: seconds a start waits after its own small launch, so that the
#: caller's first kernels are not the first device work a profile sees:
#: on an H100 (torch 2.11) CUPTI at times records nothing of a profile's
#: first ~2 ms of device work (a traced step lost its first kernels, in
#: every try alike); whether this wait alone keeps them is not known
_EDGE_S = 0.05


def _start() -> None:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    if torch.cuda.is_available():
        torch.zeros(1, device=torch.cuda.current_device())
        torch.cuda.synchronize()
        time.sleep(_EDGE_S)
    _STATE["prof"] = prof
    _STATE["running"] = True


def _trace_start_us(prof, fallback_s: float) -> float:
    """The wall-clock microsecond the profile's event times count from."""
    res = getattr(prof.profiler, "kineto_results", None)
    for attr, scale in (("trace_start_ns", 1e-3), ("trace_start_us", 1.0)):
        fn = getattr(res, attr, None)
        if fn is not None:
            return fn() * scale
    return fallback_s * 1e6


def _stop() -> None:
    """Stop the profile and keep its device events."""
    from torch.autograd import DeviceType
    prof = _STATE["prof"]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    base = _trace_start_us(prof, _STATE["started_at"] or time.time())
    events = [{"name": e.name, "ts": base + e.time_range.start,
               "dur": e.time_range.elapsed_us()}
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    with _SPAN_LOCK:
        _DEVICE.extend(events)
    _STATE["prof"] = None
    _STATE["running"] = False


def set_state(state: str = "stop") -> None:
    """``"run"`` starts ``torch.profiler`` (CPU, and CUDA with a card);
    ``"stop"`` stops it and keeps its device events for :func:`dump`."""
    if state == "run" and not _STATE["running"]:
        _STATE["started_at"] = time.time()
        _start()
    elif state == "stop" and _STATE["running"]:
        _stop()


def pause(profile_process: str = "worker") -> None:
    if _STATE["running"]:
        _stop()


def resume(profile_process: str = "worker") -> None:
    if not _STATE["running"]:
        _start()


def _device_events() -> List[dict]:
    with _SPAN_LOCK:
        return list(_DEVICE)


def chrome_trace() -> str:
    """chrome://tracing JSON of the recent spans (``ph: "X"``, track 1,
    parent/depth/step in ``args``) and the device events (track 2), on
    one wall-clock timeline (JAX counterpart: ``telemetry/export.py:289``
    without the bus events of item 8)."""
    trace = []
    for rec in recent_spans():
        args = {"depth": rec.depth}
        if rec.parent is not None:
            args["parent"] = rec.parent
        if rec.step is not None:
            args["step"] = rec.step
        trace.append({"name": rec.name, "cat": rec.kind, "ph": "X",
                      "ts": round(rec.t_start * 1e6, 1),
                      "dur": round(rec.dur_ms * 1e3, 1),
                      "pid": 1, "tid": 1, "args": args})
    for ev in _device_events():
        trace.append({"name": ev["name"], "cat": "device", "ph": "X",
                      "ts": round(ev["ts"], 1), "dur": round(ev["dur"], 1),
                      "pid": 1, "tid": 2, "args": {}})
    return json.dumps({"traceEvents": trace, "displayTimeUnit": "ms"},
                      allow_nan=False)


def dump(finished: bool = True, profile_process: str = "worker") -> str:
    """Stop an active profile and write :func:`chrome_trace` atomically
    to the ``set_config(filename=)`` path; returns the path."""
    if _STATE["running"]:
        set_state("stop")
    path = _STATE["filename"]
    doc = chrome_trace()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(doc)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _sanitize(obj):
    """Strict-JSON values: non-finite floats become None."""
    if isinstance(obj, float):
        return obj if obj == obj and obj not in (float("inf"),
                                                 float("-inf")) else None
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def dumps(reset: bool = False) -> str:
    """JSON of every recorded span (:func:`span_records`) and marker, in
    the JAX document's keys (``trace_dir`` is the directory :func:`dump`
    writes to); ``reset=True`` clears the recorder after rendering."""
    with _SPAN_LOCK:
        markers = list(_MARKERS)
        dropped = _MARKERS_DROPPED[0]
    doc = {"trace_dir": _STATE["dir"],
           "note": "device-level events: dump() merges them with the spans "
                   "into the chrome trace at set_config(filename=)",
           "spans": span_records(),
           "markers": markers,
           "markers_dropped": dropped}
    if reset:
        reset_spans()
    return json.dumps(_sanitize(doc), indent=1, sort_keys=True,
                      allow_nan=False)


class Scope:
    """User annotation scope (JAX counterpart: ``:413``; a
    ``torch.profiler.record_function`` range while it is open). Exiting
    records a named span with its parent scope and depth."""

    _kind = "scope"

    def __init__(self, name: str = "<unk>", step: Optional[int] = None):
        self._name = name
        self._step = step
        self._t0: Optional[float] = None
        self._range = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        _stack().append(self)
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._t0 is None:
            return
        st = _stack()
        parent, depth = None, 0
        if self in st:
            i = len(st) - 1 - st[::-1].index(self)   # last occurrence
            parent = st[i - 1]._name if i > 0 else None
            depth = i
            del st[i]
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        _append(SpanRecord(self._name, self._kind, _EPOCH + self._t0,
                           dur_ms, parent, depth, self._step, None))
        self._t0 = None


def scope(name: str = "<unk>") -> Scope:
    return Scope(name)


class Task(Scope):
    """Named task annotation (reference: ``profiler.Task``)."""

    _kind = "task"

    def __init__(self, name: str = "task", domain=None):
        super().__init__(name)

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__(None, None, None)


class Frame(Task):
    """A per-iteration frame (reference: ``profiler.Frame``): what
    :func:`step_report` aggregates."""

    _kind = "frame"


class Marker:
    """Instant event (reference: ``profiler.Marker.mark``)."""

    def __init__(self, name: str = "marker", domain=None):
        self._name = name

    def mark(self, scope_name: str = "process") -> None:
        with torch.profiler.record_function(f"{self._name}:{scope_name}"):
            pass
        with _SPAN_LOCK:
            if len(_MARKERS) < _MAX_SAMPLES_PER_NAME:
                _MARKERS.append({"name": self._name, "scope": scope_name,
                                 "t": time.time()})
            else:
                _MARKERS_DROPPED[0] += 1
