"""Environment-variable catalog for the knobs the port reads, and the
card's peak rate for MFU.

Counterpart: the JAX package's ``util.py`` (``ENV_VARS`` at ``util.py:105``,
``getenv`` at ``util.py:519``, ``parse_size`` and ``hbm_budget_bytes`` at
``util.py:19-52``, ``peak_tflops`` at ``util.py:60-81``). Names and
defaults are the same; only the knobs the port reads are listed. Also the
numpy-semantics switches (``set_np``, ``reset_np``, ``is_np_array``,
``is_np_shape``, ``np_shape``, ``use_np_shape``; JAX ``util.py:540-583``),
with the JAX package's defaults: numpy shape semantics on, the ``mx.np``
array mode off. They are process state that ``mx.npx`` reads back.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Optional

__all__ = ["getenv", "ENV_VARS", "parse_size", "hbm_budget_bytes",
           "peak_tflops", "PEAK_TFLOPS_BY_KIND", "DEFAULT_PEAK_TFLOPS",
           "set_np", "reset_np", "is_np_array", "is_np_shape", "np_shape",
           "use_np_shape", "nearest_rank_percentile"]

#: name -> (default, description)
ENV_VARS: Dict[str, tuple] = {
    "MXTPU_SERVE_DEADLINE_MS": ("5", "Max milliseconds the oldest queued "
                                "request waits before the serve "
                                "DynamicBatcher flushes a partial batch."),
    "MXTPU_SERVE_QUEUE_LIMIT": ("1024", "Bounded serve request-queue size; "
                                "a full queue rejects submits "
                                "(backpressure, QueueFullError)."),
    "MXTPU_SERVE_MAX_BATCH": ("0", "Cap on the coalesced serve batch size; "
                              "0 = the bucket table's largest batch "
                              "bucket."),
    "MXTPU_SERVE_REQUEST_TIMEOUT_S": ("30", "Per-request deadline: the "
                                      "TCP front end and the HA router "
                                      "wait this long for a result, then "
                                      "return a structured "
                                      "deadline_exceeded reply with "
                                      "retry_after instead of a bare "
                                      "exception."),
    "MXTPU_SERVE_HEARTBEAT_MS": ("100", "Router health-check interval: "
                                 "each sweep probes every replica's "
                                 "state, queue depth and flush "
                                 "progress."),
    "MXTPU_SERVE_STALL_S": ("2", "Queued requests with zero flush "
                            "progress for this long mark a replica "
                            "wedged: the router's health loop kills and "
                            "restarts it."),
    "MXTPU_SERVE_RETRIES": ("2", "Failover retries per idempotent "
                            "request: each retry moves to a surviving "
                            "replica with capped exponential backoff; "
                            "exhaustion sheds explicitly with "
                            "retry_after."),
    "MXTPU_SERVE_RETRY_BACKOFF_MS": ("10", "Base backoff between router "
                                     "failover retries (doubles per "
                                     "attempt, capped at 200 ms, never "
                                     "past the request deadline)."),
    "MXTPU_SERVE_HEDGE_MS": ("0", "After this many ms without a result "
                             "the router races ONE hedged duplicate on "
                             "a second healthy replica (first result "
                             "wins); 0 disables hedging."),
    "MXTPU_SERVE_SHED_DEPTH": ("0", "Overload shedding: when EVERY "
                               "healthy replica's queue is at/over this "
                               "depth, new requests are rejected with "
                               "retry_after instead of queueing; 0 "
                               "disables (per-replica backpressure "
                               "still applies)."),
    "MXTPU_SERVE_TENANT_INFLIGHT": ("0", "Per-tenant admission cap: "
                                    "concurrent router requests a single "
                                    "tenant may hold before being shed "
                                    "with retry_after; 0 = unlimited."),
    "MXTPU_SERVE_TENANT_TOKENS_PER_S": ("0", "Per-tenant decode QoS: "
                                        "sustained generated-tokens/sec "
                                        "budget (token bucket); requests "
                                        "whose estimated tokens would "
                                        "breach it are shed with "
                                        "retry_after BEFORE queueing; "
                                        "0 = unlimited."),
    "MXTPU_SERVE_TENANT_TOKEN_BURST": ("0", "Token-bucket burst depth for "
                                       "MXTPU_SERVE_TENANT_TOKENS_PER_S "
                                       "(tokens); 0 = one second's "
                                       "budget."),
    "MXTPU_DECODE_MAX_BATCH": ("8", "Decode batch rows: concurrent "
                               "sequences one DecodeEngine steps per "
                               "token boundary (the fixed shape of the "
                               "captured decode step)."),
    "MXTPU_DECODE_BLOCK_SIZE": ("16", "Tokens per paged-KV-cache page; "
                                "pages are the allocation unit of the "
                                "decode block pool."),
    "MXTPU_DECODE_MAX_TOKENS": ("64", "Generation cap per sequence = "
                                "pages-per-sequence x block size; must "
                                "fit the model's position table."),
    "MXTPU_DECODE_QUEUE_LIMIT": ("256", "Bounded decode request-queue "
                                 "size; past it submit() sheds with "
                                 "QueueFullError (backpressure)."),
    "MXTPU_DECODE_MAX_REQUEUES": ("3", "Cache-pressure admissions bounce "
                                  "back to the queue at most this many "
                                  "times before the stream is shed with "
                                  "CacheExhausted."),
    "MXTPU_HBM_BUDGET": ("", "Per-card device-memory budget in bytes "
                         "(K/M/G/T suffixes and float forms accepted); "
                         "prices the decode engine's KV pool. Unset = no "
                         "memory pricing (capacity = max batch)."),
    "MXTPU_ATTN_IMPL": ("", "Overrides dot_product_attention's impl "
                        "(auto|xla|flash|ring); unset = the caller's impl."),
    "MXTPU_RING_IMPL": ("", "xla = ring attention's hops on the plain "
                        "path; unset = the flash kernels where they take "
                        "the shapes."),
    "MXTPU_ELASTIC": ("0", "Master switch of the elastic control plane "
                      "(parallel.elastic): 1 starts the heartbeat-lease "
                      "daemon at dist.initialize(), so a rank that dies "
                      "is a detected loss (HostLossError at the next "
                      "step) instead of peers blocked in a collective."),
    "MXTPU_ELASTIC_LEASE_S": ("10", "Heartbeat-lease validity window: a "
                              "pod member whose newest lease is older "
                              "than this is a detected host loss."),
    "MXTPU_ELASTIC_HEARTBEAT_S": ("", "Beat interval of the lease daemon; "
                                  "unset = a third of the lease."),
    "MXTPU_ELASTIC_GENERATION": ("0", "Restore-generation counter stamped "
                                 "by the launcher on each elastic "
                                 "restart: namespaces the lease keys and "
                                 "rides the checkpoint meta."),
    "MXTPU_CPU_DEVICES": ("1", "CPU contexts one may name (cpu(0) .. "
                          "cpu(n-1)): torch has one CPU device, and the "
                          "contexts past cpu(0) hold parameter replicas "
                          "in host memory."),
    "MXTPU_ELASTIC_COMMIT_TIMEOUT_S": ("60", "Seconds the primary waits for "
                                       "every rank's commit marker in a "
                                       "multi-process checkpoint save."),
    "MXTPU_FLASH_BQ": ("", "Query rows per flash-attention tile, 1..64; "
                       "unset = 64."),
    "MXTPU_FLASH_BK": ("", "Keys per flash-attention K/V tile, 1..64; "
                       "unset = 64."),
    "MXTPU_AUTOTUNE_DIR": ("", "On-disk autotune cache root. When set, "
                           "ShardedTrainer and serve.CompiledModel "
                           "consult it and run under the banked winner's "
                           "knobs (the flash tiles); user-set variables "
                           "always win. Unset = no consult."),
    "MXTPU_AUTOTUNE": ("1", "0 disables autotune-cache consults even "
                       "when MXTPU_AUTOTUNE_DIR is set."),
    "MXTPU_SPARSE_DENSE_LIMIT": (str(2 * 1024 ** 3), "Bytes a sparse "
                                 "NDArray may materialise densely "
                                 "(nd.sparse is a dense facade); 0 "
                                 "disables the guard."),
    "MXTPU_PEAK_TFLOPS": ("", "Per-card bf16 peak TFLOP/s for MFU; unset = "
                          "by device name (PEAK_TFLOPS_BY_KIND)."),
    "MXTPU_BENCH_WORKLOAD": ("bert", "Workload of the port bench: bert, "
                             "resnet, ssd or frcnn."),
    "MXTPU_BENCH_MODEL": ("bert_12_768_12", "Model of the port bench; "
                          "unset = bert_12_768_12 (bert) or resnet50_v1 "
                          "(resnet)."),
    "MXTPU_BENCH_BATCH": ("8", "Batch size of the port bench; unset = 8 "
                          "(bert, frcnn), 32 (resnet) or 16 (ssd)."),
    "MXTPU_BENCH_IMG": ("224", "Image side of the port bench's resnet, "
                        "ssd and frcnn workloads; unset = 224, 300 for "
                        "ssd."),
    "MXTPU_BENCH_SEQ": ("512", "Sequence length of the port bench."),
    "MXTPU_BENCH_STEPS": ("20", "Timed training steps of the port bench."),
    "MXTPU_BENCH_DROPOUT": ("0.1", "Dropout rate of the port bench's "
                            "BERT."),
    "MXTPU_QUANT_PERCENTILE": ("99.99", "Default |x| percentile kept by "
                               "int8 calibration from Observer tables "
                               "(quantize_net / quantize_model); 100 = "
                               "no outlier clipping."),
    "MXTPU_FUSED_STEP": ("1", "Whole-step capture of parallel."
                         "ShardedTrainer on the card (one CUDA graph "
                         "replay per step); 0 = the eager step."),
}

#: dense bf16 tensor-core peak TFLOP/s per card, keyed by a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA data sheet, SXM part)
PEAK_TFLOPS_BY_KIND = {"H100": 989.0}
#: the peak for a card not in the table (or the CPU): the H100's, the card
#: the port is written for, so a device-blind run stays deterministic
DEFAULT_PEAK_TFLOPS = 989.0


def nearest_rank_percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already sorted list; NaN when empty
    (JAX counterpart: ``util.py:93``): the serving metrics' and the
    profiler's summaries."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def getenv(name: str, default: Optional[str] = None) -> Optional[str]:
    """Read an environment knob, defaulting to its catalog value
    (JAX counterpart: ``util.py:519``)."""
    if default is None and name in ENV_VARS:
        default = ENV_VARS[name][0]
    return os.environ.get(name, default)


def parse_size(s: str) -> int:
    """Byte-size string -> int bytes: plain and float forms (``"123"``,
    ``"16e9"``) and binary suffixes (``"512M"``, ``"16G"``, ``"1.5T"``,
    with an optional trailing ``B``/``iB``) (JAX counterpart:
    ``util.py:19``)."""
    mult = 1
    low = str(s).strip().lower()
    if low.endswith("ib"):
        low = low[:-2]
    elif low.endswith("b"):
        low = low[:-1]
    if low and low[-1] in "kmgt":
        mult = {"k": 1 << 10, "m": 1 << 20,
                "g": 1 << 30, "t": 1 << 40}[low[-1]]
        low = low[:-1]
    try:
        if not low:               # suffix-only input ("B", "iB", "G", " ")
            raise ValueError(low)
        return int(float(low) * mult)
    except ValueError:
        raise ValueError(f"cannot parse byte size {s!r} (want e.g. "
                         "'2000000000', '16e9', '512M', '16G')") from None


def hbm_budget_bytes() -> Optional[int]:
    """``MXTPU_HBM_BUDGET`` parsed by :func:`parse_size`, or None when it
    is unset (JAX counterpart: ``util.py:45``)."""
    raw = getenv("MXTPU_HBM_BUDGET")
    return parse_size(raw) if raw else None


def peak_tflops() -> float:
    """Per-card bf16 peak TFLOP/s for MFU accounting:
    ``MXTPU_PEAK_TFLOPS`` when set, else by the name of CUDA device 0 in
    :data:`PEAK_TFLOPS_BY_KIND`, else :data:`DEFAULT_PEAK_TFLOPS` (JAX
    counterpart: ``util.py:68``)."""
    env = os.environ.get("MXTPU_PEAK_TFLOPS")
    if env:
        return float(env)
    import torch
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""
    return next((v for k, v in PEAK_TFLOPS_BY_KIND.items() if k in kind),
                DEFAULT_PEAK_TFLOPS)


# --- numpy-semantics switches (JAX counterpart: ``util.py:540-583``) -------
_NP_SHAPE = [True]    # numpy shape semantics are the native behaviour
_NP_ARRAY = [False]


def is_np_shape() -> bool:
    return _NP_SHAPE[0]


def is_np_array() -> bool:
    return _NP_ARRAY[0]


def set_np(shape: bool = True, array: bool = True) -> None:
    _NP_SHAPE[0] = shape
    _NP_ARRAY[0] = array


def reset_np() -> None:
    set_np(True, False)


class np_shape:
    """Scope with numpy shape semantics set to ``active``."""

    def __init__(self, active: bool = True):
        self._active = active
        self._prev = None

    def __enter__(self):
        self._prev = _NP_SHAPE[0]
        _NP_SHAPE[0] = self._active
        return self

    def __exit__(self, *exc):
        _NP_SHAPE[0] = self._prev


def use_np_shape(fn):
    """``fn`` run under :class:`np_shape`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with np_shape(True):
            return fn(*args, **kwargs)
    return wrapped
