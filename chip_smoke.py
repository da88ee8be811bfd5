#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run (non-zero exit, no result line):

1. card: name and power limit (``nvidia-smi``); no CUDA device -> error;
2. build: every CUDA kernel of the port from the sources in the checkout,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, in float32 and bfloat16: the forward at every sequence bucket the
   serving path gives it (ragged key mask with an empty row, no mask,
   causal, causal + window), at the training shape with every key valid,
   across lengths, under a key mask that is not a prefix (keys only in the
   middle tile, a row with none) and with small tiles; the two backward
   kernels (dK/dV, dQ) at the training shape and at masked, causal,
   windowed, cross-length, ragged and small-tile cases; with per-shape
   times of the kernel (CUDA events, and device time from
   ``torch.profiler``), the plain version, one PyTorch library call as a
   yardstick (SDPA, never used by the port; the forward's by events and
   in device time, the backward's in device time) and the least time the
   card could take (the bound);
4. serve: BERT-base (``bert_12_768_12``, full width and depth, float32,
   seeded random weights) through ``serve.CompiledModel`` over the
   ``{"batch": (1, 32), "seq": (8, 512)}`` bucket table and
   ``serve.DynamicBatcher`` (5 ms deadline), fed ragged requests from four
   client threads; the forward kernel must have launched on that run and
   the backward kernels not, and served outputs must match unbatched
   forwards on the plain attention path;
5. profile: one serving forward at the largest bucket, timed with CUDA
   events and split by kernel with ``torch.profiler``;
6. train: the port bench (``incubator_mxnet_tpu_torch/bench.py``, the
   configuration of ``bench.py``'s default workload: BERT-base pretraining
   in bfloat16, dropout 0.1, batch 8, sequence 512, AdamW with fp32 master
   weights) through the fused ``ShardedTrainer`` step (one CUDA-graph
   replay per step, the default) and the eager step, timed in turns:
   each path's step ms, tokens/s, captures, graphs per step and losses;
   the fused path's JSON line; every step's loss finite and the last below
   the first; each of the three kernels launched 12 times per step,
   replays counted; then one step of each split by kernel with
   ``torch.profiler`` (wall ms, device ms, idle share);
7. train gate: the fused step against the eager one on the bench's
   configuration at full width and 2 layers, under
   ``torch.use_deterministic_algorithms``: at dropout 0, 3 steps' losses
   and the weights after them equal to 1e-5 of each parameter's largest
   value; at dropout 0.1, whether the captured masks are the eager ones;
8. train gradients: one step's parameter gradients of a 2-layer BERT at
   full width (float32, dropout 0) on the kernels, against the same step
   on the plain attention path (``MXTPU_ATTN_IMPL=xla``);
9. gluon: the MXNet Gluon loop on the port's ``mx.nd``, ``autograd`` and
   ``gluon.Trainer`` (multi-tensor Adam): BERT-base (float32, dropout 0.1)
   initialised with ``net.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
   force_reinit=True)``, the bench's batch as ``mx.nd`` arrays on the
   card, plain and ``net.hybridize()``-d (CUDA graphs for the forward and
   the backward); 2 warm and 5 timed steps of each of
   ``autograd.record()`` -> ``loss.backward()`` -> ``trainer.step(1)``:
   every loss finite and the last below the first, each kernel launched 12
   times per step; step ms and tokens/s of both in turns with the
   forward/backward/update split, beside ``ShardedTrainer``'s on the same
   model and optimizer; a hybridized (replayed) backward's gradients
   against those ``ShardedTrainer.step`` leaves (2 layers at full width,
   dropout 0); a ``.params`` round trip (``save_parameters`` ->
   ``load_parameters`` into a fresh model) whose forward is bitwise equal,
   and ``save_states`` / ``load_states`` restoring the update count.

The last three lines are the ``kernels`` JSON line, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as onp
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, bench, gluon, models, nd
from incubator_mxnet_tpu_torch import parallel, serve
from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
from incubator_mxnet_tpu_torch.ops.cuda import _build
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.util import getenv

# Published peaks of one H100 SXM (NVIDIA data sheet, dense) and HBM3
# bandwidth. bf16: the tensor cores' 989 TFLOP/s. float32: the fastest rate
# at fp32 accuracy, the TF32 tensor cores' 495 TFLOP/s over the three
# products of the 3xTF32 split (all three kernels run it).
PEAK_OPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# forward kernel vs plain version, on the card: (atol, rtol). float32: the
# kernel's two products run in 3xTF32 on the tensor cores (about fp32
# accuracy: each operand is a TF32 pair, the lo.lo term is dropped) and its
# online softmax over 64-key tiles sums in another order than the plain
# version's GEMMs; in bfloat16 the output's own rounding (one ulp is 2**-8
# relative) and P's rounding at another running maximum dominate.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}
LSE_ATOL = 1e-4
# backward kernels vs plain backward, on the card: (atol, rtol). float32:
# the kernels' products run in 3xTF32 on the tensor cores (about fp32
# accuracy: each operand is a TF32 pair, the lo.lo term is dropped) and sum
# up to 512 query rows (dQ: 512 keys) in another order than the plain
# version's GEMMs, so errors are no longer 0; bfloat16: one ulp of the
# output (2**-8..2**-7 relative), P and dS rounded at the same places.
TOL_BWD = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}
# train gradients on the kernels vs on the plain attention path, float32:
# another summation order and another formula for the softmax gradient
# (delta = rowsum(dO o) against autograd through softmax), through two
# layers: per parameter, max abs err <= GRAD_RTOL * max |grad|
GRAD_RTOL = 1e-3
# served (padded, batched, flash kernel) vs unbatched (plain attention)
# forwards of BERT-base in float32 without TF32: other GEMM shapes and the
# kernel's summation order, through 12 layers
SERVE_ATOL = 1e-3

SEQ_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
# serving phase: 320 ragged requests, paced at 160 req/s over 4 clients
# (about half the measured capacity), then all at once
N_REQUESTS, OFFERED_RATE = 320, 160.0
HEADS, HEAD_DIM = 12, 64
# the training phase's attention shape: bench.py's batch 8, sequence 512
TRAIN_SHAPE = (8, 512)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, target_ms: float = 40.0) -> float:
    """Mean device time of ``fn`` over enough launches to fill about
    ``target_ms``, measured with CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    iters = int(min(200, max(5, target_ms / max(e0.elapsed_time(e1), 1e-3))))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the time of the CUDA kernels it
    launches, from ``torch.profiler`` over ``reps`` calls after a warm-up,
    over ``reps``. Host time between launches is not counted, so a call
    that the host cannot keep fed reads the same as one that it can. The
    profiler now and then records no device event at all; such a trace is
    taken again, up to three times."""
    for _ in range(3):
        fn()
    for _ in range(3):
        _, per_kernel = device_split(lambda: [fn() for _ in range(reps)])
        if per_kernel:
            break
    return sum(per_kernel.values()) / reps


def visible_pairs(B, Lq, Lk, key_mask, causal, window, device) -> int:
    """(query, key) pairs the softmax sees: the work this run's data needs."""
    vis = torch.ones((B, Lq, Lk), dtype=torch.bool, device=device)
    if key_mask is not None:
        vis &= key_mask.bool()[:, None, :]
    if causal:
        vis &= fa._band(Lq, Lk, window, device)[None]
    return int(vis.sum().item())


def bound_ms(B, H, Lq, Lk, D, dtype, pairs, masked) -> tuple:
    """Least time for the work: the larger of operations over the peak for
    the input type and bytes (q, k, v, mask read once; o, lse written once)
    over HBM bandwidth."""
    e = torch.tensor([], dtype=dtype).element_size()
    ops = 4.0 * H * D * pairs
    nbytes = B * H * (2 * Lq + 2 * Lk) * D * e + B * H * Lq * 4
    if masked:
        nbytes += B * Lk * 4
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_case(gen, dtype, B, Lq, Lk, case, timed, results):
    """Kernel vs plain version on one shape; returns its result record."""
    D, H, dev = HEAD_DIM, HEADS, "cuda"
    q = torch.randn(B, H, Lq, D, device=dev, generator=gen).to(dtype)
    k = torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
    v = torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
    key_mask, causal, window = None, False, None
    if case in ("mask", "full"):
        vl = torch.randint(1, Lk + 1, (B,), device=dev, generator=gen)
        if case == "full":     # the training path: every key valid
            vl[:] = Lk
        else:
            vl[0] = 0          # rows that see no key: o is the mean of V
            vl[-1] = Lk
        key_mask = (torch.arange(Lk, device=dev)[None] < vl[:, None]
                    ).to(torch.int32)
    elif case == "holes":
        # not a prefix: batch 0 keeps no key, batch 1 only the keys of the
        # second 64-key tile, the others a random half
        key_mask = (torch.rand(B, Lk, device=dev, generator=gen) < 0.5
                    ).to(torch.int32)
        key_mask[0] = 0
        key_mask[1] = 0
        key_mask[1, 64:128] = 1
    elif case in ("causal", "causal_window"):
        causal = True
        window = max(1, Lk // 4) if case == "causal_window" else None
    scale = D ** -0.5
    o, lse = fa._fwd(q, k, v, key_mask, causal, scale, window)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, key_mask, causal, scale,
                                            window)
    err = (o.float() - ro.float()).abs().max().item()
    atol, rtol = TOL[dtype]
    check(torch.allclose(o.float(), ro.float(), atol=atol, rtol=rtol),
          f"{fa.KERNEL} {dtype} B={B} Lq={Lq} Lk={Lk} {case}: max abs err "
          f"{err} beyond atol={atol} rtol={rtol}")
    seen = rlse > -1e29      # rows that see at least one key
    if seen.any():
        lerr = (lse - rlse)[seen].abs().max().item()
        check(lerr <= LSE_ATOL, f"{fa.KERNEL} lse err {lerr} ({case})")
    check(bool((lse[~seen] <= -1e29).all()), f"{fa.KERNEL}: lse of a row "
          f"that sees no key above -1e29 ({case})")
    if key_mask is not None and not key_mask[0].any():
        mean_v = v[0].float().mean(dim=-2, keepdim=True).to(dtype).float()
        check(torch.allclose(o[0].float(), mean_v.expand(o[0].shape),
                             atol=atol, rtol=rtol),
              f"{fa.KERNEL}: a row that sees no key must give the mean of V")
    rec = {"kernel": fa.KERNEL, "dtype": str(dtype).replace("torch.", ""),
           "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D, "case": case,
           "max_abs_err": err}
    if timed:
        pairs = visible_pairs(B, Lq, Lk, key_mask, causal, window, dev)
        b_ms, b_by = bound_ms(B, H, Lq, Lk, D, dtype, pairs,
                              key_mask is not None)
        attn_mask = (key_mask.bool()[:, None, None, :]
                     if key_mask is not None else None)

        def kern():
            fa._fwd(q, k, v, key_mask, causal, scale, window)

        def sdpa():
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask)

        rec.update(
            ms=cuda_ms(kern), device_ms=device_ms(kern),
            plain_ms=cuda_ms(lambda: fa.flash_attention_reference(
                q, k, v, key_mask, causal, scale, window)),
            library_ms=cuda_ms(sdpa), library_device_ms=device_ms(sdpa),
            bound_ms=b_ms, bound_by=b_by)
        print(f"  {rec['dtype']:8s} B={B:2d} L={Lq:3d} {case:6s} "
              f"kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f})  "
              f"plain {rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} "
              f"ms (device {rec['library_device_ms']:.4f})  bound "
              f"{b_ms:.4f} ms ({b_by})  err {err:.2e}", flush=True)
    results.append(rec)
    return rec


def phase_kernels(results) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels: flash_attention_fwd vs flash_attention_reference "
          f"(f32 atol/rtol {TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]})",
          flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for L in SEQ_BUCKETS:
            for case in ("mask", "none", "causal", "causal_window"):
                kernel_case(gen, dtype, 8, L, L, case, case == "mask",
                            results)
        kernel_case(gen, dtype, 8, 128, 256, "causal", False, results)
        kernel_case(gen, dtype, 8, 512, 512, "holes", False, results)
        # the training path's shape: every key valid, nothing skipped
        kernel_case(gen, dtype, *TRAIN_SHAPE, TRAIN_SHAPE[1], "full", True,
                    results)
    # small tiles: many K/V tiles per block and a ragged last one
    os.environ["MXTPU_FLASH_BQ"], os.environ["MXTPU_FLASH_BK"] = "16", "48"
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("mask", "holes", "causal_window"):
                kernel_case(gen, dtype, 8, 512, 512, case, False, results)
    finally:
        del os.environ["MXTPU_FLASH_BQ"], os.environ["MXTPU_FLASH_BK"]
    # the largest bucket the serving phase runs
    main = kernel_case(gen, torch.float32, 32, 512, 512, "mask", True,
                       results)
    return main


def bwd_bound_ms(B, H, Lq, Lk, D, dtype, pairs, masked) -> dict:
    """Least time of each backward kernel: the larger of the operations the
    data needs (dK/dV: 8 per visible pair and head dim, four products; dQ:
    6, three products) over the peak for the input type, and the bytes
    (q, k, v, dO, lse, delta, mask read once; dK and dV, or dQ, written
    once) over HBM bandwidth."""
    e = torch.tensor([], dtype=dtype).element_size()
    reads = B * H * (2 * Lq + 2 * Lk) * D * e + 2 * B * H * Lq * 4
    if masked:
        reads += B * Lk * 4
    out = {}
    for name, ops, writes in ((fa.KERNEL_BWD_DKV, 8.0, 2 * B * H * Lk * D * e),
                              (fa.KERNEL_BWD_DQ, 6.0, B * H * Lq * D * e)):
        t_ops = ops * H * D * pairs / PEAK_OPS[dtype] * 1e3
        t_bytes = (reads + writes) / PEAK_BYTES * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def bwd_case(gen, dtype, B, Lq, Lk, case, timed, results):
    """Both backward kernels vs their plain versions on one shape; returns
    {kernel name: result record}."""
    D, H, dev = HEAD_DIM, HEADS, "cuda"
    q, do = (torch.randn(B, H, Lq, D, device=dev, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    key_mask, causal, window = None, False, None
    if case in ("mask", "full"):
        vl = torch.randint(1, Lk + 1, (B,), device=dev, generator=gen)
        if case == "full":     # the training path: every key valid
            vl[:] = Lk
        else:
            vl[0] = 0          # a row that sees no key: dQ must be 0
            vl[-1] = Lk
        key_mask = (torch.arange(Lk, device=dev)[None] < vl[:, None]
                    ).to(torch.int32)
    elif case in ("causal", "causal_window"):
        causal = True
        window = max(1, Lk // 4) if case == "causal_window" else None
    scale = D ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, key_mask, causal, scale,
                                          window)
    delta = fa._delta(o, do)
    args = (q, k, v, key_mask, causal, scale, window, lse, do, delta)
    dk, dv = fa._bwd_dkv_cuda(*args)
    dq = fa._bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    rdk, rdv = fa.flash_attention_bwd_dkv_reference(*args)
    rdq = fa.flash_attention_bwd_dq_reference(*args)
    atol, rtol = TOL_BWD[dtype]
    errs = {}
    for name, pairs in ((fa.KERNEL_BWD_DKV, ((dk, rdk, "dk"), (dv, rdv, "dv"))),
                        (fa.KERNEL_BWD_DQ, ((dq, rdq, "dq"),))):
        errs[name] = 0.0
        for got, want, label in pairs:
            err = (got.float() - want.float()).abs().max().item()
            check(torch.allclose(got.float(), want.float(), atol=atol,
                                 rtol=rtol),
                  f"{name} {label} {dtype} B={B} Lq={Lq} Lk={Lk} {case}: "
                  f"max abs err {err} beyond atol={atol} rtol={rtol}")
            errs[name] = max(errs[name], err)
    if case == "mask":
        check(bool((dq[0] == 0).all()), f"{fa.KERNEL_BWD_DQ}: a row that "
              "sees no key must give exactly 0")
    base = {"dtype": str(dtype).replace("torch.", ""), "B": B, "H": H,
            "Lq": Lq, "Lk": Lk, "D": D, "case": case}
    recs = {name: dict(base, kernel=name, max_abs_err=err)
            for name, err in errs.items()}
    if timed:
        pairs = visible_pairs(B, Lq, Lk, key_mask, causal, window, dev)
        bounds = bwd_bound_ms(B, H, Lq, Lk, D, dtype, pairs,
                              key_mask is not None)
        # yardstick: SDPA forward + backward minus SDPA forward, on the
        # same inputs (one library call computes dQ, dK and dV together),
        # in device time: autograd's host work between the launches would
        # otherwise be timed with it; the visibility goes in as a boolean
        # mask, since SDPA's is_causal aligns the band top-left where the
        # port aligns it bottom-right
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        attn_mask = fa._visible(q, Lk, key_mask, causal, window)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def sdpa_fwd_bwd():
            out = sdpa(*leaves, attn_mask=attn_mask, scale=scale)
            torch.autograd.grad(out, leaves, do)

        sdpa_bwd = (device_ms(sdpa_fwd_bwd)
                    - device_ms(lambda: sdpa(*leaves, attn_mask=attn_mask,
                                             scale=scale)))
        timing = {
            fa.KERNEL_BWD_DKV: (lambda: fa._bwd_dkv_cuda(*args),
                                lambda: fa.flash_attention_bwd_dkv_reference(
                                    *args)),
            fa.KERNEL_BWD_DQ: (lambda: fa._bwd_dq_cuda(*args),
                               lambda: fa.flash_attention_bwd_dq_reference(
                                   *args))}
        for name, (kern, plain) in timing.items():
            b_ms, b_by = bounds[name]
            recs[name].update(ms=cuda_ms(kern), device_ms=device_ms(kern),
                              plain_ms=cuda_ms(plain), library_ms=sdpa_bwd,
                              bound_ms=b_ms, bound_by=b_by)
            r = recs[name]
            print(f"  {name:24s} {r['dtype']:8s} B={B} Lq={Lq} Lk={Lk} "
                  f"{case:6s} "
                  f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
                  f"plain {r['plain_ms']:.4f} ms  "
                  f"sdpa bwd {sdpa_bwd:.4f} ms (device)  bound {b_ms:.4f} ms "
                  f"({b_by})  err {r['max_abs_err']:.2e}", flush=True)
    results.extend(recs.values())
    return recs


def phase_kernels_bwd(results) -> dict:
    """The backward kernels on every case; returns the timed float32
    records at the training shape, by kernel name."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    print("kernels: flash_attention_bwd_dkv / _dq vs their plain versions "
          f"(f32 atol/rtol {TOL_BWD[torch.float32]}, bf16 "
          f"{TOL_BWD[torch.bfloat16]})", flush=True)
    B, L = TRAIN_SHAPE
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ("full", "mask", "causal", "causal_window"):
            recs = bwd_case(gen, dtype, B, L, L, case, case == "full",
                            results)
            if dtype == torch.float32 and case == "full":
                main = recs
        bwd_case(gen, dtype, B, 128, 256, "causal", True, results)
        bwd_case(gen, dtype, B, 100, 100, "mask", True, results)
    # small tiles: many tiles per block and a ragged last one
    os.environ["MXTPU_FLASH_BQ"], os.environ["MXTPU_FLASH_BK"] = "16", "48"
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("mask", "causal_window"):
                bwd_case(gen, dtype, B, L, L, case, False, results)
    finally:
        del os.environ["MXTPU_FLASH_BQ"], os.environ["MXTPU_FLASH_BK"]
    return main


def drive(batcher, cm, reqs, gaps) -> dict:
    """Submit every request from 4 client threads (client ``c`` sends
    requests c, c+4, ... after the given gaps) and wait for all results."""
    n = len(reqs)
    futures = [None] * n
    errors = []
    batcher.metrics.reset()

    def client(idx):
        try:
            for i in range(idx, n, 4):
                if gaps[i]:
                    time.sleep(gaps[i])
                futures[i] = batcher.submit(*reqs[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(not errors, f"submit failed: {errors[:3]}")
    outs = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - t0
    snap = batcher.metrics.snapshot(cm)
    print(f"serve: {json.dumps(snap)}", flush=True)
    check(snap["requests"] == n and snap["failed"] == 0,
          f"served {snap['requests']}/{n}, failed {snap['failed']}")
    check(snap["compile_cache"]["post_warmup_compiles"] == 0,
          f"post-warmup compiles: "
          f"{snap['compile_cache']['post_warmup_compiles']}")
    return {"outs": outs, "wall_s": wall, "snapshot": snap}


def phase_serve(n_requests: int, rate: float, seed: int) -> dict:
    t0 = time.perf_counter()
    model = models.get_bert("bert_12_768_12", vocab_size=30522,
                            max_length=512, use_decoder=False,
                            use_classifier=False, device="cuda")
    spec = models.serve_spec("bert_encoder")
    table = serve.BucketTable({"batch": (1, 32), "seq": (8, 512)})
    example = (onp.zeros((1, 8), "int32"), onp.zeros((1, 8), "int32"),
               onp.zeros((1,), "float32"))
    cm = serve.CompiledModel(model, table, spec["input_axes"], example,
                             output_axes=spec["output_axes"],
                             pad_values=spec["pad_values"])
    print(f"serve: model built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    warm = cm.warmup()
    print(f"serve: warmup {warm}", flush=True)

    rng = onp.random.RandomState(seed)
    reqs = []
    for _ in range(n_requests):
        L = int(rng.randint(4, 512))
        reqs.append((rng.randint(1, 30522, L).astype("int32"),
                     (onp.arange(L) >= L // 2).astype("int32"),
                     onp.array(L, "float32")))
    gaps = rng.exponential(4.0 / rate, n_requests)  # per client: rate / 4

    batcher = serve.DynamicBatcher(cm, max_delay_ms=5.0)
    cuda_ops.reset_launches()
    batcher.start()
    try:
        # paced: 4 clients with seeded exponential gaps; burst: the same
        # requests all at once (the batcher's capacity)
        runs = {"paced": drive(batcher, cm, reqs, gaps),
                "burst": drive(batcher, cm, reqs, onp.zeros(n_requests))}
    finally:
        batcher.stop()
    launches = cuda_ops.launch_counts()
    batches = sum(r["snapshot"]["batches"] for r in runs.values())
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    check(launches[fa.KERNEL] >= n_layers * batches > 0,
          f"{fa.KERNEL} launched {launches[fa.KERNEL]} times for "
          f"{batches} batches of {n_layers} layers")
    for name in (fa.KERNEL_BWD_DKV, fa.KERNEL_BWD_DQ):
        check(launches[name] == 0, f"serving (inference_mode) launched the "
              f"backward kernel {name} {launches[name]} times")
    outs = runs["paced"]["outs"]
    for a, b in zip(outs, runs["burst"]["outs"]):
        check(a[0].shape == b[0].shape
              and (a[0] - b[0]).abs().max().item() <= SERVE_ATOL,
              "paced and burst runs served different outputs")

    # served outputs vs unbatched forwards on the plain attention path
    picks = sorted(range(n_requests), key=lambda i: reqs[i][2])
    picks = [picks[int(j)] for j in onp.linspace(0, n_requests - 1, 8)]
    dev = next(model.parameters()).device
    worst = 0.0
    before = cuda_ops.launch_counts()
    os.environ["MXTPU_ATTN_IMPL"] = "xla"
    try:
        with torch.inference_mode():
            for i in picks:
                ids, tt, vl = (torch.from_numpy(a[None]).to(dev)
                               for a in reqs[i])
                seq, pooled = model(ids, tt, vl)
                got_seq, got_pooled = outs[i]
                L = int(reqs[i][2])
                check(tuple(got_seq.shape) == (L, 768)
                      and tuple(got_pooled.shape) == (768,),
                      f"served shapes {tuple(got_seq.shape)}, "
                      f"{tuple(got_pooled.shape)} for length {L}")
                check(bool(torch.isfinite(got_seq).all()
                           and torch.isfinite(got_pooled).all()),
                      "served outputs are not finite")
                worst = max(worst,
                            (got_seq - seq[0].cpu()).abs().max().item(),
                            (got_pooled - pooled[0].cpu()).abs().max().item())
    finally:
        del os.environ["MXTPU_ATTN_IMPL"]
    check(cuda_ops.launch_counts() == before,
          "impl='xla' reached a kernel")
    check(worst <= SERVE_ATOL, f"served vs unbatched xla forward: max abs "
          f"err {worst} > {SERVE_ATOL}")
    res = {"model": model, "requests": n_requests,
           "warmup_s": warm["seconds"],
           "launches": launches, "batches": batches,
           "served_vs_xla_max_abs_err": worst,
           "checked_lengths": [int(reqs[i][2]) for i in picks]}
    card = card_line()
    for name, r in runs.items():
        lat = r["snapshot"]["latency"]
        res[name] = {"wall_s": r["wall_s"], "req_s": n_requests / r["wall_s"],
                     "p50_ms": lat["latency_ms_p50"],
                     "p99_ms": lat["latency_ms_p99"],
                     "batches": r["snapshot"]["batches"],
                     "batch_occupancy": r["snapshot"]["batch_occupancy"]}
        offered = f"offered {rate} req/s" if name == "paced" else "all at once"
        print(f"serve {name}: {n_requests} requests ({offered}) in "
              f"{r['wall_s']:.3f} s = {res[name]['req_s']:.1f} req/s, "
              f"latency p50 {lat['latency_ms_p50']} ms p99 "
              f"{lat['latency_ms_p99']} ms, {r['snapshot']['batches']} "
              f"batches on {card}", flush=True)
    print(f"serve: launches {launches}, served vs xla max abs err "
          f"{worst:.2e} (tol {SERVE_ATOL})", flush=True)
    return res


def device_split(fn) -> tuple:
    """Run ``fn`` once under ``torch.profiler`` and return ``(wall_ms,
    {kernel name: device ms})``, device-side events only (CPU operators
    also carry their kernels' time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
    return wall, per_kernel


def summarize(tag: str, per_kernel: dict) -> dict:
    """Shares of the flash kernels and the GEMMs, and the top kernels."""
    total = sum(per_kernel.values())
    res = {"profiled_device_ms": total, "kernels": len(per_kernel),
           "top": []}
    if total <= 0:
        print(f"{tag}: the profiler saw no device time", flush=True)
        return res
    groups = {fa.KERNEL: "flash_fwd_kernel",
              fa.KERNEL_BWD_DKV: "flash_bwd_dkv_kernel",
              fa.KERNEL_BWD_DQ: "flash_bwd_dq_kernel"}
    res["ms_by_group"] = {g: sum(t for k, t in per_kernel.items() if m in k)
                          for g, m in groups.items()}
    res["ms_by_group"]["gemm"] = sum(t for k, t in per_kernel.items()
                                     if "gemm" in k.lower())
    res["ms_by_group"]["other"] = total - sum(res["ms_by_group"].values())
    for k, t in sorted(per_kernel.items(), key=lambda r: -r[1])[:8]:
        res["top"].append({"kernel": k[:90], "ms": t, "share": t / total})
        print(f"  {t:9.3f} ms {t / total:6.1%}  {k[:90]}", flush=True)
    print(f"{tag}: {total:.3f} ms of device time in {len(per_kernel)} "
          "kernels; " + ", ".join(f"{g} {t:.3f} ms ({t / total:.1%})"
                                  for g, t in res["ms_by_group"].items()),
          flush=True)
    return res


def phase_profile(model, B: int = 32, L: int = 512) -> dict:
    """Device time of one BERT forward at the largest bucket, and its
    split by kernel from ``torch.profiler`` (self device time)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(1, 30522, (B, L), device="cuda", generator=gen,
                        dtype=torch.int32)
    tt = torch.zeros_like(ids)
    vl = torch.full((B,), float(L), device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(ids, tt, vl), target_ms=300.0)
        _, per_kernel = device_split(lambda: model(ids, tt, vl))
    print(f"profile: forward at bucket (batch {B}, seq {L}): {fwd_ms:.3f} ms "
          f"(CUDA events)", flush=True)
    res = {"bucket": [B, L], "forward_ms": fwd_ms}
    res.update(summarize("profile", per_kernel))
    return res


def train_run(trainer, batch, steps: int, n_layers: int, tag: str) -> dict:
    """The port bench's protocol on one trainer: its losses, the kernels'
    launches over the run (counted from 0 just before it, replays
    included: 12 per kernel per step) and its peak memory."""
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    dt, losses = bench.measure(trainer, batch, steps)
    launches = cuda_ops.launch_counts()
    losses = [float(x) for x in losses]
    n_steps = len(losses)
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(bool(trainer.last_finite), f"{tag}: the last step's loss or "
          "gradient norm is not finite")
    for name, n in launches.items():
        check(n == n_layers * n_steps, f"{tag}: {name} launched {n} times "
              f"in {n_steps} steps of {n_layers} layers")
    return {"dt": dt, "losses": losses, "launches": launches,
            "steps": n_steps, "captures": trainer.captures,
            "last_step_graphs": trainer.last_step_graphs,
            "last_path": trainer.last_path,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def profiled_step(trainer, placed, tag: str) -> dict:
    """One step under ``torch.profiler``: wall ms, device ms, idle share
    and the split by kernel."""
    wall, per_kernel = device_split(lambda: trainer.step(*placed))
    res = {"profiled_step_wall_ms": wall}
    res.update(summarize(f"{tag} profile", per_kernel))
    busy = res["profiled_device_ms"]
    res["device_idle_share"] = max(0.0, 1.0 - busy / wall)
    print(f"{tag} profile: one step {wall:.3f} ms wall under the profiler, "
          f"device busy {busy:.3f} ms, idle share "
          f"{res['device_idle_share']:.1%}", flush=True)
    return res


def phase_train() -> dict:
    """The port bench at full width and depth, through the fused step
    (one CUDA-graph replay per step, the default) and the eager step,
    timed in turns in this call: each path's losses, launches per step and
    captures; the fused path's JSON line; one profiled step of each."""
    t0 = time.perf_counter()
    trainer, batch, info = bench.build("cuda")
    eager, _, _ = bench.build("cuda", fused=False)
    check(trainer.fused and not eager.fused, "the bench's trainer is not "
          "fused by default")
    print(f"train: {info['model']} bfloat16, {info['params']} parameters, "
          f"fused and eager trainers built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    steps = int(getenv("MXTPU_BENCH_STEPS"))
    n_layers = info["cfg"]["num_layers"]
    runs = {"fused": train_run(trainer, batch, steps, n_layers, "train"),
            "eager": train_run(eager, batch, steps, n_layers,
                               "train eager")}
    check(runs["fused"]["captures"] == 1
          and runs["fused"]["last_step_graphs"] == 1
          and runs["fused"]["last_path"] == "fused",
          f"fused trainer: {runs['fused']['captures']} captures, "
          f"{runs['fused']['last_step_graphs']} graphs in its last step")
    record = bench.result(info, runs["fused"]["dt"], runs["fused"]["losses"])
    print(json.dumps(record), flush=True)
    placed = trainer.place(*batch)
    # in turns, after each path's own run: eager, fused
    for name, tr in (("eager", eager), ("fused", trainer)):
        runs[name]["step_ms_runs"] = [runs[name]["dt"] * 1e3,
                                      synced_ms(lambda: tr.step(*placed),
                                                steps)[0]]
    card = card_line()
    for name, r in runs.items():
        ms = min(r["step_ms_runs"])
        r["step_ms"], r["tokens_per_s"] = ms, info["batch"] * info[
            "seq"] / (ms / 1e3)
        print(f"train {name}: {ms:.3f} ms per step = {r['tokens_per_s']:.1f}"
              f" tokens/s (runs {[round(t, 3) for t in r['step_ms_runs']]})"
              f", captures {r['captures']}, graphs in the last step "
              f"{r['last_step_graphs']}, losses {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f} over {r['steps']} steps, launches "
              f"{r['launches']}, peak memory {r['peak_memory_gib']:.2f} GiB "
              f"on {card}", flush=True)
    fused_l, eager_l = ([round(x, 4) for x in runs[k]["losses"]]
                        for k in ("fused", "eager"))
    print(f"train: losses fused {fused_l}, eager {eager_l}; grad norm "
          f"{trainer.last_grad_norm:.4f}", flush=True)
    res = {"record": record, "runs": runs,
           "launches": runs["fused"]["launches"],
           "launches_eager": runs["eager"]["launches"]}
    res["profile"] = profiled_step(trainer, placed, "train fused")
    res["profile_eager"] = profiled_step(eager, placed, "train eager")
    del trainer, eager
    return res


def phase_train_fused_gate(num_layers: int = 2, steps: int = 3) -> dict:
    """The fused step against the eager one on the bench's configuration
    (bf16 + fp32 masters, AdamW, the bench's batch) at full width and
    ``num_layers`` layers, under ``torch.use_deterministic_algorithms``:
    at dropout 0 every loss and, after ``steps`` steps, every weight must
    equal the eager one to 1e-5 of its largest value; at dropout 0.1 the
    losses say whether the captured masks are the eager ones."""
    gc.collect()
    torch.cuda.empty_cache()
    batch = bench.make_batch(*TRAIN_SHAPE)
    res = {}
    torch.use_deterministic_algorithms(True)
    try:
        for dropout in (0.0, 0.1):
            nets, trainers = [], []
            for fused in (None, False):
                net = models.get_bert(
                    "bert_12_768_12", vocab_size=bench.VOCAB,
                    max_length=TRAIN_SHAPE[1], dropout=dropout,
                    dtype="bfloat16", device="cuda", num_layers=num_layers,
                    generator=torch.Generator().manual_seed(0))
                nets.append(net)
                trainers.append(parallel.ShardedTrainer(
                    net, models.bert_pretrain_loss, "adamw",
                    {"learning_rate": 1e-4, "multi_precision": True},
                    device="cuda", n_labels=3, fused=fused))
            losses = [[float(tr.step(*batch)) for _ in range(steps)]
                      for tr in trainers]
            check(trainers[0].last_step_graphs == 1
                  and trainers[0].captures == 1, "the gate's fused trainer "
                  "did not replay a graph")
            worst, worst_name = 0.0, ""
            eager_params = dict(nets[1].named_parameters())
            for name, p in nets[0].named_parameters():
                want = eager_params[name].detach().float()
                ratio = ((p.detach().float() - want).abs().max()
                         / want.abs().max().clamp_min(1e-30)).item()
                if ratio > worst:
                    worst, worst_name = ratio, name
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
            res[f"dropout_{dropout}"] = {
                "losses_fused": losses[0], "losses_eager": losses[1],
                "loss_rel_err": loss_err, "weights_worst_rel_err": worst,
                "weights_worst_param": worst_name,
                "bitwise": loss_err == 0.0 and worst == 0.0}
            print(f"train gate, dropout {dropout}, {num_layers} layers at "
                  f"full width, {steps} steps, fused vs eager: losses "
                  f"{losses[0]} vs {losses[1]} (worst rel err {loss_err:.2e})"
                  f", weights worst rel err {worst:.2e} ({worst_name})",
                  flush=True)
            if dropout == 0.0:
                check(loss_err <= 1e-5 and worst <= 1e-5,
                      f"fused and eager steps differ: losses {loss_err}, "
                      f"weights {worst} at {worst_name}")
            else:
                print("train gate: the captured dropout masks "
                      + ("equal" if loss_err == 0.0 else "differ from")
                      + " the eager ones from the same seed", flush=True)
            del nets, trainers
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(False)
    res["bias_correction"] = bias_correction_diff()
    return res


def bias_correction_diff(max_t: int = 100_000) -> dict:
    """Adam's ``1 - beta ** t`` as the fused step computes it (torch's
    float32 ``pow`` on the card) against numpy's float32 ``pow`` on the
    host, for t in 1..``max_t``: the largest difference in float32 ulps."""
    t = torch.arange(1, max_t + 1, device="cuda", dtype=torch.int32)
    out = {}
    for beta in (0.9, 0.999):
        dev = (1.0 - torch.pow(beta, t.to(torch.float32))).cpu().numpy()
        host = onp.float32(1.0) - onp.float32(beta) ** onp.arange(
            1, max_t + 1, dtype=onp.float32)
        ulps = onp.abs(dev.view(onp.int32).astype(onp.int64)
                       - host.view(onp.int32).astype(onp.int64))
        out[str(beta)] = {"max_ulps": int(ulps.max()),
                          "differing": int((ulps > 0).sum())}
    print(f"bias correction 1 - beta**t, t = 1..{max_t}, card float32 pow "
          f"vs numpy float32 pow: {out}", flush=True)
    return out


def phase_train_grads(num_layers: int = 2) -> dict:
    """One step's parameter gradients on the kernels against the plain
    attention path: BERT-base width, ``num_layers`` layers, float32,
    dropout 0, the bench's batch."""
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=TRAIN_SHAPE[1], dropout=0.0,
                          dtype="float32", device="cuda",
                          num_layers=num_layers)
    batch = [torch.from_numpy(a).cuda() for a in bench.make_batch(
        *TRAIN_SHAPE)]

    def step():
        net.zero_grad(set_to_none=True)
        net.train()
        loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
        loss.backward()
        return loss.detach().item(), {n: p.grad.detach().clone()
                             for n, p in net.named_parameters()}

    cuda_ops.reset_launches()
    loss_k, grads_k = step()
    launches = cuda_ops.launch_counts()
    for name, n in launches.items():
        check(n == num_layers, f"{name} launched {n} times in one step of "
              f"{num_layers} layers")
    os.environ["MXTPU_ATTN_IMPL"] = "xla"
    try:
        loss_x, grads_x = step()
    finally:
        del os.environ["MXTPU_ATTN_IMPL"]
    check(cuda_ops.launch_counts() == launches,
          "impl='xla' reached a kernel")
    worst, worst_name = 0.0, ""
    for name, gx in grads_x.items():
        ratio = ((grads_k[name] - gx).abs().max()
                 / gx.abs().max().clamp_min(1e-30)).item()
        if ratio > worst:
            worst, worst_name = ratio, name
    loss_err = abs(loss_k - loss_x)
    print(f"train gradients: {len(grads_x)} parameters, {num_layers} layers "
          f"at full width, kernels vs plain attention: worst max abs err / "
          f"max |grad| {worst:.2e} ({worst_name}, tol {GRAD_RTOL}), loss "
          f"{loss_k:.6f} vs {loss_x:.6f}", flush=True)
    check(worst <= GRAD_RTOL, f"gradients differ: {worst} at {worst_name}")
    check(loss_err <= 1e-5 * abs(loss_x), f"loss differs by {loss_err}")
    return {"layers": num_layers, "worst_rel_err": worst,
            "worst_param": worst_name, "loss_kernels": loss_k,
            "loss_plain": loss_x, "launches": launches}


def gluon_step(net, trainer, batch) -> "nd.NDArray":
    """One step of the Gluon loop on ``batch`` (NDArrays on the card)."""
    with autograd.record():
        loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
    loss.backward()
    trainer.step(1)
    return loss


def synced_ms(fn, steps: int) -> tuple:
    """``fn()`` ``steps`` times between two synchronizes: ``(ms per call on
    the host clock, every result)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [fn() for _ in range(steps)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, out


def gluon_split(net, trainer, batch) -> dict:
    """One Gluon step in three synchronised parts: the recorded forward
    and loss, ``loss.backward()`` and ``trainer.step(1)`` (host clock,
    each part's device work included)."""
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    with autograd.record():
        loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
    mark()
    loss.backward()
    mark()
    trainer.step(1)
    mark()
    ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return dict(zip(("forward_ms", "backward_ms", "update_ms"), ms))


def gluon_net(ctx, L: int, hybridize: bool):
    """BERT-base (float32, dropout 0.1) initialised with Xavier after
    ``mx.random.seed(0)`` (so twins have the same weights), and its Adam
    ``gluon.Trainer``."""
    mx.random.seed(0)
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=L, dropout=0.1, dtype="float32")
    net.initialize(mx.init.Xavier(), ctx=ctx, force_reinit=True)
    if hybridize:
        net.hybridize()
    return net, gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-4})


def gluon_loop(net, trainer, batch, steps: int, n_layers: int,
               tag: str) -> dict:
    """Two warm steps (a hybridized net's eager call and its capture), then
    ``steps`` timed steps with the kernels' launches counted from 0 just
    before them, and two more counted one by one: 12 per kernel per
    step."""
    losses = [gluon_step(net, trainer, batch) for _ in range(2)]
    per_step = []

    def counted():
        cuda_ops.reset_launches()
        loss = gluon_step(net, trainer, batch)
        per_step.append(cuda_ops.launch_counts())
        return loss

    cuda_ops.reset_launches()
    step_ms, timed = synced_ms(lambda: gluon_step(net, trainer, batch),
                               steps)
    launches = cuda_ops.launch_counts()
    _, counted_losses = synced_ms(counted, 2)
    losses = [float(x.asscalar()) for x in losses + timed + counted_losses]
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    for name, n in launches.items():
        check(n == n_layers * steps, f"{tag}: {name} launched {n} times in "
              f"{steps} steps of {n_layers} layers")
    for counts in per_step:
        check(all(n == n_layers for n in counts.values()),
              f"{tag}: launches in one step: {counts}")
    return {"losses": losses, "launches": launches,
            "step_ms_runs": [step_ms]}


def phase_gluon(trained: dict, steps: int = 5) -> dict:
    """BERT-base trained through the Gluon loop, plain and hybridized (CUDA
    graphs for the forward and backward, the multi-tensor Adam of
    ``gluon.Trainer`` in both): losses, launches per step, step ms timed in
    turns with the forward/backward/update split, against
    ``ShardedTrainer`` on the same model and optimizer; the gradients of a
    hybridized backward against ``ShardedTrainer``'s, and the ``.params``
    and trainer-state round trips."""
    gc.collect()
    torch.cuda.empty_cache()
    ctx, (B, L) = mx.gpu(0), TRAIN_SHAPE
    t0 = time.perf_counter()
    host = bench.make_batch(B, L)
    batch = [nd.array(a, ctx=ctx) for a in host]
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    nets = {"plain": gluon_net(ctx, L, False),
            "hybrid": gluon_net(ctx, L, True)}
    n_params = len(nets["plain"][1]._params)
    print(f"gluon: bert_12_768_12 float32, {n_params} parameters, plain and "
          f"hybridized nets built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    runs = {name: gluon_loop(net, tr, batch, steps, n_layers,
                             f"gluon {name}")
            for name, (net, tr) in nets.items()}
    check(len(nets["hybrid"][0]._cached_ops) == 1
          and all(op.bwd is not None
                  for op in nets["hybrid"][0]._cached_ops.values()),
          "the hybridized net did not capture one forward and backward "
          "graph")
    # in turns, after each path's own run: hybrid, plain
    for name in ("hybrid", "plain"):
        net, tr = nets[name]
        runs[name]["step_ms_runs"].append(synced_ms(
            lambda: gluon_step(net, tr, batch), steps)[0])
    for name, (net, tr) in nets.items():
        r = runs[name]
        r["step_ms"] = min(r["step_ms_runs"])
        r["tokens_per_s"] = B * L / (r["step_ms"] / 1e3)
        r["split"] = gluon_split(net, tr, batch)
        wall, per_kernel = device_split(lambda: gluon_step(net, tr, batch))
        busy = sum(per_kernel.values())
        r.update(profiled_step_wall_ms=wall, profiled_device_ms=busy,
                 device_idle_share=max(0.0, 1 - busy / wall))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the same model and optimizer through ShardedTrainer (its fused step),
    # timed in turns with the plain Gluon loop
    net, tr = nets["plain"]
    st = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adam",
                                 {"learning_rate": 1e-4}, device="cuda",
                                 n_labels=3)
    placed = st.place(*host)
    st.step(*placed)
    st.step(*placed)
    st_runs = [synced_ms(lambda: st.step(*placed), steps)[0]]
    runs["plain"]["step_ms_runs"].append(synced_ms(
        lambda: gluon_step(net, tr, batch), steps)[0])
    st_runs.append(synced_ms(lambda: st.step(*placed), steps)[0])
    st_ms = min(st_runs)
    st_tps = B * L / (st_ms / 1e3)
    card = card_line()
    for name, r in runs.items():
        sp = r["split"]
        print(f"gluon {name}: loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f} over {len(r['losses'])} steps; "
              f"{r['step_ms']:.3f} ms per step = {r['tokens_per_s']:.1f} "
              f"tokens/s (runs {[round(t, 3) for t in r['step_ms_runs']]}); "
              f"one synchronised step split: forward {sp['forward_ms']:.3f}, "
              f"backward {sp['backward_ms']:.3f}, trainer.step "
              f"{sp['update_ms']:.3f} ms for {n_params} parameters; one step "
              f"under the profiler {r['profiled_step_wall_ms']:.3f} ms wall, "
              f"{r['profiled_device_ms']:.3f} ms device, idle share "
              f"{r['device_idle_share']:.1%}; launches {r['launches']} on "
              f"{card}", flush=True)
    print(f"gluon: ShardedTrainer (fused), same model and Adam, in turns with"
          f" the plain loop: {st_ms:.3f} ms = {st_tps:.1f} tokens/s (runs "
          f"{[round(t, 3) for t in st_runs]}); the bench's bf16 AdamW fused "
          f"step: {trained['runs']['fused']['step_ms']:.3f} ms; peak memory "
          f"{peak_gb:.2f} GiB", flush=True)
    del st, tr, net, nets, batch
    res = {"runs": runs, "launches": runs["plain"]["launches"],
           "launches_hybrid": runs["hybrid"]["launches"], "steps": steps,
           "sharded_trainer_step_ms": st_ms,
           "sharded_trainer_tokens_per_s": st_tps,
           "sharded_trainer_step_ms_runs": st_runs,
           "parameters": n_params, "peak_memory_gib": peak_gb}
    res.update(gluon_grads_vs_sharded())
    res.update(gluon_round_trip())
    return res


def gluon_grads_vs_sharded(num_layers: int = 2) -> dict:
    """The ``param.grad()`` of a hybridized net's replayed backward against
    the gradients that ``ShardedTrainer.step`` leaves on the same weights
    and batch (full width, ``num_layers`` layers, float32, dropout 0)."""
    gc.collect()
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=TRAIN_SHAPE[1], dropout=0.0,
                          dtype="float32", device="cuda",
                          num_layers=num_layers)
    net.hybridize()
    host = bench.make_batch(*TRAIN_SHAPE)
    batch = [nd.array(a, ctx=mx.gpu(0)) for a in host]
    params = net.collect_params()
    for _ in range(3):                 # eager call, capture, replay
        cuda_ops.reset_launches()
        with autograd.record():
            loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
        loss.backward()
    launches = cuda_ops.launch_counts()
    check(all(n == num_layers for n in launches.values()),
          f"one replayed backward of {num_layers} layers launched "
          f"{launches}")
    got = {k: p.grad()._data.clone() for k, p in params.items()}
    st = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adam",
                                 {"learning_rate": 1e-4}, device="cuda",
                                 n_labels=3)
    st_loss = float(st.step(*host))
    worst, worst_name = 0.0, ""
    for k, p in params.items():
        want = p._var.grad
        ratio = ((got[k] - want).abs().max()
                 / want.abs().max().clamp_min(1e-30)).item()
        if ratio > worst:
            worst, worst_name = ratio, k
    print(f"gluon gradients: {len(got)} parameters, {num_layers} layers at "
          f"full width, hybridized (replayed) backward vs ShardedTrainer.step"
          f": worst max abs err / max |grad| {worst:.2e} ({worst_name}, tol "
          f"{GRAD_RTOL}), loss {float(loss.asscalar()):.6f} vs "
          f"{st_loss:.6f}", flush=True)
    check(worst <= GRAD_RTOL, f"Gluon gradients differ: {worst} at "
          f"{worst_name}")
    return {"grads_worst_rel_err": worst, "grads_worst_param": worst_name,
            "grads_layers": num_layers}


def gluon_round_trip() -> dict:
    """``save_parameters`` -> ``load_parameters`` into a fresh BERT-base:
    the forward under ``predict_mode`` is bitwise equal; ``save_states`` /
    ``load_states`` restore the update count."""
    gc.collect()
    ctx, (B, L) = mx.gpu(0), TRAIN_SHAPE
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=L, dropout=0.1, dtype="float32")
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-4})
    batch = [nd.array(a, ctx=ctx) for a in bench.make_batch(B, L)]
    for _ in range(2):
        gluon_step(net, trainer, batch)
    fresh = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                            max_length=L, dropout=0.1, dtype="float32",
                            generator=torch.Generator().manual_seed(7))
    with tempfile.TemporaryDirectory() as tmp:
        pfile, sfile = (os.path.join(tmp, f) for f in ("bert.params",
                                                       "bert.states"))
        net.save_parameters(pfile)
        fresh.load_parameters(pfile, ctx=ctx)
        trainer.save_states(sfile)
        trainer2 = gluon.Trainer(fresh.collect_params(), "adam",
                                 {"learning_rate": 1e-4})
        trainer2.load_states(sfile)
        nbytes = os.path.getsize(pfile)
    with autograd.predict_mode():
        want, got = net(*batch[:4]), fresh(*batch[:4])
    same = all(torch.equal(a._data, b._data) for a, b in zip(want, got))
    check(same, "the forward after a .params round trip is not bitwise "
          "equal")
    check(trainer2.optimizer.num_update == trainer.optimizer.num_update == 2,
          f"load_states restored num_update "
          f"{trainer2.optimizer.num_update}, saved "
          f"{trainer.optimizer.num_update}")
    print(f"gluon round trip: {nbytes} bytes of .params, forward bitwise "
          f"equal, num_update {trainer2.optimizer.num_update} restored",
          flush=True)
    return {"params_file_bytes": nbytes, "round_trip_bitwise": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serving requests")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    # cuBLAS's deterministic configuration (32 MiB of workspace, Hopper's
    # default size), read when its first handle is made: the fused-step
    # gate runs under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 GEMMs
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build(list(cuda_ops.KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s wall {built}", flush=True)
    for name in cuda_ops.KERNELS:
        # ptxas reports each template instance: its mangled name, then its
        # spills and registers
        entry = ""
        for line in _build.build_log.get(name, "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill stores" in line or "registers" in line:
                print(f"  {name} {entry[-40:]}: {line.strip()}")

    results = []
    main_rec = phase_kernels(results)
    main_bwd = phase_kernels_bwd(results)
    served = phase_serve(N_REQUESTS, OFFERED_RATE, args.seed)
    profiled = phase_profile(served.pop("model"))
    trained = phase_train()
    gate = phase_train_fused_gate()
    grads = phase_train_grads()
    glu = phase_gluon(trained)

    def worst(name, dtype):
        return max(r["max_abs_err"] for r in results
                   if r["kernel"] == name and r["dtype"] == dtype)

    sources = {fa.KERNEL: ("flash_attention_fwd.cu", 273),
               fa.KERNEL_BWD_DKV: ("flash_attention_bwd_dkv.cu", 450),
               fa.KERNEL_BWD_DQ: ("flash_attention_bwd_dq.cu", 487)}
    timed = dict(main_bwd, **{fa.KERNEL: main_rec})
    kernels = []
    for name, (src, line) in sources.items():
        rec = timed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"incubator_mxnet_tpu_torch/csrc/{src}",
            "replaces": "incubator_mxnet_tpu/ops/pallas/flash_attention.py:"
                        f"{line}",
            "launches": trained["launches"][name],
            "launches_by_path": {"serve": served["launches"][name],
                                 "train": trained["launches_eager"][name],
                                 "train_fused": trained["launches"][name],
                                 "gluon": glu["launches"][name],
                                 "gluon_hybrid":
                                     glu["launches_hybrid"][name]},
            "max_abs_err": worst(name, "float32"),
            "max_abs_err_bf16": worst(name, "bfloat16"),
            "ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "shape": [rec[k] for k in ("B", "H", "Lq", "Lk", "D")],
            "dtype": rec["dtype"]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernel_cases": results,
                       "serve": served, "profile": profiled,
                       "train": trained, "train_fused_gate": gate,
                       "train_gradients": grads,
                       "gluon": glu, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
