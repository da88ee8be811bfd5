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
   middle tile, a row with none), with small tiles, and at the NMT
   training's masked cross-attention shapes (target 112 over source 128,
   128 over 96, 16 heads, a row that sees no key); the two backward
   kernels (dK/dV, dQ) at the training shape and at masked, causal,
   windowed, cross-length (causal, and the NMT masked shapes), ragged and
   small-tile cases; all three, untimed, at the MT gate's shapes (batch
   32, 4 heads of head dim 16: 5 over 5, causal 6 over 6, 6 over 5 with
   and without a key mask) and at the decode serving prefill's (batch 1,
   16 heads, one ragged row of source 128); with per-shape
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
   and ``save_states`` / ``load_states`` restoring the update count;
10. vision: (a) the port
    bench's ``resnet`` workload at full size (``resnet50_v1``, bfloat16,
    batch 32, 224x224, SGD momentum with fp32 masters) through the fused
    and the eager step, timed in turns: imgs/s, step ms, MFU, the first
    step apart, peak memory, and one profiled step of each with its idle
    share and its device time in cuDNN convolutions, BatchNorm,
    elementwise kernels and the rest; the attention kernels must not
    launch; (b) at resnet18_v1, float32, batch 8, 64x64, under
    deterministic algorithms, the fused step against the eager one: the
    losses, weights and running statistics after 3 steps within 1e-5 of
    each largest value; (c) one step's gradients on the card against the
    CPU's, within 1e-3 of each parameter's largest; (d) the Gluon LeNet
    loop (``io.NDArrayIter``, hybridized, ``gluon.Trainer``,
    ``metric.Accuracy``) on the 8x8 digits, held-out accuracy >= 0.95;
11. nmt train: Transformer-big (Vaswani et al. 2017, Table 3 "big": units
    1024, hidden 4096, 6 + 6 layers, 16 heads; a shared vocabulary of
    37,000; dropout 0.1; seeded Xavier weights) through
    ``ShardedTrainer`` (Adam lr 1e-4, float32, label-smoothed
    cross-entropy, eps 0.1) on 32 pairs of source 128 (valid 32-128) and
    target 112, fused and eager in turns: step ms, target tokens/s, the
    first and warm steps apart, peak memory, a profiled step of each by
    group (GEMMs, flash kernels, elementwise, optimizer); losses finite
    and falling, each kernel 18 launches per step (encoder, causal and
    cross-attention, replays counted); one step's gradients at 2 + 2
    layers on the kernels against ``MXTPU_ATTN_IMPL=xla`` within 1e-3 of
    each parameter's largest, twice: with the plain path's ReLUs taking
    the kernel path's signs, and free on the sequences where no ReLU
    takes another sign in the two paths (the others' loss weighted 0: a
    pre-activation that the two paths round to opposite signs moves its
    token's contribution between the gradients); the share of such
    sign flips among all FFN units at most 1e-5;
12. nmt decode: at full width, a seeded 32-token prefix through
    ``nmt_step`` (contiguous cache), ``nmt_paged_step`` (scattered pages)
    and the full decoder on the kernels, logits within 1e-3 of the largest
    at every position; ``beam_search`` (K = 4, 32 tokens) against
    ``beam_search_reference`` on 4 prompts (sequences, scores and the
    first divergence printed);
13. nmt serve: ``serve.DecodeEngine`` (prompt table batch 1, source
    8-128; 32 rows, pages of 16, 128 tokens) whose decode step is one
    CUDA graph, under ``serve.DecodeBatcher``: 256 seeded requests
    (prompts 8-127, 16-127 new tokens) from 4 threads, then all at once:
    tokens/s, ITL p50/p99, TTFT p50, occupancy, the step's ms replayed
    against eager (CUDA events), the pool and the capacity; every stream
    completes, no capture or first bucket run after warmup, the forward
    kernel launched in prefill and the backward ones not, the capacity
    equal to the pool's admission limit (also under a budget, priced
    again to the same report), and 4 streams' greedy tokens equal to
    ``beam_search(K=1)``'s unless the two tokens' logits are within 1e-3;
14. mt gate: the JAX package's ``examples/machine_translation.py`` loop
    (copy task, 300 steps, vocabulary 12, length 5, batch 32, Adam
    through ``gluon.Trainer``, label smoothing 0.1) on the card, then
    ``beam_search`` (K = 4): exact match above 0.8;
15. detection: (a) the detection ops on the card against the same port
    code on the CPU at full-width shapes: ``multibox_target`` over
    SSD-300's 29,596 anchors with tied negative losses, ``multi_proposal``
    at the frcnn bench's shape (7,056 anchors, top 1000, 128 after NMS,
    tied scores), ``box_nms`` with ``topk=400`` and ``roi_align`` at
    1,056 rois x 128 channels x 7x7 (and its gradient): integer outputs
    equal, floats within stated tolerances; (b) the port bench's ``ssd``
    (batch 16, 300x300) and ``frcnn`` (batch 8, 224x224, 128 rois)
    workloads through the fused and the eager step, timed in turns: imgs/s,
    step ms, first and capture steps, peak memory, one profiled step of
    each split into convolutions, the detection ops' sorts, scatters and
    gathers, elementwise kernels and the optimizer, and its idle share;
    ``SSD.detect`` and ``FasterRCNN.detect`` at those sizes, timed; (c)
    both models' fused step against the eager one at batch 2, 64x64,
    bitwise under deterministic algorithms; (d) one step's gradients on
    the card against the CPU's within 1e-3; (e) the JAX package's two
    detection examples on the card (SSD 150 steps above 0.8, Faster-RCNN
    400 steps above 0.25); the attention kernels launch on none of it;
16. int8 serve (after the profile, on phase 4's model): calibration with
    ``quantization.observe_net`` on one batch of 32 ragged requests
    (drawn as phase 4 draws, from another seed), ``quantization.
    quantize_model`` into a quantized ``CompiledModel`` over the same
    table, ``warmup`` and ``DynamicBatcher``; the float and int8 models
    serve phase 4's requests in turns (paced, then all at once): every
    request answered, no post-warmup compile, the 48 encoder Dense layers
    and the pooler ``QuantizedDense``, served outputs within 1e-3 of the
    largest of unbatched int8 forwards, the forward kernel launched and
    the backward ones not; layer 0's four products (qkv, proj, ffn1,
    ffn2) at one 512-token request and at 8 rows, the card
    (``torch._int_mm``) against the CPU (int32 ``@``): quantized inputs,
    int32 accumulators and dequantized outputs bitwise equal; printed, not
    gated: the mean relative error against the float model, parameter
    bytes, p50/p99 and throughput, the (32, 512) forward by CUDA events
    and its device time by int8 op (quantize, ``_int_mm``, bias,
    dequantize), the flash kernel and the rest; the ``bert_encoder``
    smoke twin within 0.05 of its float twin (the JAX package's gate);
17. amp: (a) BERT-base at the bench's configuration with float32 weights
    under ``amp.init("bfloat16")``, through the fused and the eager
    ``ShardedTrainer`` step, timed in turns against the same steps
    without AMP: step ms, tokens/s, losses finite and falling, 12
    launches per kernel per step, the dtype of q at the kernels' launch
    wrapper (bf16 under AMP), one profiled step of each by group (flash
    kernels, GEMMs, casts, optimizer, reductions, elementwise) and its
    idle share; (b) at full width and 2 layers, dropout 0, under
    deterministic algorithms, the AMP fused step against the eager one
    over 3 steps, within 1e-5 of each parameter's largest; (c) one AMP
    step's gradients at 2 layers, batch 2x512, on the card against the
    CPU's within 5e-2 of each parameter's largest (bf16 roundings that
    fall on the other side); (d) ResNet-50 v1 (1000 classes, batch 32,
    224x224, float32 weights) through the image-classification example
    loop, hybridized, with ``--amp`` and without, in turns: imgs/s and
    step ms of the last epoch; (e) the example's gate with ``--amp``
    (resnet18_v1, 2 epochs, 4 classes, batch 16): accuracy above 0.5.

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
from unittest import mock

import numpy as onp
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, bench, gluon, models, nd
from incubator_mxnet_tpu_torch import parallel, serve
from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
from incubator_mxnet_tpu_torch.ops.cuda import _build
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.nn import fully_connected
from incubator_mxnet_tpu_torch.models import nmt
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


def kernel_case(gen, dtype, B, Lq, Lk, case, timed, results, H=HEADS,
                D=HEAD_DIM):
    """Kernel vs plain version on one shape; returns its result record."""
    dev = "cuda"
    q = torch.randn(B, H, Lq, D, device=dev, generator=gen).to(dtype)
    k = torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
    v = torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
    key_mask, causal, window = None, False, None
    if case in ("mask", "full"):
        vl = torch.randint(1, Lk + 1, (B,), device=dev, generator=gen)
        if case == "full":     # the training path: every key valid
            vl[:] = Lk
        elif B > 1:            # (at batch 1 one ragged row, as in prefill)
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
    # the NMT training shapes: masked cross-attention with Lq < Lk and
    # Lq > Lk, a row that sees no key in each (a generator of their own:
    # the cases above keep their inputs)
    gen = torch.Generator(device="cuda").manual_seed(8)
    cross = [kernel_case(gen, dtype, NMT_BATCH, lq, lk, "mask", True,
                         results, H=NMT_CFG["num_heads"])
             for dtype in (torch.float32, torch.bfloat16)
             for lq, lk in NMT_CROSS]
    main["nmt_cross"] = cross[0]
    small_cases(kernel_case, 10, results)
    return main


def small_cases(case_fn, seed, results) -> None:
    """``case_fn`` (:func:`kernel_case` or :func:`bwd_case`) at the MT gate's
    shapes (:data:`MT_CASES`, head dim 16) and the serving prefill's (batch
    1, 16 heads, one ragged row of the largest source bucket), f32 and
    bf16, untimed, from a generator of their own."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk, case in MT_CASES:
            case_fn(gen, dtype, MT_BATCH, lq, lk, case, False, results,
                    H=MT_HEADS, D=MT_HEAD_DIM)
        case_fn(gen, dtype, 1, NMT_SRC, NMT_SRC, "mask", False, results,
                H=NMT_CFG["num_heads"])


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


def bwd_case(gen, dtype, B, Lq, Lk, case, timed, results, H=HEADS,
             D=HEAD_DIM):
    """Both backward kernels vs their plain versions on one shape; returns
    {kernel name: result record}."""
    dev = "cuda"
    q, do = (torch.randn(B, H, Lq, D, device=dev, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    key_mask, causal, window = None, False, None
    if case in ("mask", "full"):
        vl = torch.randint(1, Lk + 1, (B,), device=dev, generator=gen)
        if case == "full":     # the training path: every key valid
            vl[:] = Lk
        elif B > 1:            # (at batch 1 one ragged row, as in prefill)
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
    if key_mask is not None and not key_mask[0].any():
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
    # the NMT training shapes (masked, Lq < Lk and Lq > Lk), from a
    # generator of their own
    gen = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk in NMT_CROSS:
            recs = bwd_case(gen, dtype, NMT_BATCH, lq, lk, "mask", True,
                            results, H=NMT_CFG["num_heads"])
            if dtype == torch.float32 and lq < lk:
                for name, rec in recs.items():
                    main[name]["nmt_cross"] = rec
    small_cases(bwd_case, 11, results)
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


def train_run(trainer, batch, steps: int, per_step: int, tag: str) -> dict:
    """The port bench's protocol on one trainer: its losses, the kernels'
    launches over the run (counted from 0 just before it, replays
    included: ``per_step`` per kernel per step, one per attention call)
    and its peak memory."""
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    timings = {}
    dt, losses = bench.measure(trainer, batch, steps, timings)
    launches = cuda_ops.launch_counts()
    losses = [float(x) for x in losses]
    n_steps = len(losses)
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(bool(trainer.last_finite), f"{tag}: the last step's loss or "
          "gradient norm is not finite")
    for name, n in launches.items():
        check(n == per_step * n_steps, f"{tag}: {name} launched {n} times "
              f"in {n_steps} steps of {per_step} attention calls")
    return {"dt": dt, "losses": losses, "launches": launches,
            "first_step_ms": timings["first_step_s"] * 1e3,
            "warm_step_ms": timings["warm_step_s"] * 1e3,
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


# -- vision: ResNet through the port bench, gates, the LeNet loop ----------
#: device-time groups of a vision step, by kernel name (the first match
#: wins): cuDNN's convolutions (forward, data and weight gradients, and its
#: layout transposes), BatchNorm, pooling, elementwise kernels, the GEMMs
#: of the Dense layer, the optimizer's multi-tensor kernels
VISION_GROUPS = (
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "nchwtonhwc",
              "nhwctonchw", "implicit", "winograd")),
    ("batch_norm", ("batch_norm",)),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise",)),
    ("gemm", ("gemm",)),
    ("optimizer", ("multi_tensor",)),
)
# fused vs eager ResNet steps under deterministic algorithms (float32): the
# same kernels on the same inputs, so losses, weights and running
# statistics agree to within 1e-5 of each tensor's largest value
VISION_GATE_RTOL = 1e-5
# ResNet gradients on the card (cuDNN, IEEE float32) against the CPU's
# (oneDNN/ATen): another summation order through 18 layers: per parameter,
# max abs err <= VISION_GRAD_RTOL * max |grad on the CPU|
VISION_GRAD_RTOL = 1e-3


def group_split(per_kernel: dict, kinds) -> dict:
    """A step's device time by the groups of ``kinds`` ((group, name
    substrings) pairs, the first match wins) and its top kernels."""
    total = sum(per_kernel.values())
    groups = {g: 0.0 for g, _ in kinds}
    groups["other"] = 0.0
    for name, t in per_kernel.items():
        low = name.lower()
        g = next((g for g, keys in kinds
                  if any(k in low for k in keys)), "other")
        groups[g] += t
    top = [{"kernel": k[:90], "ms": t, "share": t / total}
           for k, t in sorted(per_kernel.items(), key=lambda r: -r[1])[:10]]
    return {"profiled_device_ms": total, "kernels": len(per_kernel),
            "ms_by_group": groups,
            "share_by_group": {g: t / total for g, t in groups.items()}
            if total else {}, "top": top}


def grouped_profiled_step(trainer, placed, tag: str, kinds) -> dict:
    """One training step under ``torch.profiler``: wall ms, device ms, idle
    share and the split by the groups of ``kinds``."""
    wall, per_kernel = device_split(lambda: trainer.step(*placed))
    res = {"profiled_step_wall_ms": wall}
    res.update(group_split(per_kernel, kinds))
    busy = res["profiled_device_ms"]
    res["device_idle_share"] = max(0.0, 1.0 - busy / wall) if wall else 0.0
    shares = ", ".join(f"{g} {v:.1%}" for g, v in
                       res["share_by_group"].items())
    print(f"{tag} profile: one step {wall:.3f} ms wall, device busy "
          f"{busy:.3f} ms in {res['kernels']} kernels, idle share "
          f"{res['device_idle_share']:.1%}; device time by group: {shares}",
          flush=True)
    for t in res["top"][:6]:
        print(f"  {t['ms']:9.3f} ms {t['share']:6.1%}  {t['kernel']}",
              flush=True)
    return res


def vision_run(trainer, batch, steps: int, tag: str) -> dict:
    """The port bench's protocol on a ResNet trainer: losses, the first
    and warm steps apart, peak memory, and the flash kernels' launches
    (none: no attention on this path)."""
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    timings = {}
    dt, losses = bench.measure(trainer, batch, steps, timings)
    launches = cuda_ops.launch_counts()
    losses = [float(x) for x in losses]
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(not any(launches.values()), f"{tag}: the vision path launched "
          f"attention kernels: {launches}")
    return {"dt": dt, "losses": losses, "launches": launches,
            "first_step_ms": timings["first_step_s"] * 1e3,
            "warm_step_ms": timings["warm_step_s"] * 1e3,
            "captures": trainer.captures,
            "last_step_graphs": trainer.last_step_graphs,
            "last_path": trainer.last_path,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def vision_bench() -> dict:
    """(a) The port bench's ``resnet`` workload at full size (resnet50_v1,
    bfloat16, batch 32, 224x224; the knobs may change it), through the
    fused and the eager step, timed in turns: imgs/s, step ms, MFU, peak
    memory, and one profiled step of each."""
    t0 = time.perf_counter()
    fused, batch, info = bench.build_resnet("cuda")
    eager, _, _ = bench.build_resnet("cuda", fused=False)
    check(fused.fused and not eager.fused, "the resnet bench's trainer is "
          "not fused by default")
    steps = int(getenv("MXTPU_BENCH_STEPS"))
    runs = {"fused": vision_run(fused, batch, steps, "vision fused"),
            "eager": vision_run(eager, batch, steps, "vision eager")}
    check(runs["fused"]["captures"] == 1
          and runs["fused"]["last_step_graphs"] == 1
          and runs["fused"]["last_path"] == "fused",
          f"vision fused trainer: {runs['fused']['captures']} captures, "
          f"{runs['fused']['last_step_graphs']} graphs in its last step")
    n_params = sum(p.numel() for p in info["net"].parameters())
    record = bench.resnet_result(info, runs["fused"]["dt"],
                                 runs["fused"]["losses"],
                                 runs["fused"]["first_step_ms"] / 1e3)
    print(json.dumps(record), flush=True)
    placed = fused.place(*batch)
    # in turns, after each path's own run: eager, fused
    for name, tr in (("eager", eager), ("fused", fused)):
        runs[name]["step_ms_runs"] = [runs[name]["dt"] * 1e3, synced_ms(
            lambda: tr.step(*placed), steps)[0]]
    card = card_line()
    for name, r in runs.items():
        ms = min(r["step_ms_runs"])
        rec = bench.resnet_result(info, ms / 1e3, r["losses"])
        r.update(step_ms=ms, imgs_per_s=info["batch"] / (ms / 1e3),
                 mfu=rec["extra"]["mfu"])
        print(f"vision {name}: {info['model']} bfloat16 batch "
              f"{info['batch']} at {info['img']}: {ms:.3f} ms per step = "
              f"{r['imgs_per_s']:.1f} imgs/s, MFU {r['mfu']:.4f} (runs "
              f"{[round(t, 3) for t in r['step_ms_runs']]}); first step "
              f"{r['first_step_ms']:.1f} ms, warm step "
              f"{r['warm_step_ms']:.1f} ms; losses {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f}; peak memory "
              f"{r['peak_memory_gib']:.2f} GiB on {card}", flush=True)
    res = {"record": record, "runs": runs, "model": info["model"],
           "batch": info["batch"], "img": info["img"],
           "parameters": n_params,
           "launches": runs["fused"]["launches"]}
    res["profile"] = grouped_profiled_step(fused, placed, "vision fused",
                                           VISION_GROUPS)
    res["profile_eager"] = grouped_profiled_step(eager, placed,
                                                 "vision eager",
                                                 VISION_GROUPS)
    print(f"vision: trainers built and run in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del fused, eager, placed, info
    return res


def _resnet_trainer(device, fused, B: int = 8, img: int = 64):
    """resnet18_v1 (1000 classes, float32, Xavier from seed 0, shapes
    deferred to the first step), the bench's SGD, and a batch from
    ``RandomState(1)``."""
    net = gluon.model_zoo.vision.get_model("resnet18_v1", classes=1000)
    net.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(
        0)), ctx=mx.Context.from_device(torch.device(device)))
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = parallel.ShardedTrainer(
        net, lambda out, label: ce(out, label), "sgd",
        {"learning_rate": 0.05, "momentum": 0.9}, device=device,
        n_labels=1, fused=fused)
    rng = onp.random.RandomState(1)
    batch = (rng.randn(B, 3, img, img).astype("float32"),
             rng.randint(0, 1000, (B,)).astype("float32"))
    return net, tr, batch


def _rel_errs(nets, pick) -> list:
    """``(max |a - b| / max |b|, name)`` per parameter of two nets, of the
    tensors ``pick(param)`` (skipped where either is None), largest
    first."""
    n0, n1 = len(nets[0].prefix), len(nets[1].prefix)
    by_suffix = {k[n1:]: p for k, p in nets[1].collect_params().items()}
    rows = []
    for k, p in nets[0].collect_params().items():
        a, b = pick(p), pick(by_suffix[k[n0:]])
        if a is None or b is None:
            continue
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        scale = b.abs().max().item()
        if scale == 0.0:
            check(a.abs().max().item() == 0.0, f"{k}: nonzero where the "
                  "reference is zero")
            continue
        rows.append(((a - b).abs().max().item() / scale, k))
    return sorted(rows, reverse=True) or [(0.0, "")]


def _worst(nets, pick) -> tuple:
    """The largest of :func:`_rel_errs` and its parameter's name."""
    return _rel_errs(nets, pick)[0]


def vision_fused_gate(steps: int = 3) -> dict:
    """(b) The fused ResNet step against the eager one (resnet18_v1,
    float32, batch 8, 64x64) under ``torch.use_deterministic_algorithms``:
    losses, weights and running statistics after ``steps`` steps."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    try:
        pairs = [_resnet_trainer("cuda", fused) for fused in (None, False)]
        losses = [[float(tr.step(*batch)) for _ in range(steps)]
                  for _, tr, batch in pairs]
    finally:
        torch.use_deterministic_algorithms(False)
    nets = [p[0] for p in pairs]
    check(pairs[0][1].last_path == "fused"
          and pairs[0][1].last_step_graphs == 1
          and pairs[1][1].last_path == "eager",
          "the vision gate's trainers did not take the fused and the eager "
          "step")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    weights, wname = _worst(nets, lambda p: p._var)
    print(f"vision gate: resnet18_v1 float32 batch 8 at 64, {steps} steps, "
          f"fused vs eager under deterministic algorithms: losses "
          f"{losses[0]} vs {losses[1]} (worst rel err {loss_err:.2e}); "
          f"weights and running statistics worst rel err {weights:.2e} "
          f"({wname}), tol {VISION_GATE_RTOL}", flush=True)
    check(loss_err <= VISION_GATE_RTOL and weights <= VISION_GATE_RTOL,
          f"fused and eager ResNet steps differ: losses {loss_err}, weights "
          f"{weights} at {wname}")
    return {"losses_fused": losses[0], "losses_eager": losses[1],
            "loss_rel_err": loss_err, "weights_worst_rel_err": weights,
            "weights_worst_param": wname,
            "bitwise": loss_err == 0.0 and weights == 0.0}


def vision_grads_vs_cpu() -> dict:
    """(c) One ResNet step's gradients on the card, the fused and the
    eager step, against the same step on the CPU: resnet18_v1, float32,
    batch 8, 64x64, the same weights and batch."""
    gc.collect()
    runs = {}
    for name, device, fused in (("fused", "cuda", None),
                                ("eager", "cuda", False),
                                ("cpu", "cpu", None)):
        net, tr, batch = _resnet_trainer(device, fused)
        runs[name] = (net, float(tr.step(*batch)))
    cpu_net, cpu_loss = runs.pop("cpu")
    res = {"loss_cpu": cpu_loss}
    for name, (net, loss) in runs.items():
        rows = _rel_errs([net, cpu_net], lambda p: p._var.grad)
        stats = _worst([net, cpu_net], lambda p: p._var
                       if p.grad_req == "null" else None)
        worst, wname = rows[0]
        print(f"vision gradients, {name} step: resnet18_v1 float32 batch 8 "
              f"at 64, one step on the card vs on the CPU: loss "
              f"{loss:.6f} vs {cpu_loss:.6f}; max abs err / max |grad|, "
              f"worst three: "
              + ", ".join(f"{r:.2e} ({k})" for r, k in rows[:3])
              + f" (tol {VISION_GRAD_RTOL}); running statistics worst rel "
              f"err {stats[0]:.2e} ({stats[1]})", flush=True)
        check(worst <= VISION_GRAD_RTOL, f"ResNet gradients of the {name} "
              f"step on the card differ from the CPU's: {worst} at {wname}")
        check(abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss),
              f"ResNet losses differ: card {loss}, CPU {cpu_loss}")
        res[name] = {"loss_card": loss, "grads_worst_rel_err": worst,
                     "grads_worst_param": wname,
                     "running_stats_worst_rel_err": stats[0]}
    return res


def vision_lenet_gate(epochs: int = 10) -> dict:
    """(d) The Gluon LeNet loop of the reference's gate
    (``tests/test_train.py:28-62``) on the card: ``io.NDArrayIter`` over
    the 8x8 digits (``chip_data/digits.npz``, sklearn's bundled copy) ->
    hybridized conv net (CUDA graphs) -> ``autograd.record()`` ->
    ``gluon.Trainer`` (Adam) -> ``metric.Accuracy`` on the held-out
    rows, which must reach 0.95."""
    here = os.path.dirname(os.path.abspath(__file__))
    data = onp.load(os.path.join(here, "chip_data", "digits.npz"))
    X = data["images"].astype("float32")[:, None] / 16.0
    Y = data["target"].astype("float32")
    idx = onp.random.RandomState(42).permutation(len(X))
    X, Y = X[idx], Y[idx]
    Xtr, Ytr, Xte, Yte = X[:1500], Y[:1500], X[1500:], Y[1500:]
    t0 = time.perf_counter()
    mx.random.seed(42)
    onp.random.seed(42)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(16, 3, padding=1, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(128, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 3e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    it = mx.io.NDArrayIter(Xtr, Ytr, batch_size=100, shuffle=True,
                           last_batch_handle="discard")
    cuda_ops.reset_launches()
    for _ in range(epochs):
        it.reset()
        for batch in it:
            with autograd.record():
                out = net(batch.data[0])
                loss = loss_fn(out, batch.label[0]).mean()
            loss.backward()
            trainer.step(100)
    acc = mx.metric.Accuracy()
    with autograd.predict_mode():
        acc.update(nd.array(Yte), net(nd.array(Xte)))
    launches = cuda_ops.launch_counts()
    value = acc.get()[1]
    replayed = [op for op in net._cached_ops.values()
                if op.fwd is not None]
    print(f"vision lenet: {epochs} epochs of 15 batches on the card, "
          f"hybridized ({len(replayed)} captured signature(s)), last loss "
          f"{float(loss.asscalar()):.4f}, held-out accuracy {value:.4f} "
          f"(gate 0.95), {time.perf_counter() - t0:.1f} s", flush=True)
    check(value >= 0.95, f"LeNet held-out accuracy {value} < 0.95")
    check(bool(replayed) and all(op.bwd is not None for op in replayed
                                 if op.recording),
          "the hybridized LeNet captured no graph")
    check(batch.data[0].context == mx.gpu(0), "the iterator's batches are "
          "not on the card")
    check(not any(launches.values()), f"the LeNet loop launched attention "
          f"kernels: {launches}")
    return {"accuracy": value, "epochs": epochs,
            "captured_signatures": len(replayed), "launches": launches}


def phase_vision() -> dict:
    """The vision path: (a) the bench, (b) fused against eager, (c) card
    against CPU, (d) the LeNet gate."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {"bench": vision_bench()}
    res["fused_gate"] = vision_fused_gate()
    res["grads_vs_cpu"] = vision_grads_vs_cpu()
    res["lenet"] = vision_lenet_gate()
    res["launches"] = res["bench"]["launches"]
    return res


# -- Transformer NMT and decode serving ---------------------------------------
# Transformer-big (Vaswani et al. 2017, Table 3 "big"; §5.1: a shared
# source-target vocabulary of about 37,000 tokens); the NMT phases train,
# decode and serve it at full width, with seeded random weights
NMT_VOCAB = 37000
NMT_CFG = dict(units=1024, hidden_size=4096, num_heads=16)
NMT_LAYERS = 6
# training batch: 32 pairs, source 128 (valid 32-128), target 112 (the
# cross-attention runs at Lq != Lk on purpose)
NMT_BATCH, NMT_SRC, NMT_TGT = 32, 128, 112
NMT_MAX_LEN = 256
# the masked cross-attention shapes of the kernel phases: target 112 over
# source 128, and 128 over 96
NMT_CROSS = ((NMT_TGT, NMT_SRC), (128, 96))
NMT_STEPS = 10
# the MT gate's attention shapes (models/nmt.py MT_CONFIG: batch 32, units
# 64 over 4 heads, source 5, target 6): encoder 5 over 5, decoder causal 6
# over 6, cross-attention 6 over 5 (unmasked in the loop; also masked)
MT_BATCH, MT_HEADS, MT_HEAD_DIM = 32, 4, 16
MT_CASES = ((5, 5, "none"), (6, 6, "causal"), (6, 5, "none"), (6, 5, "mask"))
# three attention calls per layer pair: encoder, causal, cross
NMT_CALLS = 3 * NMT_LAYERS
NMT_GROUPS = (
    ("flash", ("flash_",)),
    ("gemm", ("gemm",)),
    ("optimizer", ("multi_tensor",)),
    ("elementwise", ("elementwise", "reduce", "softmax", "index", "gather",
                     "scatter", "cat")),
)
# KV-cache decode (contiguous and paged) vs the full decoder forward on the
# kernels, float32: the same function summed in another order (one query
# row against the whole prefix), per position max abs err over max |logit|
DECODE_RTOL = 1e-3
# the NMT gradient check: ReLU pre-activations that the kernel and plain
# paths round to opposite signs, as a share of all FFN units, at most this
# (float32 rounding flips a few in ten million); the free comparison keeps
# at least this many of the 32 sequences
NMT_FLIP_SHARE = 1e-5
NMT_GRAD_MIN_CLEAN = NMT_BATCH // 4
# a greedy token that differs between two float32 paths is a fault only if
# the two tokens' logits differ by more than this
FLIP_MARGIN = 1e-3


def nmt_model(num_layers: int = NMT_LAYERS, dropout: float = 0.1,
              seed: int = 0):
    """Transformer-big on the card, Xavier weights from ``seed``."""
    net = models.NMTModel(NMT_VOCAB, NMT_VOCAB, num_layers=num_layers,
                          dropout=dropout, max_length=NMT_MAX_LEN, **NMT_CFG)
    net.initialize(mx.init.Xavier(
        generator=torch.Generator().manual_seed(seed)), ctx=mx.gpu(0))
    return net


def nmt_batch(seed: int = 0) -> tuple:
    """``(src, target input, src valid length, label)`` from ``seed``:
    the target input is BOS + the label shifted by one."""
    rng = onp.random.RandomState(seed)
    src = rng.randint(3, NMT_VOCAB, (NMT_BATCH, NMT_SRC)).astype("int32")
    valid = rng.randint(32, NMT_SRC + 1, NMT_BATCH).astype("float32")
    tgt = rng.randint(3, NMT_VOCAB, (NMT_BATCH, NMT_TGT + 1)).astype("int32")
    tgt[:, 0] = nmt.BOS
    return src, tgt[:, :-1].copy(), valid, tgt[:, 1:].copy()


def nmt_trainer(net, fused):
    return parallel.ShardedTrainer(net, nmt.label_smoothed_ce, "adam",
                                   {"learning_rate": 1e-4}, device="cuda",
                                   n_labels=1, fused=fused)


def nmt_grads(num_layers: int = 2) -> dict:
    """One step's gradients at full width and ``num_layers`` + ``num_layers``
    layers (float32, dropout 0) on the kernels against the same step with
    ``MXTPU_ATTN_IMPL=xla``: every entry within :data:`GRAD_RTOL` of its
    parameter's largest gradient, in two comparisons.

    The FFN's ReLU makes the gradient a discontinuous function of the
    forward: a pre-activation within the two paths' rounding of 0 may take
    another sign in each, and then that token's whole contribution moves
    between the two gradients (of its ``ffn1`` row, and through the
    attention of every earlier parameter, the embedding rows of its
    sequence at full strength). Sequences do not mix in the forward, so
    such a flip moves only its own sequence's share of the gradient.

    * pinned: the whole batch, the plain path's ReLUs taking the kernel
      path's signs (a forward hook; the values differ from a free ReLU
      only where the pre-activation is within that rounding of 0);
    * free: both paths with free ReLUs, the loss of every sequence that
      holds a flip weighted 0, so that the gradients are those of the
      other sequences alone; a sequence that flips in this run too is
      dropped as well, up to three rounds, and at least
      :data:`NMT_GRAD_MIN_CLEAN` sequences must stay.

    The flips of the free full-batch step must be at most
    :data:`NMT_FLIP_SHARE` of all FFN units."""
    net = nmt_model(num_layers, dropout=0.0)
    src, tgt, valid, label = (torch.from_numpy(a).cuda()
                              for a in nmt_batch(1))
    acts = {n: m for n, m in net.named_modules()
            if n.endswith("ffn.ffn1.act")}
    signs, pinned = {}, {}

    def record(name):
        def hook(mod, args, out):
            x = args[0]
            signs[name] = x.detach() > 0
            if name in pinned:
                return x * pinned[name].to(x.dtype)
            return out
        return hook

    for name, m in acts.items():
        m.register_forward_hook(record(name))

    def step(weight=None):
        net.zero_grad(set_to_none=True)
        per_token = nmt.label_smoothed_ce(net(src, tgt, valid), label)
        if weight is None:
            loss = per_token.mean()
        else:               # per sequence; all ones is the mean
            loss = ((per_token * weight[:, None]).sum()
                    / (weight.sum() * per_token.shape[1]))
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in net.named_parameters()}, dict(signs)

    def plain_step(weight=None):
        os.environ["MXTPU_ATTN_IMPL"] = "xla"
        try:
            return step(weight)
        finally:
            del os.environ["MXTPU_ATTN_IMPL"]

    def flipped_rows(sa, sb):
        """Sequences (batch rows) that hold a ReLU of another sign."""
        rows = torch.zeros(NMT_BATCH, dtype=torch.bool, device="cuda")
        for n in acts:
            rows |= (sa[n] != sb[n]).flatten(1).any(1)
        return rows

    def worst_of(grads, want):
        worst, worst_name = 0.0, ""
        for name, gx in want.items():
            ratio = ((grads[name] - gx).abs().max()
                     / gx.abs().max().clamp_min(1e-30)).item()
            if ratio > worst:
                worst, worst_name = ratio, name
        return worst, worst_name

    cuda_ops.reset_launches()
    loss_k, grads_k, signs_k = step()
    launches = cuda_ops.launch_counts()
    for name, n in launches.items():
        check(n == 3 * num_layers, f"nmt gradients: {name} launched {n} "
              f"times in one step of {num_layers} + {num_layers} layers")
    loss_f, grads_f, signs_f = plain_step()
    pinned.update(signs_k)
    try:
        loss_x, grads_x, _ = plain_step()
    finally:
        pinned.clear()
    flips = {n: int((signs_k[n] != signs_f[n]).sum()) for n in acts}
    units = sum(signs_k[n].numel() for n in acts)
    share = sum(flips.values()) / units
    worst, worst_name = worst_of(grads_k, grads_x)
    free, free_name = worst_of(grads_k, grads_f)
    # the free comparison on the sequences that hold no flip
    keep = ~flipped_rows(signs_k, signs_f)
    rounds, settled = [], False
    clean, clean_name, loss_c = float("inf"), "", None
    while len(rounds) < 3 and int(keep.sum()) >= NMT_GRAD_MIN_CLEAN:
        weight = keep.float()
        _, grads_kc, signs_kc = step(weight)
        loss_c, grads_xc, signs_xc = plain_step(weight)
        rounds.append(int(keep.sum()))
        again = flipped_rows(signs_kc, signs_xc) & keep
        if not again.any():
            clean, clean_name = worst_of(grads_kc, grads_xc)
            settled = True
            break
        keep &= ~again
    kept = int(keep.sum())
    check(cuda_ops.launch_counts() == {
        n: c * (1 + len(rounds)) for n, c in launches.items()},
        "impl='xla' reached a kernel")
    print(f"nmt gradients: {len(grads_x)} parameters, {num_layers} + "
          f"{num_layers} layers at full width, kernels vs plain attention "
          f"with the kernels' ReLU signs: worst max abs err / max |grad| "
          f"{worst:.2e} ({worst_name}, tol {GRAD_RTOL}), loss "
          f"{loss_k:.6f} vs {loss_x:.6f}; free ReLUs, whole batch: "
          f"{free:.2e} ({free_name}) from {sum(flips.values())} sign flips "
          f"of {units} units (share {share:.2e}, tol {NMT_FLIP_SHARE}) "
          f"{flips}; free ReLUs on the {kept} of {NMT_BATCH} sequences "
          f"without a flip (rounds {rounds}): {clean:.2e} ({clean_name}, "
          f"tol {GRAD_RTOL})", flush=True)
    check(worst <= GRAD_RTOL, f"nmt gradients differ: {worst} at "
          f"{worst_name}")
    check(share <= NMT_FLIP_SHARE, f"nmt gradients: ReLU sign flips "
          f"{share:.2e} of all FFN units, beyond {NMT_FLIP_SHARE}")
    check(settled, f"nmt gradients: {kept} sequences without a flip after "
          f"{len(rounds)} rounds, {NMT_GRAD_MIN_CLEAN} needed")
    check(clean <= GRAD_RTOL, f"nmt gradients (free ReLUs, sequences "
          f"without a flip) differ: {clean} at {clean_name}")
    return {"layers": num_layers, "worst_rel_err": worst,
            "worst_param": worst_name, "free_relu_rel_err": free,
            "free_relu_param": free_name, "relu_sign_flips": flips,
            "relu_units": units, "relu_flip_share": share,
            "clean_rel_err": clean, "clean_param": clean_name,
            "clean_sequences": kept, "clean_rounds": rounds,
            "loss_kernels": loss_k, "loss_plain": loss_x,
            "loss_plain_free": loss_f, "loss_plain_clean": loss_c,
            "launches": launches}


def phase_nmt_train() -> dict:
    """Transformer-big trained through ``ShardedTrainer`` (Adam, lr 1e-4,
    float32, dropout 0.1, label-smoothed cross-entropy) on the three
    kernels: the fused and the eager step, timed in turns; losses finite
    and falling, 18 launches per kernel per step, one profiled step of
    each; then the gradient check."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch = nmt_batch(0)
    trainers = {"fused": nmt_trainer(nmt_model(), None),
                "eager": nmt_trainer(nmt_model(), False)}
    check(trainers["fused"].fused and not trainers["eager"].fused,
          "the NMT trainer is not fused by default")
    n_params = sum(p.numel() for p in trainers["fused"]._block.parameters())
    print(f"nmt train: Transformer-big ({n_params} parameters, vocab "
          f"{NMT_VOCAB}), batch {NMT_BATCH}, source {NMT_SRC}, target "
          f"{NMT_TGT}; trainers built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = {}
    for name, tr in trainers.items():
        runs[name] = train_run(tr, batch, NMT_STEPS, NMT_CALLS,
                               f"nmt {name}")
    placed = trainers["fused"].place(*batch)
    for name in ("eager", "fused"):   # in turns, after each path's run
        tr = trainers[name]
        runs[name]["step_ms_runs"] = [runs[name]["dt"] * 1e3, synced_ms(
            lambda: tr.step(*placed), NMT_STEPS)[0]]
    card = card_line()
    tokens = NMT_BATCH * NMT_TGT
    for name, r in runs.items():
        ms = min(r["step_ms_runs"])
        r["step_ms"], r["tgt_tokens_per_s"] = ms, tokens / (ms / 1e3)
        print(f"nmt train {name}: {ms:.3f} ms per step = "
              f"{r['tgt_tokens_per_s']:.1f} target tokens/s (runs "
              f"{[round(t, 3) for t in r['step_ms_runs']]}), first step "
              f"{r['first_step_ms']:.1f} ms, warm step "
              f"{r['warm_step_ms']:.1f} ms, captures {r['captures']}, "
              f"losses {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, "
              f"launches {r['launches']}, peak memory "
              f"{r['peak_memory_gib']:.2f} GiB on {card}", flush=True)
    check(runs["fused"]["captures"] == 1
          and runs["fused"]["last_step_graphs"] == 1,
          f"nmt fused trainer: {runs['fused']['captures']} captures")
    res = {"parameters": n_params, "runs": runs,
           "launches": runs["fused"]["launches"],
           "launches_eager": runs["eager"]["launches"]}
    for name, tr in trainers.items():
        res[f"profile_{name}"] = grouped_profiled_step(
            tr, placed, f"nmt {name}", NMT_GROUPS)
    del trainers, placed
    gc.collect()
    torch.cuda.empty_cache()
    res["gradients"] = nmt_grads()
    return res


def _prefix(seed: int, n: int) -> tuple:
    """A seeded source (one row, valid 96 of 128) and target prefix of
    ``n`` tokens starting with BOS."""
    rng = onp.random.RandomState(seed)
    src = rng.randint(3, NMT_VOCAB, (1, NMT_SRC)).astype("int32")
    tgt = rng.randint(3, NMT_VOCAB, (1, n)).astype("int32")
    tgt[0, 0] = nmt.BOS
    return src, onp.array([96.0], "float32"), tgt


def forced_logits(net, src, valid, tgt) -> dict:
    """The logits of every position of the target prefix ``tgt (1, n)``
    through the contiguous-cache step, the paged step (the pages scattered
    over a pool) and the full decoder forward on the kernels."""
    n = tgt.shape[1]
    dev = torch.device("cuda")
    s, v, t = (torch.from_numpy(a).to(dev) for a in (src, valid, tgt))
    params = nmt.incremental_decode_params(net)
    NL, U = len(params["layers"]), net._units
    with torch.no_grad(), autograd.predict_mode():
        mem, mask = net.encode(s, v)
        cross = nmt.cross_attention_kv(params, mem)
        key_mask = mask[:, 0, 0, :] > 0
        full = fully_connected_logits(net, net.decoder(
            net.tgt_embed(t), mem, mask))[0]
        ck = torch.zeros((NL, 1, n, U), device=dev)
        cv = torch.zeros_like(ck)
        bs = 16
        nb = -(-n // bs)
        pool = (4 * nb + 1, NL, bs, U)
        pk, pv = torch.zeros(pool, device=dev), torch.zeros(pool, device=dev)
        # pages scattered over the pool, none of them the scratch page 0
        table = torch.from_numpy(onp.random.RandomState(7).permutation(
            onp.arange(1, 4 * nb + 1))[:nb].astype("int32"))[None].to(dev)
        cont, paged = [], []
        for i in range(n):
            pos = torch.tensor([i], dtype=torch.int32, device=dev)
            tok = t[:, i]
            lc, _, _ = nmt.nmt_step(params, ck, cv, cross, key_mask, tok, pos)
            lp, _, _ = nmt.nmt_paged_step(params, bs, pk, pv, table, pos,
                                          tok, cross, key_mask)
            cont.append(lc[0])
            paged.append(lp[0])
    return {"full": full, "contiguous": torch.stack(cont),
            "paged": torch.stack(paged)}


def fully_connected_logits(net, out):
    return fully_connected(out, net.proj_weight._tensor(),
                           net.proj_bias._tensor(), flatten=False)


def phase_nmt_decode(net) -> dict:
    """The KV cache against the full re-decode at full width: a seeded
    prefix of 32 tokens forced through both cache layouts and the full
    decoder; then ``beam_search`` (K = 4) against ``beam_search_reference``
    on 4 prompts."""
    src, valid, tgt = _prefix(3, 32)
    got = forced_logits(net, src, valid, tgt)
    scale = got["full"].abs().max().item()
    errs = {k: (got[k] - got["full"]).abs().max().item() / scale
            for k in ("contiguous", "paged")}
    print(f"nmt decode: 32 forced positions, max abs err / max |logit| "
          f"({scale:.3f}): contiguous {errs['contiguous']:.2e}, paged "
          f"{errs['paged']:.2e} (tol {DECODE_RTOL})", flush=True)
    for k, e in errs.items():
        check(e <= DECODE_RTOL, f"nmt decode: the {k} cache's logits "
              f"differ from the full re-decode by {e} of the largest")
    rng = onp.random.RandomState(4)
    srcs = rng.randint(3, NMT_VOCAB, (4, NMT_SRC)).astype("int32")
    valids = onp.array([128.0, 100.0, 64.0, 17.0], "float32")
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    seqs, scores = nmt.beam_search(net, srcs, valids, beam_size=4,
                                   max_length=32)
    torch.cuda.synchronize()
    t_beam = time.perf_counter() - t0
    beam_launches = cuda_ops.launch_counts()
    t0 = time.perf_counter()
    rseqs, rscores = nmt.beam_search_reference(net, srcs, valids,
                                               beam_size=4, max_length=32)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    seqs, rseqs = seqs.cpu().numpy(), rseqs.cpu().numpy()
    diverge = []
    for b in range(seqs.shape[0]):
        for k in range(seqs.shape[1]):
            d = onp.nonzero(seqs[b, k] != rseqs[b, k])[0]
            if len(d):
                diverge.append({"row": b, "beam": k, "position": int(d[0])})
    print(f"nmt beam search (K=4, max_length 32, 4 prompts): cached "
          f"{t_beam:.3f} s, full re-decode {t_ref:.3f} s; scores "
          f"{scores.cpu().numpy().round(4).tolist()} vs "
          f"{rscores.cpu().numpy().round(4).tolist()}; first divergence "
          f"{diverge[:4] if diverge else 'none'}", flush=True)
    print(f"nmt beam search best sequences: {seqs[:, 0].tolist()}",
          flush=True)
    return {"rel_err": errs, "max_abs_logit": scale,
            "beam_seconds": t_beam, "reference_seconds": t_ref,
            "beam_launches": beam_launches,
            "sequences_equal": not diverge, "divergences": diverge,
            "scores": scores.cpu().numpy().tolist(),
            "reference_scores": rscores.cpu().numpy().tolist()}


def decode_drive(batcher, reqs, threads: int) -> dict:
    """Submit every request (from ``threads`` client threads, or all from
    this one when 0) and wait for every stream."""
    n = len(reqs)
    streams, errors = [None] * n, []
    batcher.metrics.reset()

    def client(idx, step):
        try:
            for i in range(idx, n, step):
                streams[i] = batcher.submit(reqs[i][0],
                                            max_new_tokens=reqs[i][1])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    if threads:
        ts = [threading.Thread(target=client, args=(c, threads))
              for c in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        check(not any(t.is_alive() for t in ts), "client threads hung")
    else:
        client(0, 1)
    check(not errors, f"submit failed: {errors[:3]}")
    outs = [s.result(timeout=600) for s in streams]
    wall = time.perf_counter() - t0
    snap = batcher.metrics.snapshot()
    check(snap["requests"] == n and snap["failed"] == 0
          and all(s.done() for s in streams),
          f"decode served {snap['requests']}/{n}, failed {snap['failed']}")
    return {"outs": outs, "wall_s": wall, "snapshot": snap,
            "tokens": sum(len(o) for o in outs)}


def step_ms(engine) -> dict:
    """The decode step's device ms by CUDA events: the replayed graph
    against the same step run eagerly, in turns."""
    res = {"replay_ms": [], "eager_ms": []}
    for _ in range(2):
        res["eager_ms"].append(cuda_ms(engine._step))
        res["replay_ms"].append(cuda_ms(engine._graph.replay))
    return res


def greedy_margin(net, src, valid, tokens, step: int) -> dict:
    """Top-2 logit margins at ``step`` of the greedy path ``tokens``
    forced through the paged step (the batcher's) and the contiguous one
    (``beam_search``'s)."""
    tgt = onp.array([[nmt.BOS] + list(tokens[:step])], "int32")
    got = forced_logits(net, src, valid, tgt)
    out = {}
    for k in ("paged", "contiguous"):
        top = torch.topk(got[k][step], 2).values
        out[k] = (top[0] - top[1]).item()
    return out


def phase_nmt_serve(net, seed: int) -> dict:
    """``DecodeBatcher`` over ``DecodeEngine`` at full width: 256 ragged
    requests from 4 threads, then all at once; the warm contract, the
    kernels' launches, the capacity, and greedy tokens against
    ``beam_search(K=1)``."""
    table = serve.BucketTable({"batch": (1, 1), "src": (8, NMT_SRC)})
    t0 = time.perf_counter()
    engine = serve.DecodeEngine(net, table, max_batch=32, block_size=16,
                                max_target_len=128)
    cap = engine.capacity
    check(cap["max_sequences"] == engine.pool.admission_limit()
          and engine.capacity_report() == cap,
          f"capacity {cap} vs admission limit "
          f"{engine.pool.admission_limit()}")
    cuda_ops.reset_launches()
    warm = engine.warmup()
    warm_launches = cuda_ops.launch_counts()
    print(f"nmt serve: engine built and warmed in "
          f"{time.perf_counter() - t0:.1f} s: {warm}", flush=True)
    # a budget that prices fewer seats than rows: the measured fixed bytes
    # plus the pages of 16 sequences and a margin
    per_seq = (serve.decode.block_bytes(NMT_LAYERS, NMT_CFG["units"], 16)
               * cap["blocks_per_seq"])
    budget = engine._fixed_bytes() + 16 * per_seq + per_seq // 2
    priced = serve.DecodeEngine(net, table, max_batch=32, block_size=16,
                                max_target_len=128, hbm_budget=budget)
    pcap = priced.capacity
    check(pcap["max_sequences"] == priced.pool.admission_limit()
          and priced.capacity_report() == pcap
          and 1 <= pcap["max_sequences"] <= 32,
          f"priced capacity {pcap} vs admission limit "
          f"{priced.pool.admission_limit()}")
    print(f"nmt serve: capacity {cap}; with a budget of {budget} bytes "
          f"{pcap}", flush=True)
    del priced
    rng = onp.random.RandomState(seed)
    reqs = [(rng.randint(3, NMT_VOCAB, int(rng.randint(8, 128))).astype(
        "int32"), int(rng.randint(16, 128))) for _ in range(256)]
    batcher = serve.DecodeBatcher(engine).start()
    cuda_ops.reset_launches()
    try:
        runs = {"threads": decode_drive(batcher, reqs, 4),
                "burst": decode_drive(batcher, reqs, 0)}
        launches = cuda_ops.launch_counts()
        probe = [reqs[i][0] for i in range(4)]
        greedy = [batcher.submit(p, max_new_tokens=31).result(timeout=600)
                  for p in probe]
    finally:
        batcher.stop()
    st = engine.stats()
    check(st["decode"]["post_warmup_compiles"] == 0
          and st["prefill"]["post_warmup_compiles"] == 0,
          f"post-warmup captures or first runs: {st}")
    check(launches[fa.KERNEL] > 0 and warm_launches[fa.KERNEL] > 0,
          f"prefill launched no forward kernel: {launches}")
    for name in (fa.KERNEL_BWD_DKV, fa.KERNEL_BWD_DQ):
        check(launches[name] == 0 and warm_launches[name] == 0,
              f"decode serving launched the backward kernel {name}")
    flips = []
    for p, got in zip(probe, greedy):
        valid = onp.array([float(len(p))], "float32")
        seqs, _ = nmt.beam_search(net, p[None], valid, beam_size=1,
                                  max_length=32)
        ref = [int(x) for x in seqs[0, 0].cpu().numpy()]
        n = min(len(got), len(ref))
        d = [i for i in range(n) if got[i] != ref[i]]
        if d:
            src = onp.zeros((1, NMT_SRC), "int32")
            src[0, :len(p)] = p
            margin = greedy_margin(net, src, valid, got, d[0])
            flips.append({"step": d[0], "batcher": got[d[0]],
                          "beam": ref[d[0]], "margin": margin})
            check(max(margin.values()) <= FLIP_MARGIN,
                  f"greedy tokens differ at step {d[0]} with top-2 margins "
                  f"{margin} above {FLIP_MARGIN}")
    timing = step_ms(engine)
    card = card_line()
    res = {"warmup": warm, "capacity": cap, "priced_capacity": pcap,
           "stats": st, "launches": launches,
           "warm_launches": warm_launches, "greedy_flips": flips,
           "step": timing}
    for name, r in runs.items():
        m = r["snapshot"]
        res[name] = {"wall_s": r["wall_s"], "tokens": r["tokens"],
                     "tokens_per_s": r["tokens"] / r["wall_s"],
                     "itl": m["itl"], "ttft": m["ttft"],
                     "step_occupancy": m["step_occupancy"],
                     "steps": m["steps"]}
        print(f"nmt serve {name}: {len(reqs)} streams, {r['tokens']} tokens "
              f"in {r['wall_s']:.3f} s = {res[name]['tokens_per_s']:.1f} "
              f"tokens/s, ITL p50 {m['itl']['itl_ms_p50']} p99 "
              f"{m['itl']['itl_ms_p99']} ms, TTFT p50 "
              f"{m['ttft']['ttft_ms_p50']} ms, occupancy "
              f"{m['step_occupancy']}, {m['steps']} steps on {card}",
              flush=True)
    print(f"nmt serve: decode step {min(timing['replay_ms']):.4f} ms "
          f"replayed vs {min(timing['eager_ms']):.4f} ms eager (CUDA events,"
          f" runs {timing}); pool {st['pool']}; launches {launches}; "
          f"greedy flips {flips or 'none'}", flush=True)
    return res


def phase_mt_gate() -> dict:
    """The JAX package's ``examples/machine_translation.py`` loop with its
    tier-1 configuration (copy task, 300 steps, seq-len 5, vocab 12,
    lr 0.002, batch 32; Adam through ``gluon.Trainer``, label smoothing
    0.1) on the card, then ``beam_search`` (K = 4): exact match above 0.8,
    as the reference asserts."""
    t0 = time.perf_counter()
    cuda_ops.reset_launches()
    out = nmt.mt_example(ctx=mx.gpu(0))
    launches = cuda_ops.launch_counts()
    print(f"mt gate: 300 steps, loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, beam-search exact match "
          f"{out['accuracy']:.4f} (gate 0.8), launches {launches}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(out["accuracy"] > 0.8, f"MT exact match {out['accuracy']} <= 0.8")
    check(all(n > 0 for n in launches.values()),
          f"the MT loop did not run every kernel: {launches}")
    return {"accuracy": out["accuracy"], "first_loss": out["losses"][0],
            "last_loss": out["losses"][-1], "launches": launches}


def phase_nmt(seed: int) -> dict:
    res = {"train": phase_nmt_train()}
    gc.collect()
    torch.cuda.empty_cache()
    net = nmt_model(dropout=0.0, seed=1)
    res["decode"] = phase_nmt_decode(net)
    res["serve"] = phase_nmt_serve(net, seed)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    res["mt_gate"] = phase_mt_gate()
    return res


# -- detection: SSD and Faster-RCNN ------------------------------------------
#: device-time groups of a detection step, by kernel name (the first match
#: wins): cuDNN's convolutions, the detection ops' sorts, scatters, gathers
#: and argmax reductions (cub radix sorts, ``scatter_gather``, ``index``
#: kernels), the optimizer's multi-tensor kernels, elementwise kernels, the
#: other reductions, pooling and GEMMs
DET_GROUPS = (
    ("conv", VISION_GROUPS[0][1]),
    ("sort_scatter_gather", ("sort", "radix", "scatter", "gather", "index",
                             "argmax", "argmin")),
    ("optimizer", ("multi_tensor",)),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
    ("pooling", ("pool",)),
    ("gemm", ("gemm",)),
)
# the detection ops on the card against the same port code on the CPU: the
# float outputs come from the same IEEE operations, but exp/log may differ
# in the last ulp between the two libraries; integer and boolean outputs
# (kept rows, matches, labels, the picked scores) must be equal
DET_OP_RTOL = 1e-5
DET_OP_ATOL = {"loc_target": 1e-5, "rois": 1e-3, "roi_align": 1e-5}
# one step's gradients of a small SSD / Faster-RCNN on the card against the
# CPU's: per parameter, max abs err <= DET_GRAD_RTOL * max |grad on CPU|
DET_GRAD_RTOL = 1e-3
#: the example gates' thresholds (``tests/test_examples.py:72-87``)
SSD_GATE, FRCNN_GATE = 0.8, 0.25
#: the small size of the fused-vs-eager gate and the gradient check
DET_SMALL = {"MXTPU_BENCH_BATCH": "2", "MXTPU_BENCH_IMG": "64"}


def _on(device, *arrays):
    return [torch.as_tensor(a).to(device) for a in arrays]


def _same_ints(name, card, cpu) -> int:
    """Check ``card == cpu`` exactly; returns the count of elements."""
    card = card.cpu()
    diff = (card != cpu).sum().item()
    check(diff == 0, f"{name}: {diff} of {cpu.numel()} elements differ "
          "between the card and the CPU")
    return cpu.numel()


def _close(name, card, cpu, atol) -> float:
    err = (card.cpu() - cpu).abs().max().item() if cpu.numel() else 0.0
    tol = atol + DET_OP_RTOL * cpu.abs().max().item()
    check(err <= tol, f"{name}: card vs CPU max abs err {err} > {tol}")
    return err


def det_ops_card_vs_cpu() -> dict:
    """(a) The detection ops at full-width shapes, the card against the CPU
    on the same inputs: ``multibox_target`` over SSD-300's 29,596 anchors
    (16 images, up to 4 boxes, predictions rounded so that many negative
    losses tie), ``multi_proposal`` at the frcnn bench's shape (8 images,
    7,056 anchors, top 1000, 128 after NMS; half of each map uniform, so
    scores tie), ``box_nms`` with ``topk=400`` over 16 x 29,596 rows with
    tied scores, and ``roi_align`` at 1,056 rois x 128 channels x 7x7
    (forward and the gradients for one seeded cotangent)."""
    from incubator_mxnet_tpu_torch.ops import detection as det
    rng = onp.random.RandomState(3)
    res = {}
    t0 = time.perf_counter()
    ssd = models.SSD(bench.DETECTION_CLASSES)
    anchors = torch.cat([det.multibox_prior(
        torch.zeros(1, 1, h, h), sizes=s, ratios=r)
        for h, s, r in zip((75, 37, 18, 9), ssd._sizes, ssd._ratios)], 1)
    N = anchors.shape[1]
    check(N == 29596, f"SSD-300 has {N} anchors, not 29,596")
    B, M, C1 = 16, 4, bench.DETECTION_CLASSES + 1
    label = onp.full((B, M, 5), -1.0, "float32")
    for b in range(B):
        for m in range(rng.randint(1, M + 1)):
            x0, y0 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            label[b, m] = [rng.randint(0, C1 - 1), x0, y0, x0 + w, y0 + h]
    pred = onp.round(rng.randn(B, C1, N), 1).astype("float32")
    pred[:, :, :N // 4] = 0.0                   # equal negative losses
    args = [anchors.numpy(), label, pred]
    outs = {}
    for dev in ("cpu", "cuda"):
        outs[dev] = det.multibox_target(*_on(dev, *args),
                                        negative_mining_ratio=3.0)
    res["multibox_target"] = {
        "anchors": N, "batch": B,
        "loc_target_max_abs_err": _close("loc_target", outs["cuda"][0],
                                         outs["cpu"][0],
                                         DET_OP_ATOL["loc_target"]),
        "loc_mask_equal": _same_ints("loc_mask", outs["cuda"][1],
                                     outs["cpu"][1]),
        "cls_target_equal": _same_ints("cls_target", outs["cuda"][2],
                                       outs["cpu"][2]),
        "positives": int((outs["cpu"][2] > 0).sum()),
        "mined_negatives": int((outs["cpu"][2] == 0).sum())}
    # multi_proposal at the frcnn bench's shape
    B, A, H = 8, 9, 28
    logits = rng.randn(B, 2, A, H, H).astype("float32")
    logits[:, :, :, H // 2:] = 0.25                         # uniform half
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    bbox = (0.1 * rng.randn(B, 4 * A, H, H)).astype("float32")
    bbox[:, :, H // 2:] = 0.0
    info = onp.tile([224, 224, 1.0], (B, 1)).astype("float32")
    kw = dict(rpn_pre_nms_top_n=1000, rpn_post_nms_top_n=bench.FRCNN_ROIS,
              threshold=0.7, rpn_min_size=4, scales=(4, 8, 16),
              ratios=(0.5, 1, 2), feature_stride=8, output_score=True)
    for dev in ("cpu", "cuda"):
        outs[dev] = det.multi_proposal(*_on(dev, prob.reshape(B, -1, H, H),
                                            bbox, info), **kw)
    res["multi_proposal"] = {
        "anchors": H * H * A, "batch": B,
        "rois_max_abs_err": _close("rois", outs["cuda"][0], outs["cpu"][0],
                                   DET_OP_ATOL["rois"]),
        # the picked scores are gathers of the same input: equal iff the
        # same anchors were picked in the same order
        "scores_equal": _same_ints("proposal scores (roi order)",
                                   outs["cuda"][1], outs["cpu"][1]),
        "batch_index_equal": _same_ints("roi batch index",
                                        outs["cuda"][0][:, 0],
                                        outs["cpu"][0][:, 0])}
    # box_nms with topk=400 over SSD-300's anchors
    B = 16
    data = onp.concatenate([
        rng.randint(0, C1 - 1, (B, N, 1)).astype("float32"),
        onp.round(rng.rand(B, N, 1), 2).astype("float32"),
        onp.sort(rng.rand(B, N, 2, 2), axis=2).transpose(
            0, 1, 3, 2).reshape(B, N, 4).astype("float32")], -1)
    for dev in ("cpu", "cuda"):
        outs[dev] = det.box_nms(*_on(dev, data), overlap_thresh=0.45,
                                valid_thresh=0.01, topk=400, id_index=0)
    res["box_nms"] = {"rows": N, "batch": B, "topk": 400,
                      "equal": _same_ints("box_nms", outs["cuda"],
                                          outs["cpu"]),
                      "kept": int((outs["cpu"][..., 0] >= 0).sum())}
    # roi_align at the frcnn head's shape, forward and backward
    R = 8 * (bench.FRCNN_ROIS + 4)
    feat = rng.randn(8, 128, 28, 28).astype("float32")
    rois = onp.zeros((R, 5), "float32")
    rois[:, 0] = onp.repeat(onp.arange(8), R // 8)
    xy = rng.uniform(0, 200, (R, 2))
    rois[:, 1:3] = xy
    rois[:, 3:5] = xy + rng.uniform(4, 120, (R, 2))
    cot = rng.randn(R, 128, 7, 7).astype("float32")
    grads = {}
    for dev in ("cpu", "cuda"):
        f, r, c = _on(dev, feat, rois, cot)
        f.requires_grad_(True)
        out = det.roi_align(f, r, pooled_size=(7, 7), spatial_scale=1 / 8,
                            sample_ratio=2)
        grads[dev] = torch.autograd.grad(out, f, c)[0]
        outs[dev] = out.detach()
    fwd = _close("roi_align", outs["cuda"], outs["cpu"],
                 DET_OP_ATOL["roi_align"])
    gerr = (grads["cuda"].cpu() - grads["cpu"]).abs().max().item() \
        / grads["cpu"].abs().max().item()
    check(gerr <= DET_GRAD_RTOL, f"roi_align gradient: card vs CPU {gerr}")
    f, r = _on("cuda", feat, rois)
    f.requires_grad_(True)
    c = torch.as_tensor(cot).cuda()

    def fwd_bwd():
        out = det.roi_align(f, r, pooled_size=(7, 7), spatial_scale=1 / 8)
        return torch.autograd.grad(out, f, c)

    res["roi_align"] = {"rois": R, "channels": 128, "pooled": [7, 7],
                        "max_abs_err": fwd, "grad_rel_err": gerr,
                        "fwd_bwd_ms": cuda_ms(fwd_bwd)}
    res["seconds"] = time.perf_counter() - t0
    print(f"detection ops, card vs CPU ({time.perf_counter() - t0:.1f} s):"
          f" multibox_target {res['multibox_target']}; multi_proposal "
          f"{res['multi_proposal']}; box_nms {res['box_nms']}; roi_align "
          f"{res['roi_align']}", flush=True)
    return res


def det_run(trainer, batch, steps: int, tag: str) -> dict:
    """The port bench's protocol on a detection trainer: losses, the first
    and warm steps apart, peak memory, and the flash kernels' launches
    (none: no attention on this path)."""
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    timings = {}
    dt, losses = bench.measure(trainer, batch, steps, timings)
    launches = cuda_ops.launch_counts()
    losses = [float(x) for x in losses]
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(not any(launches.values()), f"{tag}: the detection path launched "
          f"attention kernels: {launches}")
    return {"dt": dt, "losses": losses, "launches": launches,
            "first_step_ms": timings["first_step_s"] * 1e3,
            "warm_step_ms": timings["warm_step_s"] * 1e3,
            "captures": trainer.captures,
            "last_step_graphs": trainer.last_step_graphs,
            "last_path": trainer.last_path,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def det_detect(workload, net, batch) -> dict:
    """``SSD.detect`` / ``FasterRCNN.detect`` at the bench's size, timed on
    the host clock between synchronizes (a warm call first): shape, valid
    rows and ids in range."""
    args = [nd.array(a, ctx=mx.gpu(0))
            for a in batch[:1 if workload == "ssd" else 2]]

    def call():
        return net.detect(*args)

    dets = call()
    ms, _ = synced_ms(call, 3)
    d = dets.asnumpy()
    valid = d[..., 0] >= 0
    check(onp.isfinite(d).all(), f"{workload} detect: non-finite rows")
    check(((d[..., 0] < bench.DETECTION_CLASSES) & (d[..., 0] >= -1)).all(),
          f"{workload} detect: class ids out of range")
    return {"ms": ms, "shape": list(d.shape),
            "valid_rows": int(valid.sum())}


def det_bench(workload: str) -> dict:
    """(b) The port bench's ``ssd`` or ``frcnn`` workload at full size
    through the fused and the eager step, timed in turns: imgs/s, step ms,
    MFU, the first and warm (capture) steps apart, peak memory, one
    profiled step of each by group and its idle share; then ``detect`` at
    the same size."""
    gc.collect()
    torch.cuda.empty_cache()
    build = {"ssd": bench.build_ssd, "frcnn": bench.build_frcnn}[workload]
    t0 = time.perf_counter()
    fused, batch, info = build("cuda")
    eager, _, _ = build("cuda", fused=False)
    check(fused.fused and not eager.fused, f"the {workload} bench's trainer "
          "is not fused by default")
    steps = int(getenv("MXTPU_BENCH_STEPS"))
    runs = {"fused": det_run(fused, batch, steps, f"{workload} fused"),
            "eager": det_run(eager, batch, steps, f"{workload} eager")}
    check(runs["fused"]["captures"] == 1
          and runs["fused"]["last_step_graphs"] == 1
          and runs["fused"]["last_path"] == "fused"
          and runs["eager"]["last_path"] == "eager",
          f"{workload} trainers: {runs['fused']['captures']} captures, "
          f"{runs['fused']['last_step_graphs']} graphs in the last step")
    record = bench.detection_result(info, runs["fused"]["dt"],
                                    runs["fused"]["losses"],
                                    runs["fused"]["first_step_ms"] / 1e3)
    print(json.dumps(record), flush=True)
    placed = fused.place(*batch)
    for name, tr in (("eager", eager), ("fused", fused)):   # in turns
        runs[name]["step_ms_runs"] = [runs[name]["dt"] * 1e3, synced_ms(
            lambda: tr.step(*placed), steps)[0]]
    card = card_line()
    for name, r in runs.items():
        ms = min(r["step_ms_runs"])
        rec = bench.detection_result(info, ms / 1e3, r["losses"])
        r.update(step_ms=ms, imgs_per_s=info["batch"] / (ms / 1e3),
                 mfu=rec["extra"]["mfu"])
        print(f"{workload} {name}: batch {info['batch']} at {info['img']}: "
              f"{ms:.3f} ms per step = {r['imgs_per_s']:.1f} imgs/s, MFU "
              f"{r['mfu']:.4f} (runs "
              f"{[round(t, 3) for t in r['step_ms_runs']]}); first step "
              f"{r['first_step_ms']:.1f} ms, warm step "
              f"{r['warm_step_ms']:.1f} ms"
              f"{' (the capture)' if name == 'fused' else ''}; losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; peak memory "
              f"{r['peak_memory_gib']:.2f} GiB on {card}", flush=True)
    res = {"record": record, "runs": runs, "batch": info["batch"],
           "img": info["img"], "gmacs": info["gmacs"],
           "parameters": sum(p.numel() for p in info["net"].parameters()),
           "launches": runs["fused"]["launches"],
           "launches_eager": runs["eager"]["launches"]}
    for name, tr in (("fused", fused), ("eager", eager)):
        res[f"profile_{name}"] = grouped_profiled_step(
            tr, placed, f"{workload} {name}", DET_GROUPS)
    res["detect"] = det_detect(workload, info["net"], batch)
    print(f"{workload} detect: {res['detect']} on {card}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del fused, eager, placed, info
    return res


def det_fused_gate(steps: int = 3) -> dict:
    """(c) The fused detection step against the eager one under
    ``torch.use_deterministic_algorithms``, both models at a small size
    (batch 2, 64x64; the bench's configuration otherwise): losses and
    weights after ``steps`` steps bitwise equal."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    for workload, build in (("ssd", bench.build_ssd),
                            ("frcnn", bench.build_frcnn)):
        torch.use_deterministic_algorithms(True)
        try:
            with mock.patch.dict(os.environ, DET_SMALL):
                pairs = [build("cuda", fused=f) for f in (None, False)]
            losses = [[float(tr.step(*batch)) for _ in range(steps)]
                      for tr, batch, _ in pairs]
        finally:
            torch.use_deterministic_algorithms(False)
        nets = [p[2]["net"] for p in pairs]
        check(pairs[0][0].last_path == "fused"
              and pairs[0][0].last_step_graphs == 1
              and pairs[1][0].last_path == "eager",
              f"the {workload} gate's trainers did not take the fused and "
              "the eager step")
        weights, wname = _worst(nets, lambda p: p._var)
        same = losses[0] == losses[1] and weights == 0.0
        print(f"{workload} gate: batch 2 at 64, {steps} steps, fused vs "
              f"eager under deterministic algorithms: losses {losses[0]} "
              f"vs {losses[1]}; weights worst rel err {weights:.2e} "
              f"({wname}); bitwise {same}", flush=True)
        check(same, f"fused and eager {workload} steps differ: losses "
              f"{losses}, weights {weights} at {wname}")
        res[workload] = {"losses_fused": losses[0],
                         "losses_eager": losses[1], "bitwise": same}
    return res


def det_grads_vs_cpu() -> dict:
    """(d) One step's gradients of both models at the small size on the
    card, the fused and the eager step, against the same step on the CPU
    (the same weights and batch)."""
    gc.collect()
    res = {}
    for workload, build in (("ssd", bench.build_ssd),
                            ("frcnn", bench.build_frcnn)):
        runs = {}
        with mock.patch.dict(os.environ, DET_SMALL):
            for name, device, fused in (("fused", "cuda", None),
                                        ("eager", "cuda", False),
                                        ("cpu", "cpu", None)):
                tr, batch, info = build(device, fused=fused)
                runs[name] = (info["net"], float(tr.step(*batch)))
        cpu_net, cpu_loss = runs.pop("cpu")
        res[workload] = {"loss_cpu": cpu_loss}
        for name, (net, loss) in runs.items():
            rows = _rel_errs([net, cpu_net], lambda p: p._var.grad)
            worst, wname = rows[0]
            print(f"{workload} gradients, {name} step (batch 2 at 64): "
                  f"loss {loss:.6f} vs CPU {cpu_loss:.6f}; max abs err / "
                  f"max |grad|, worst three: "
                  + ", ".join(f"{r:.2e} ({k})" for r, k in rows[:3])
                  + f" (tol {DET_GRAD_RTOL})", flush=True)
            check(worst <= DET_GRAD_RTOL, f"{workload} gradients of the "
                  f"{name} step differ from the CPU's: {worst} at {wname}")
            check(abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss),
                  f"{workload} losses differ: card {loss}, CPU {cpu_loss}")
            res[workload][name] = {"loss_card": loss,
                                   "grads_worst_rel_err": worst,
                                   "grads_worst_param": wname}
    return res


def det_example_gates() -> dict:
    """(e) The JAX package's two detection examples on the card, with the
    thresholds of its tier-1 gates: ``ssd_example(steps=150)`` (hybridized
    SSD, ``gluon.Trainer``) above 0.8 and ``frcnn_example(steps=400)``
    above 0.25, each a top-detection hit rate on held-out images."""
    from incubator_mxnet_tpu_torch.models import rcnn, ssd
    res = {}
    for name, fn, steps, gate in (("ssd_example", ssd.ssd_example, 150,
                                   SSD_GATE),
                                  ("frcnn_example", rcnn.frcnn_example, 400,
                                   FRCNN_GATE)):
        gc.collect()
        t0 = time.perf_counter()
        cuda_ops.reset_launches()
        out = fn(steps=steps, ctx=mx.gpu(0))
        launches = cuda_ops.launch_counts()
        secs = time.perf_counter() - t0
        print(f"{name}: {steps} steps, loss {out['losses'][0]:.4f} -> "
              f"{out['losses'][-1]:.4f}, accuracy {out['accuracy']:.4f} "
              f"(gate {gate}), {secs:.1f} s", flush=True)
        check(out["accuracy"] > gate,
              f"{name} accuracy {out['accuracy']} <= {gate}")
        check(not any(launches.values()), f"{name} launched attention "
              f"kernels: {launches}")
        res[name] = {"accuracy": out["accuracy"], "steps": steps,
                     "first_loss": out["losses"][0],
                     "last_loss": out["losses"][-1], "seconds": secs,
                     "launches": launches}
    return res


def phase_detection() -> dict:
    """The detection path: (a) the ops card vs CPU, (b) the ``ssd`` and
    ``frcnn`` bench workloads with ``detect``, (c) fused vs eager, (d)
    card vs CPU gradients, (e) the two example gates."""
    t0 = time.perf_counter()
    res = {"ops": det_ops_card_vs_cpu()}
    for workload in ("ssd", "frcnn"):
        res[workload] = det_bench(workload)
    res["fused_gate"] = det_fused_gate()
    res["grads_vs_cpu"] = det_grads_vs_cpu()
    res.update(det_example_gates())
    res["seconds"] = time.perf_counter() - t0
    print(f"detection: {res['seconds']:.1f} s", flush=True)
    return res


# -- int8 serving and mixed-precision training --------------------------------
#: the int8 serving phase's calibration batch: 32 ragged requests drawn as
#: the serving phase draws its own, from this seed plus the run's seed
INT8_CALIB_SEED = 1
INT8_CALIB_REQUESTS = 32
#: served int8 outputs against unbatched int8 forwards (both on the flash
#: kernel; the int8 products are exact, the float parts the same kernels):
#: max abs err <= this times the largest |output|
INT8_SERVE_RTOL = 1e-3
#: the JAX package's accuracy gate of the bert_encoder smoke twin
#: (tests/test_quantization.py:298-314)
INT8_SMOKE_GATE = 0.05
#: the int8 forward's device-time groups: the wrappers whose kernels each
#: group collects (torch.profiler ranges around them, chip_smoke's own)
INT8_RANGES = ("int8:quantize", "int8:int_mm", "int8:bias", "int8:dequantize")
#: one full-width layer's shapes for the card-vs-CPU accumulator check:
#: (in, out) of qkv, proj, ffn1 and ffn2, at one 512-token request and at
#: the smallest bucket's 8 rows (padded to _int_mm's 17+ on the card)
INT8_LAYER_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
INT8_ROWS = (512, 8)


def _requests(rng, n: int) -> list:
    """``n`` ragged BERT requests as the serving phase draws them."""
    reqs = []
    for _ in range(n):
        L = int(rng.randint(4, 512))
        reqs.append((rng.randint(1, 30522, L).astype("int32"),
                     (onp.arange(L) >= L // 2).astype("int32"),
                     onp.array(L, "float32")))
    return reqs


def _padded_batch(reqs) -> list:
    """The requests as one batch padded with zeros to the longest, as
    ``CompiledModel`` pads."""
    Lmax = max(len(r[0]) for r in reqs)
    ids = onp.zeros((len(reqs), Lmax), "int32")
    tt = onp.zeros_like(ids)
    for i, (a, b, _) in enumerate(reqs):
        ids[i, :len(a)], tt[i, :len(b)] = a, b
    vl = onp.array([r[2] for r in reqs], "float32")
    return [torch.from_numpy(x).cuda() for x in (ids, tt, vl)]


def _param_bytes(block) -> int:
    return sum(p.numel() * p.element_size() for p in block.parameters())


class _Int8Ranges:
    """While active, each int8 op of ``ops/quantization.py`` runs inside a
    ``torch.profiler`` range named after it (:data:`INT8_RANGES`), so a
    profile attributes their kernels."""

    def __init__(self):
        from incubator_mxnet_tpu_torch.ops import quantization as tq
        self.tq = tq
        self.saved = {}

    def __enter__(self):
        from torch.profiler import record_function
        for name in ("quantize", "int_matmul", "_bias32", "dequantize"):
            fn = getattr(self.tq, name)
            label = {"int_matmul": "int8:int_mm",
                     "_bias32": "int8:bias"}.get(name, f"int8:{name}")

            def wrapped(*a, _fn=fn, _label=label, **k):
                with record_function(_label):
                    return _fn(*a, **k)
            self.saved[name] = fn
            setattr(self.tq, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.tq, name, fn)


def int8_forward_split(model, B: int = 32, L: int = 512) -> dict:
    """One forward at the largest bucket, timed with CUDA events, then
    split by ``torch.profiler``: the int8 ops' ranges (quantize, the
    ``_int_mm`` product, the bias re-encoding, dequantize), the flash
    kernel, and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(1, 30522, (B, L), device="cuda", generator=gen,
                        dtype=torch.int32)
    tt = torch.zeros_like(ids)
    vl = torch.full((B,), float(L), device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(ids, tt, vl), target_ms=300.0)
        with _Int8Ranges():
            model(ids, tt, vl)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(ids, tt, vl)
                torch.cuda.synchronize()
    total, flash, groups = 0.0, 0.0, {r: 0.0 for r in INT8_RANGES}
    for e in prof.events():
        if e.name in groups:
            # the range on the CPU holds its kernels' device time; its
            # copy on the device timeline is no kernel
            if e.device_type == DeviceType.CPU:
                groups[e.name] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            total += ms
            if "flash_fwd_kernel" in e.name:
                flash += ms
    groups["flash_fwd_kernel"] = flash
    groups["other"] = total - sum(groups.values())
    return {"bucket": [B, L], "forward_ms": fwd_ms,
            "profiled_device_ms": total, "ms_by_group": groups}


def int8_accumulators_vs_cpu(qblock) -> dict:
    """One layer's int8 products on the card against the CPU's plain
    version on the same int8 inputs: at the full-width shapes of layer 0
    (its own int8 weights for qkv, proj, ffn1 and ffn2) with one 512-token
    request and with 8 rows (padded for ``_int_mm``): the int32
    accumulators bitwise equal, and the dequantized float32 outputs too
    (the same IEEE operations)."""
    from incubator_mxnet_tpu_torch import quantization
    from incubator_mxnet_tpu_torch.ops import quantization as tq
    layers = [b for b in qblock.modules()
              if isinstance(b, quantization.QuantizedDense)][:4]
    rng = onp.random.RandomState(7)
    res = []
    for layer, (k, n) in zip(layers, INT8_LAYER_SHAPES):
        w = layer.qweight._tensor()
        check(tuple(w.shape) == (n, k), f"{layer.name}: weight "
              f"{tuple(w.shape)}, not {(n, k)}")
        for m in INT8_ROWS:
            x = torch.from_numpy(rng.randn(m, k).astype("float32") * 2)
            outs = {}
            for dev in ("cpu", "cuda"):
                qx, lo, hi = tq.quantize(x.to(dev), *layer._range)
                acc, olo, ohi = tq.quantized_fully_connected(
                    qx, w.to(dev), None, lo, hi, -1.0, 1.0, flatten=False)
                outs[dev] = (qx, acc, tq.dequantize(acc, olo, ohi))
            for i, name in enumerate(("quantized input", "accumulator",
                                      "dequantized output")):
                same = torch.equal(outs["cuda"][i].cpu(), outs["cpu"][i])
                check(same, f"{layer.name} at ({m}, {k}) x ({k}, {n}): the "
                      f"{name} differs between the card and the CPU")
            res.append({"layer": layer.name, "m": m, "k": k, "n": n,
                        "bitwise": True})
    print(f"int8 accumulators, card (torch._int_mm) vs CPU (int32 @): "
          f"bitwise equal for {len(res)} cases "
          f"{[(r['m'], r['k'], r['n']) for r in res]}", flush=True)
    return {"cases": res}


def phase_int8_serve(model, seed: int) -> dict:
    """BERT-base served int8: calibration with ``quantization.observe_net``
    on one batch of 32 ragged requests, ``quantization.quantize_model``
    into a quantized ``CompiledModel`` over the serving table, ``warmup``
    and ``DynamicBatcher``; the float and int8 models serve the same
    requests in turns (paced, then all at once); gates: every request
    answered, no post-warmup compile, the 48 encoder Dense layers and the
    pooler int8, served = unbatched int8 forwards, the forward kernel
    launched and the backward ones not, the accumulators bitwise equal to
    the CPU's; printed: the error against the float model, parameter
    bytes, latency and throughput, the forward's device split; then the
    ``bert_encoder`` smoke twin's gate on the card."""
    from incubator_mxnet_tpu_torch import quantization
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = models.serve_spec("bert_encoder")
    table = serve.BucketTable({"batch": (1, 32), "seq": (8, 512)})
    example = (onp.zeros((1, 8), "int32"), onp.zeros((1, 8), "int32"),
               onp.zeros((1,), "float32"))
    cm = serve.CompiledModel(model, table, spec["input_axes"], example,
                             output_axes=spec["output_axes"],
                             pad_values=spec["pad_values"])
    calib = _requests(onp.random.RandomState(seed + INT8_CALIB_SEED),
                      INT8_CALIB_REQUESTS)
    t1 = time.perf_counter()
    obs = quantization.observe_net(model, [_padded_batch(calib)])
    calib_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    qcm = quantization.quantize_model(cm, obs)
    quant_s = time.perf_counter() - t1
    qblock = qcm._block
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    qdense = [b.name for b in qblock.modules()
              if isinstance(b, quantization.QuantizedDense)]
    left = [b.name for b in qblock.modules()
            if isinstance(b, gluon.nn.Dense)]
    check(len(qdense) == 4 * n_layers + 1 and not left
          and any(n.endswith("pooler_int8") for n in qdense),
          f"{len(qdense)} QuantizedDense layers (want {4 * n_layers + 1}), "
          f"float Dense left: {left}")
    warm = {"float": cm.warmup(), "int8": qcm.warmup()}
    bytes_ = {"float": _param_bytes(model), "int8": _param_bytes(qblock)}
    print(f"int8 serve: calibrated on {len(calib)} ragged requests in "
          f"{calib_s:.1f} s, quantized in {quant_s:.1f} s, "
          f"{len(qdense)} QuantizedDense layers; parameter bytes "
          f"{bytes_['int8']:,} int8 vs {bytes_['float']:,} float32; warmup "
          f"{warm}", flush=True)

    reqs = _requests(onp.random.RandomState(seed), N_REQUESTS)
    gaps = onp.random.RandomState(seed).exponential(4.0 / OFFERED_RATE,
                                                    N_REQUESTS)
    runs, launches = {}, {}
    cms = {"float": cm, "int8": qcm}
    # in turns: paced float, int8; all at once int8, float
    for mode, order in (("paced", ("float", "int8")),
                        ("burst", ("int8", "float"))):
        for name in order:
            batcher = serve.DynamicBatcher(cms[name], max_delay_ms=5.0)
            cuda_ops.reset_launches()
            batcher.start()
            try:
                runs[(name, mode)] = drive(
                    batcher, cms[name], reqs,
                    gaps if mode == "paced" else onp.zeros(N_REQUESTS))
            finally:
                batcher.stop()
            launches[(name, mode)] = cuda_ops.launch_counts()
    int8_launches = {k: launches[("int8", "paced")][k]
                     + launches[("int8", "burst")][k] for k in fa.KERNELS}
    batches = sum(runs[("int8", m)]["snapshot"]["batches"]
                  for m in ("paced", "burst"))
    check(int8_launches[fa.KERNEL] >= n_layers * batches > 0,
          f"int8 serving launched {fa.KERNEL} {int8_launches[fa.KERNEL]} "
          f"times for {batches} batches of {n_layers} layers")
    for name in (fa.KERNEL_BWD_DKV, fa.KERNEL_BWD_DQ):
        check(int8_launches[name] == 0, f"int8 serving launched the "
              f"backward kernel {name}")

    # served int8 outputs against unbatched int8 forwards, and the float
    # model's error against int8 on the same requests
    picks = sorted(range(N_REQUESTS), key=lambda i: reqs[i][2])
    picks = [picks[int(j)] for j in onp.linspace(0, N_REQUESTS - 1, 8)]
    served = runs[("int8", "paced")]["outs"]
    served_f = runs[("float", "paced")]["outs"]
    worst, num, den = 0.0, 0.0, 0.0
    with torch.inference_mode():
        for i in picks:
            ids, tt, vl = (torch.from_numpy(a[None]).cuda() for a in reqs[i])
            seq, pooled = qblock(ids, tt, vl)
            got_seq, got_pooled = served[i]
            check(bool(torch.isfinite(got_seq).all()
                       and torch.isfinite(got_pooled).all()),
                  "served int8 outputs are not finite")
            for g, w in ((got_seq, seq[0]), (got_pooled, pooled[0])):
                worst = max(worst, ((g - w.cpu()).abs().max()
                                    / w.abs().max()).item())
            for g, f in zip(served[i], served_f[i]):
                num += (g - f).abs().sum().item()
                den += f.abs().sum().item()
    check(worst <= INT8_SERVE_RTOL, f"served vs unbatched int8 forward: "
          f"max abs err / max |out| {worst} > {INT8_SERVE_RTOL}")
    rel_vs_float = num / den
    card = card_line()
    res = {"requests": N_REQUESTS, "calibration_requests": len(calib),
           "calibration_s": calib_s, "quantize_s": quant_s,
           "quantized_dense": len(qdense), "param_bytes": bytes_,
           "warmup": warm, "served_vs_unbatched_rel_err": worst,
           "mean_rel_err_vs_float": rel_vs_float,
           "launches": int8_launches, "batches": batches}
    for (name, mode), r in runs.items():
        lat = r["snapshot"]["latency"]
        res[f"{name}_{mode}"] = {
            "wall_s": r["wall_s"], "req_s": N_REQUESTS / r["wall_s"],
            "p50_ms": lat["latency_ms_p50"], "p99_ms": lat["latency_ms_p99"],
            "batches": r["snapshot"]["batches"]}
        print(f"int8 serve, {name} {mode}: {N_REQUESTS} requests in "
              f"{r['wall_s']:.3f} s = {N_REQUESTS / r['wall_s']:.1f} req/s, "
              f"latency p50 {lat['latency_ms_p50']} ms p99 "
              f"{lat['latency_ms_p99']} ms, {r['snapshot']['batches']} "
              f"batches on {card}", flush=True)
    print(f"int8 serve: served vs unbatched int8 max rel err {worst:.2e} "
          f"(tol {INT8_SERVE_RTOL}); mean relative error against the float "
          f"model {rel_vs_float:.4f} (printed, not gated); launches "
          f"{int8_launches}", flush=True)
    res["accumulators"] = int8_accumulators_vs_cpu(qblock)
    res["split"] = {name: int8_forward_split(cms[name]._block)
                    for name in ("int8", "float")}
    for name, sp in res["split"].items():
        print(f"int8 serve, {name} forward at (32, 512): "
              f"{sp['forward_ms']:.3f} ms (CUDA events); profiled device "
              f"{sp['profiled_device_ms']:.3f} ms: "
              + ", ".join(f"{g} {t:.3f}" for g, t in
                          sp["ms_by_group"].items()), flush=True)
    smoke = models.quantized_smoke("bert_encoder", device="cuda")
    args = models.calib_args("bert_encoder", seed=5, device="cuda")
    want = smoke["f32"]["compiled"].predict(*args)
    got = smoke["compiled"].predict(*args)
    rels = [((w - g).abs().mean() / (w.abs().mean() + 1e-6)).item()
            for w, g in zip(want, got)]
    print(f"int8 serve: bert_encoder smoke twin on the card, mean rel err "
          f"{[round(r, 5) for r in rels]} (gate {INT8_SMOKE_GATE})",
          flush=True)
    check(max(rels) < INT8_SMOKE_GATE, f"bert_encoder smoke twin: {rels}")
    res["smoke_rel_err"] = rels
    res["seconds"] = time.perf_counter() - t0
    del qcm, cm, qblock
    return res


#: AMP gradients of a 2-layer BERT at full width on the card against the
#: CPU's: bfloat16 keeps 8 significant bits, and the card (cuBLAS, the
#: flash kernels) and the CPU (oneDNN, the plain attention) round GEMM
#: outputs, GELU and the attention probabilities to bfloat16 at the same
#: places from float32 values summed in another order, so some round to the
#: neighbouring bfloat16; a few such flips compound through two layers
#: forward and back (the CPU parity test against the JAX package sees up
#: to 2.4e-2): per parameter, max abs err <= this times max |grad on CPU|
AMP_GRAD_RTOL = 5e-2
#: the AMP gradient check's batch: 2 sequences of the bench's 512 (the CPU
#: side computes the full-width step too)
AMP_GRAD_BATCH = 2
#: device-time groups of a BERT training step under AMP and in float32, by
#: kernel name (the first match wins): the three flash kernels, the GEMMs
#: (cuBLAS's and CUTLASS's, SIMT float32 and bf16 tensor-core kernels),
#: dtype casts and copies, the optimizer's multi-tensor kernels,
#: reductions (LayerNorm statistics, softmax, the loss), the other
#: elementwise kernels
AMP_GROUPS = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("cast_copy", ("copy_kernel",)),
    ("optimizer", ("multi_tensor",)),
    ("reduce", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise",)),
)
#: the example gate of the JAX package's tests/test_examples.py:29-33, run
#: on the example's default model (its mobilenet0.25 is not ported)
AMP_EXAMPLE = dict(model="resnet18_v1", epochs=2, classes=4, batch_size=16)
AMP_EXAMPLE_GATE = 0.5


class _amp_on:
    """``amp.init("bfloat16")`` while active (``on``), else the float32
    namespace; restores the previous state on exit."""

    def __init__(self, on: bool = True):
        from incubator_mxnet_tpu_torch import amp
        self.amp, self.on = amp, on

    def __enter__(self):
        self.prev = self.amp._STATE["initialized"]
        if self.on:
            self.amp.init("bfloat16")
        else:
            self.amp.reset()
        return self

    def __exit__(self, *exc):
        if self.prev:
            self.amp.init("bfloat16")
        else:
            self.amp.reset()


class _launch_dtypes:
    """Record the dtype of q at every call of the flash kernels' launch
    wrapper (eager launches and the launches a capture records)."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        self.orig = fa._launch

        def spy(name, q, *a, **k):
            key = (name, str(q.dtype).replace("torch.", ""))
            self.seen[key] = self.seen.get(key, 0) + 1
            return self.orig(name, q, *a, **k)
        fa._launch = spy
        return self

    def __exit__(self, *exc):
        fa._launch = self.orig

    def dtypes(self) -> dict:
        return {f"{n}:{d}": c for (n, d), c in sorted(self.seen.items())}


def _bert_trainer(fused, num_layers: int = None, dropout: float = 0.1,
                  device: str = "cuda"):
    """BERT-base at the bench's configuration with float32 weights (AdamW
    at lr 1e-4), on ``device``."""
    kw = {} if num_layers is None else {"num_layers": num_layers}
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=TRAIN_SHAPE[1], dropout=dropout,
                          dtype="float32", device=device,
                          generator=torch.Generator().manual_seed(0), **kw)
    return net, parallel.ShardedTrainer(
        net, models.bert_pretrain_loss, "adamw", {"learning_rate": 1e-4},
        device=device, n_labels=3, fused=fused)


def amp_bert_train() -> dict:
    """(b1) BERT-base (bench configuration, float32 weights) under
    ``amp.init("bfloat16")`` through the fused and the eager step, timed
    in turns against the same steps without AMP: step ms, tokens/s,
    losses finite and falling, 12 launches per kernel per step with bf16
    q (recorded at the wrapper), one profiled step of each by group."""
    gc.collect()
    torch.cuda.empty_cache()
    batch = bench.make_batch(*TRAIN_SHAPE)
    steps = int(getenv("MXTPU_BENCH_STEPS"))
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    res = {}
    for path, fused in (("fused", None), ("eager", False)):
        trainers, runs = {}, {}
        for name, on in (("float32", False), ("amp", True)):
            _, trainers[name] = _bert_trainer(fused)
            with _amp_on(on), _launch_dtypes() as spy:
                runs[name] = train_run(trainers[name], batch, steps,
                                       n_layers, f"amp train {name} {path}")
            runs[name]["launch_dtypes"] = spy.dtypes()
        want = "bfloat16"
        for key in runs["amp"]["launch_dtypes"]:
            check(key.endswith(want), f"amp {path}: a kernel took "
                  f"{key}: {runs['amp']['launch_dtypes']}")
        for key in runs["float32"]["launch_dtypes"]:
            check(key.endswith("float32"), f"float32 {path}: {key}")
        placed = trainers["amp"].place(*batch)
        # in turns: amp, float32, float32, amp (each path's own run first)
        for name in ("amp", "float32", "float32", "amp"):
            with _amp_on(name == "amp"):
                runs[name].setdefault("step_ms_runs", [
                    runs[name]["dt"] * 1e3]).append(synced_ms(
                        lambda: trainers[name].step(*placed), steps)[0])
        card = card_line()
        for name, r in runs.items():
            ms = min(r["step_ms_runs"])
            r.update(step_ms=ms, tokens_per_s=tokens / (ms / 1e3))
            with _amp_on(name == "amp"):
                r["profile"] = grouped_profiled_step(
                    trainers[name], placed, f"amp train {name} {path}",
                    AMP_GROUPS)
            print(f"amp train {path}, {name}: {ms:.3f} ms per step = "
                  f"{r['tokens_per_s']:.1f} tokens/s (runs "
                  f"{[round(t, 3) for t in r['step_ms_runs']]}), losses "
                  f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, "
                  f"launches {r['launches']}, q dtypes at the wrapper "
                  f"{r['launch_dtypes']}, peak memory "
                  f"{r['peak_memory_gib']:.2f} GiB on {card}", flush=True)
        if path == "fused":
            check(runs["amp"]["captures"] == 1
                  and runs["amp"]["last_path"] == "fused",
                  f"the AMP fused trainer: {runs['amp']['captures']} "
                  "captures")
        res[path] = runs
        del trainers, placed
        gc.collect()
        torch.cuda.empty_cache()
    return res


def amp_fused_gate(num_layers: int = 2, steps: int = 3) -> dict:
    """The train gate (phase 7) under AMP: at full width and
    ``num_layers`` layers, dropout 0, float32 weights, under
    ``torch.use_deterministic_algorithms``, the fused step against the
    eager one over ``steps`` steps: losses and weights within 1e-5 of each
    parameter's largest value."""
    gc.collect()
    torch.cuda.empty_cache()
    batch = bench.make_batch(*TRAIN_SHAPE)
    torch.use_deterministic_algorithms(True)
    try:
        with _amp_on():
            pairs = [_bert_trainer(f, num_layers, dropout=0.0)
                     for f in (None, False)]
            losses = [[float(tr.step(*batch)) for _ in range(steps)]
                      for _, tr in pairs]
    finally:
        torch.use_deterministic_algorithms(False)
    check(pairs[0][1].last_step_graphs == 1 and pairs[0][1].captures == 1,
          "the AMP gate's fused trainer did not replay a graph")
    worst, wname = 0.0, ""
    eager = dict(pairs[1][0].named_parameters())
    for name, p in pairs[0][0].named_parameters():
        want = eager[name].detach().float()
        ratio = ((p.detach().float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30)).item()
        if ratio > worst:
            worst, wname = ratio, name
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    print(f"amp train gate, {num_layers} layers at full width, {steps} "
          f"steps, fused vs eager under deterministic algorithms: losses "
          f"{losses[0]} vs {losses[1]} (worst rel err {loss_err:.2e}), "
          f"weights worst rel err {worst:.2e} ({wname})", flush=True)
    check(loss_err <= 1e-5 and worst <= 1e-5, f"AMP fused and eager steps "
          f"differ: losses {loss_err}, weights {worst} at {wname}")
    return {"losses_fused": losses[0], "losses_eager": losses[1],
            "loss_rel_err": loss_err, "weights_worst_rel_err": worst,
            "weights_worst_param": wname,
            "bitwise": loss_err == 0.0 and worst == 0.0}


def amp_grads_vs_cpu(num_layers: int = 2) -> dict:
    """One AMP step's gradients of a ``num_layers``-layer BERT at full
    width (dropout 0, float32 weights) on the card (fused trainer, its
    first step) against the same step on the CPU (eager), within
    :data:`AMP_GRAD_RTOL` of each parameter's largest."""
    gc.collect()
    batch = bench.make_batch(AMP_GRAD_BATCH, TRAIN_SHAPE[1])
    out = {}
    with _amp_on():
        for device in ("cuda", "cpu"):
            net, tr = _bert_trainer(None, num_layers, dropout=0.0,
                                    device=device)
            loss = float(tr.step(*batch))
            out[device] = (loss, {n: p.grad.detach().float().cpu()
                                  for n, p in net.named_parameters()})
    (lc, gc_), (lx, gx) = out["cuda"], out["cpu"]
    worst, wname = 0.0, ""
    for name, g in gx.items():
        ratio = ((gc_[name] - g).abs().max()
                 / g.abs().max().clamp_min(1e-30)).item()
        if ratio > worst:
            worst, wname = ratio, name
    print(f"amp gradients, {num_layers} layers at full width, batch "
          f"{AMP_GRAD_BATCH}x{TRAIN_SHAPE[1]}: card vs CPU worst max abs err"
          f" / max |grad| {worst:.2e} ({wname}, tol {AMP_GRAD_RTOL}); loss "
          f"{lc:.6f} vs {lx:.6f}", flush=True)
    check(worst <= AMP_GRAD_RTOL, f"AMP gradients differ: {worst} at "
          f"{wname}")
    check(abs(lc - lx) <= 1e-2 * abs(lx), f"AMP losses differ: {lc}, {lx}")
    return {"worst_rel_err": worst, "worst_param": wname,
            "loss_card": lc, "loss_cpu": lx}


def amp_resnet() -> dict:
    """(b2) ResNet-50 v1 (1000 classes, batch 32, 224x224, float32
    weights) through the image-classification example loop, hybridized,
    with ``--amp`` and without, in turns: imgs/s and step ms of the last
    epoch (16 steps; the first epoch holds the eager first call and the
    captures), losses finite; no attention kernel."""
    from incubator_mxnet_tpu_torch.models import image_classification as ic
    res = {}
    for name in ("float32", "amp", "amp", "float32"):
        gc.collect()
        torch.cuda.empty_cache()
        cuda_ops.reset_launches()
        with _amp_on(False):           # the example's --amp turns it on
            out = ic.image_classification_example(
                model="resnet50_v1", classes=1000, image_size=224,
                epochs=2, batch_size=32, amp=name == "amp", ctx=mx.gpu(0))
        launches = cuda_ops.launch_counts()
        check(all(onp.isfinite(out["losses"])), f"resnet50 {name}: "
              f"non-finite loss")
        check(not any(launches.values()), f"resnet50 {name} launched "
              f"attention kernels: {launches}")
        secs = out["epoch_seconds"][-1]
        steps = len(out["losses"]) // len(out["epoch_seconds"])
        r = res.setdefault(name, {"epoch_s_runs": [], "launches": launches,
                                  "first_epoch_s": out["epoch_seconds"][0],
                                  "losses": out["losses"]})
        r["epoch_s_runs"].append(secs)
        r["imgs_per_s"] = 32 * steps / min(r["epoch_s_runs"])
        r["step_ms"] = min(r["epoch_s_runs"]) / steps * 1e3
    card = card_line()
    for name, r in res.items():
        print(f"amp resnet50_v1 example loop, {name}: {r['step_ms']:.3f} ms "
              f"per step = {r['imgs_per_s']:.1f} imgs/s (last-epoch runs "
              f"{[round(s, 3) for s in r['epoch_s_runs']]} s), first epoch "
              f"{r['first_epoch_s']:.1f} s, loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f} on {card}", flush=True)
    return res


def amp_example_gate() -> dict:
    """(b3) The example's own gate with ``--amp``: resnet18_v1, 2 epochs,
    4 classes, batch 16, training accuracy above 0.5."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch.models import image_classification as ic
    gc.collect()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    try:
        out = ic.image_classification_example(amp=True, ctx=mx.gpu(0),
                                              **AMP_EXAMPLE)
    finally:
        amp.reset()
    launches = cuda_ops.launch_counts()
    secs = time.perf_counter() - t0
    print(f"amp example gate: {AMP_EXAMPLE}, --amp: accuracy "
          f"{out['epochs']} (gate {AMP_EXAMPLE_GATE}), loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
          f"{secs:.1f} s", flush=True)
    check(out["accuracy"] > AMP_EXAMPLE_GATE, f"the example's accuracy "
          f"{out['accuracy']} <= {AMP_EXAMPLE_GATE}")
    check(not any(launches.values()), f"the example launched attention "
          f"kernels: {launches}")
    return {"accuracy": out["accuracy"], "epochs": out["epochs"],
            "seconds": secs, "launches": launches}


def phase_amp() -> dict:
    """Mixed-precision training: (b1) BERT-base under AMP, fused and
    eager, against float32, with its fused = eager gate and card vs CPU
    gradients; (b2) ResNet-50 through the example loop; (b3) the
    example's gate."""
    t0 = time.perf_counter()
    res = {"bert": amp_bert_train()}
    res["fused_gate"] = amp_fused_gate()
    res["grads_vs_cpu"] = amp_grads_vs_cpu()
    res["resnet"] = amp_resnet()
    res["example"] = amp_example_gate()
    res["seconds"] = time.perf_counter() - t0
    print(f"amp: {res['seconds']:.1f} s", flush=True)
    return res


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
    model = served.pop("model")
    profiled = phase_profile(model)
    int8_res = phase_int8_serve(model, args.seed)
    del model
    trained = phase_train()
    gate = phase_train_fused_gate()
    grads = phase_train_grads()
    glu = phase_gluon(trained)
    vis = phase_vision()
    nmt_res = phase_nmt(args.seed)
    det_res = phase_detection()
    amp_res = phase_amp()

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
                                     glu["launches_hybrid"][name],
                                 "vision": vis["launches"][name],
                                 "nmt_train": nmt_res["train"]["launches"][
                                     name],
                                 "nmt_train_eager": nmt_res["train"][
                                     "launches_eager"][name],
                                 "nmt_serve": nmt_res["serve"]["launches"][
                                     name],
                                 "mt_gate": nmt_res["mt_gate"]["launches"][
                                     name],
                                 "ssd": det_res["ssd"]["launches"][name],
                                 "frcnn": det_res["frcnn"]["launches"][name],
                                 "ssd_example": det_res["ssd_example"][
                                     "launches"][name],
                                 "frcnn_example": det_res["frcnn_example"][
                                     "launches"][name],
                                 "int8_serve": int8_res["launches"][name],
                                 "amp_train": amp_res["bert"]["fused"][
                                     "amp"]["launches"][name],
                                 "amp_train_eager": amp_res["bert"][
                                     "eager"]["amp"]["launches"][name],
                                 "amp_resnet": amp_res["resnet"]["amp"][
                                     "launches"][name],
                                 "amp_example": amp_res["example"][
                                     "launches"][name]},
            "max_abs_err": worst(name, "float32"),
            "max_abs_err_bf16": worst(name, "bfloat16"),
            "ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "shape": [rec[k] for k in ("B", "H", "Lq", "Lk", "D")],
            "dtype": rec["dtype"],
            "nmt_cross": {k: rec["nmt_cross"][k] for k in (
                "B", "H", "Lq", "Lk", "D", "dtype", "ms", "device_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernel_cases": results,
                       "serve": served, "profile": profiled,
                       "train": trained, "train_fused_gate": gate,
                       "train_gradients": grads,
                       "gluon": glu, "vision": vis, "nmt": nmt_res,
                       "detection": det_res, "int8_serve": int8_res,
                       "amp": amp_res, "kernels": kernels},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
