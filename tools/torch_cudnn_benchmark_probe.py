#!/usr/bin/env python3
"""Probe of ``torch.backends.cudnn.benchmark`` on the PyTorch port's vision
path, on one NVIDIA card.

Run from the root of a checkout::

    python3 tools/torch_cudnn_benchmark_probe.py [--out probe.json]

Each case runs in a fresh process, since cuDNN's engine choices are cached
for the life of one:

- ``grads``: ResNet-18 v1 (float32, batch 8, 64x64, Xavier from seed 0);
  with ``benchmark`` on, one train-mode forward and backward first, then
  ``benchmark`` off; then one step's parameter gradients on the card
  against the same gradients on the CPU in float64: the worst
  ``max |err| / max |grad|`` and its parameter;
- ``bench``: the port bench's ``resnet`` workload (ResNet-50 v1, bf16,
  batch 32, 224x224, fused step) with ``benchmark`` on or off: step ms,
  first-step seconds and the last loss.

It prints one JSON line per case and the card's ``nvidia-smi`` name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grads(device: str, dtype: str) -> dict:
    """One ResNet-18 step's gradients (suffix name -> float64 CPU tensor)
    under ``autograd.train_mode()``, after one warm-up forward."""
    import numpy as onp
    import torch
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon
    net = gluon.model_zoo.vision.get_model("resnet18_v1", classes=1000)
    net.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(
        0)), ctx=mx.Context.from_device(torch.device(device)))
    rng = onp.random.RandomState(1)
    x = torch.from_numpy(rng.randn(8, 3, 64, 64).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 1000, (8,)).astype("float32"))
    x, y = x.to(device), y.to(device)
    with torch.no_grad(), autograd.train_mode():
        net(x)
    if dtype == "float64":
        for p in net.collect_params().values():
            p.cast("float64")
        x = x.double()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.train_mode():
        loss = ce(net(x), y).mean()
    n = len(net.prefix)
    named = [(k[n:], p._var) for k, p in net.collect_params().items()
             if p._var.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {k: g.detach().double().cpu() for (k, _), g in zip(named, grads)}


def case_grads(benchmark: bool) -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if benchmark:
        torch.backends.cudnn.benchmark = True
        _grads("cuda", "float32")
        torch.backends.cudnn.benchmark = False
    got = _grads("cuda", "float32")
    want = _grads("cpu", "float64")
    rows = sorted((((got[k] - w).abs().max() / w.abs().max()).item(), k)
                  for k, w in want.items() if w.abs().max() > 0)
    return {"case": "grads", "benchmark_first": benchmark,
            "worst_rel_err": rows[-1][0], "worst_param": rows[-1][1]}


def case_bench(benchmark: bool) -> dict:
    import torch
    from incubator_mxnet_tpu_torch import bench
    torch.backends.cudnn.benchmark = benchmark
    trainer, batch, info = bench.build_resnet("cuda")
    timings = {}
    dt, losses = bench.measure(trainer, batch, 20, timings)
    return {"case": "bench", "benchmark": benchmark,
            "model": info["model"], "step_ms": dt * 1e3,
            "first_step_s": timings["first_step_s"],
            "last_loss": float(losses[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=("grads", "bench"))
    ap.add_argument("--benchmark", choices=("on", "off"))
    ap.add_argument("--out", help="also write the results to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.case:
        fn = case_grads if args.case == "grads" else case_bench
        print(json.dumps(fn(args.benchmark == "on")), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe runs on the card")
    results = []
    for case in ("grads", "bench"):
        for flag in ("off", "on", "off"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--case", case,
                 "--benchmark", flag], capture_output=True, text=True,
                check=True, cwd=ROOT, timeout=600).stdout
            results.append(json.loads(out.strip().splitlines()[-1]))
            print(json.dumps(results[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
