"""BERT pretraining throughput of the port, on the card.

Counterpart: the BERT training branch of the JAX package's ``bench.py``
(``:923-981``) and its ``_measure`` (``:205-225``): the same configuration
(``bert_12_768_12``, bfloat16, dropout 0.1, batch 8, sequence 512, 15% of
positions masked, MLM + NSP heads, ``bert_pretrain_loss``, AdamW at lr
1e-4 with fp32 master weights), the same seeded numpy batch, the same
FLOP formula and the same JSON keys. The trainer takes its fused step on
the card (one CUDA-graph replay per step) unless ``MXTPU_FUSED_STEP=0``.
Knobs: ``MXTPU_BENCH_MODEL``, ``MXTPU_BENCH_BATCH``, ``MXTPU_BENCH_SEQ``,
``MXTPU_BENCH_STEPS``, ``MXTPU_BENCH_DROPOUT``, ``MXTPU_FUSED_STEP`` and
``MXTPU_PEAK_TFLOPS``. Run on the card from
the root of a checkout::

    python3 -m incubator_mxnet_tpu_torch.bench

It prints one JSON line. It runs on the card and raises without one;
``run(device="cpu")`` drives the same code on the CPU for tests.
"""
from __future__ import annotations

import json
import time
from typing import Optional

import numpy as onp
import torch

from . import models
from .context import resolve_device
from .parallel import ShardedTrainer
from .util import getenv, peak_tflops

__all__ = ["make_batch", "build", "measure", "result", "run", "main"]

VOCAB = 30522


def make_batch(B: int, L: int, vocab: int = VOCAB) -> tuple:
    """The bench's batch: ``(ids, token_types, valid_length,
    masked_positions, mlm_labels, mlm_weights, nsp_labels)`` as numpy
    arrays, drawn from seed 0 in ``bench.py``'s order
    (``bench.py:951-959``)."""
    P = max(1, round(0.15 * L))      # BERT's 15% masking rate
    rng = onp.random.RandomState(0)
    ids = rng.randint(0, vocab, (B, L)).astype("int32")
    tt = rng.randint(0, 2, (B, L)).astype("int32")
    vl = onp.full((B,), L, "float32")
    pos = rng.randint(0, L, (B, P)).astype("int32")
    mlm_lab = rng.randint(0, vocab, (B, P)).astype("float32")
    mlm_w = onp.ones((B, P), "float32")
    nsp = rng.randint(0, 2, (B,)).astype("float32")
    return ids, tt, vl, pos, mlm_lab, mlm_w, nsp


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(trainer: ShardedTrainer, batch: tuple, steps: int) -> tuple:
    """``bench.py``'s protocol (``_measure``): a first step (set-up), the
    batch placed on the device, a warm step, then ``steps`` timed steps
    with one synchronize at the end. Returns ``(seconds per step, every
    step's loss)``; the losses are device scalars, read after the timing.
    A fused trainer runs its first step eagerly and captures its graph on
    the warm step, so the timed steps are replays."""
    losses = [trainer.step(*batch)]
    _sync(trainer.device)
    batch = trainer.place(*batch)
    losses.append(trainer.step(*batch))
    _sync(trainer.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.step(*batch))
    _sync(trainer.device)
    return (time.perf_counter() - t0) / steps, losses


def build(device=None, fused: Optional[bool] = None) -> tuple:
    """The bench's model, trainer and batch on ``device`` (default: the
    card): ``(trainer, batch, info)``, ``info`` holding what
    :func:`result` needs (model name and config, batch, sequence, device,
    parameter count). ``fused`` is ``ShardedTrainer``'s."""
    dev = resolve_device(device)
    model_name = getenv("MXTPU_BENCH_MODEL")
    B = int(getenv("MXTPU_BENCH_BATCH"))
    L = int(getenv("MXTPU_BENCH_SEQ"))
    dropout = float(getenv("MXTPU_BENCH_DROPOUT"))
    net = models.get_bert(model_name, vocab_size=VOCAB, max_length=L,
                          dropout=dropout, dtype="bfloat16", device=dev,
                          generator=torch.Generator().manual_seed(0))
    trainer = ShardedTrainer(net, models.bert_pretrain_loss, "adamw",
                             {"learning_rate": 1e-4,
                              "multi_precision": True},
                             device=dev, n_labels=3, fused=fused)
    info = {"model": model_name, "cfg": models.BERT_CONFIGS[model_name],
            "batch": B, "seq": L, "device": dev,
            "params": sum(p.numel() for p in net.parameters())}
    return trainer, make_batch(B, L), info


def result(info: dict, dt: float, losses) -> dict:
    """``bench.py``'s result record (``bench.py:963-980``) for ``dt``
    seconds per step, ending at ``losses[-1]``."""
    B, L, cfg = info["batch"], info["seq"], info["cfg"]
    tokens_per_sec = B * L / dt
    # 6 * n_params * n_tokens for the matmuls plus 12 * layers * units *
    # L^2 * B for attention (fwd + bwd): bench.py:967-970
    flops = (6 * info["params"] * B * L
             + 12 * cfg["num_layers"] * cfg["units"] * L * L * B)
    mfu = (flops / dt) / (peak_tflops() * 1e12)
    return {
        "metric": f"{info['model']}_pretrain_tokens_per_sec_per_chip",
        "value": round(tokens_per_sec, 1),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(mfu / 0.40, 4),
        "extra": {"step_ms": round(dt * 1e3, 2), "mfu": round(mfu, 4),
                  "batch": B, "seq": L, "remat": False,
                  "params": info["params"], "backend": info["device"].type,
                  "loss": float(losses[-1])},
    }


def run(device=None, steps: Optional[int] = None) -> tuple:
    """Build, train and time the bench on ``device`` (default: the card).
    Returns ``(record, losses)``: ``bench.py``'s result record and every
    step's loss as floats."""
    steps = int(getenv("MXTPU_BENCH_STEPS")) if steps is None else steps
    trainer, batch, info = build(device)
    dt, losses = measure(trainer, batch, steps)
    losses = [float(x) for x in losses]
    return result(info, dt, losses), losses


def main() -> None:
    print(json.dumps(run()[0]))


if __name__ == "__main__":
    main()
