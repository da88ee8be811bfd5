"""BERT pretraining through ``parallel.ShardedTrainer`` with checkpoint and
resume (JAX counterpart: ``examples/bert_pretraining.py``; reference:
GluonNLP ``scripts/bert/run_pretraining.py``).

The same flags and the same synthetic masked-LM batch as the JAX example:
the model (``--model``, vocabulary 1,000 for ``bert_2_128_2``, else
30,522), dropout 0.1, weights in ``--dtype`` (default bfloat16) with fp32
masters under AdamW, one batch drawn from ``RandomState(0)`` and trained
on every step. The first step sets the trainer up (its state, the fused
step's first eager run); with ``--ckpt-dir`` the trainer then resumes from
the newest verified checkpoint there, runs only the remaining steps, and
saves every ``--ckpt-every`` steps and after the last (atomic: a run killed
at any point resumes from the last complete checkpoint). Run on the
card::

    python3 -m incubator_mxnet_tpu_torch.models.bert_pretraining \\
        --model bert_12_768_12 --seq-len 512 --batch-size 8 --ckpt-dir D

On one card the mesh is 1x1x1: ``--dp``/``--tp``/``--sp`` above 1 need the
multi-GPU slice, and ``--remat`` per-layer rematerialisation, which
``get_bert`` does not have; both raise. ``--zero1`` shards optimizer
states over ``dp``, which is 1 here: it changes nothing.

A length-bucketed corpus for the same step: :class:`SyntheticCorpus`
(token sequences of given lengths, each sample drawn from its own seed,
so any worker makes the same one), :func:`bucket_lengths` (lengths whose
count in each bucket is a multiple of the batch size, so every batch of a
``gluon.data.FixedBucketSampler`` is full and the fused step captures one
graph per bucket) and :class:`BucketBatchify` (a batch padded to its
bucket key, the seven arrays of :func:`synthetic_batch`).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as onp
import torch

from ..base import MXNetError
from ..gluon.data.dataset import Dataset

__all__ = ["synthetic_batch", "parse_args", "build", "main",
           "bucket_lengths", "SyntheticCorpus", "BucketBatchify"]

MASK_RATE = 0.15      # BERT's share of masked positions


def synthetic_batch(rng, B, L, P, vocab) -> tuple:
    """``(ids, token_types, valid_length, masked_positions, mlm_labels,
    mlm_weights, nsp_labels)`` drawn from ``rng`` (JAX counterpart:
    ``examples/bert_pretraining.py:24``)."""
    ids = rng.randint(0, vocab, (B, L)).astype("int32")
    token_types = rng.randint(0, 2, (B, L)).astype("int32")
    valid_len = onp.full((B,), L, "float32")
    positions = rng.randint(0, L, (B, P)).astype("int32")
    mlm_labels = rng.randint(0, vocab, (B, P)).astype("float32")
    mlm_weights = onp.ones((B, P), "float32")
    nsp_labels = rng.randint(0, 2, (B,)).astype("float32")
    return (ids, token_types, valid_len, positions, mlm_labels, mlm_weights,
            nsp_labels)


def bucket_lengths(n: int, bucket_keys, batch_size: int, low: int,
                   seed: int = 0) -> onp.ndarray:
    """``n`` sequence lengths in ``[low, bucket_keys[-1]]``, uniform within
    each bucket, each bucket's count in proportion to its width and a
    multiple of ``batch_size`` (the last bucket takes the rest), shuffled
    by ``RandomState(seed)``."""
    keys = sorted(bucket_keys)
    rng = onp.random.RandomState(seed)
    bounds = [low - 1] + keys
    span = keys[-1] - low + 1
    counts = [int(n * (hi - lo) / span) // batch_size * batch_size
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    counts[-1] = n - sum(counts[:-1])
    if counts[-1] % batch_size:
        raise MXNetError(f"{n} sequences do not split into full batches "
                         f"of {batch_size}")
    lengths = onp.concatenate([
        rng.randint(lo + 1, hi + 1, c)
        for lo, hi, c in zip(bounds[:-1], bounds[1:], counts)])
    rng.shuffle(lengths)
    return lengths.astype("int32")


class SyntheticCorpus(Dataset):
    """A ``gluon.data`` dataset of token sequences: sample ``i`` has
    ``lengths[i]`` tokens and segment ids, ``round(MASK_RATE *
    max_length)`` masked positions below its length with their labels,
    and an NSP label, all drawn from ``RandomState(seed + i)``: numpy only,
    the same in any process."""

    def __init__(self, lengths, vocab: int, max_length: int, seed: int = 0):
        self._lengths = onp.asarray(lengths)
        self._vocab = vocab
        self._p = max(1, round(MASK_RATE * max_length))
        self._seed = seed

    def __len__(self):
        return len(self._lengths)

    def __getitem__(self, i):
        n = int(self._lengths[i])
        rng = onp.random.RandomState(self._seed + int(i))
        ids = rng.randint(0, self._vocab, n).astype("int32")
        token_types = rng.randint(0, 2, n).astype("int32")
        positions = rng.randint(0, n, self._p).astype("int32")
        labels = rng.randint(0, self._vocab, self._p).astype("float32")
        nsp = onp.float32(rng.randint(0, 2))
        return ids, token_types, positions, labels, nsp


class BucketBatchify:
    """A ``DataLoader`` batchify: the corpus samples padded to the smallest
    bucket key that holds the longest, as the seven arrays of
    :func:`synthetic_batch` (``round(MASK_RATE * key)`` masked positions,
    weights 1). Numpy only, so it runs in forked workers."""

    def __init__(self, bucket_keys):
        self._keys = sorted(bucket_keys)

    def __call__(self, samples):
        longest = max(len(s[0]) for s in samples)
        key = next(k for k in self._keys if k >= longest)
        p = max(1, round(MASK_RATE * key))
        B = len(samples)
        ids = onp.zeros((B, key), "int32")
        token_types = onp.zeros((B, key), "int32")
        for r, s in enumerate(samples):
            ids[r, :len(s[0])] = s[0]
            token_types[r, :len(s[1])] = s[1]
        valid = onp.array([len(s[0]) for s in samples], "float32")
        positions = onp.stack([s[2][:p] for s in samples])
        labels = onp.stack([s[3][:p] for s in samples])
        weights = onp.ones((B, p), "float32")
        nsp = onp.array([s[4] for s in samples], "float32")
        return [ids, token_types, valid, positions, labels, weights, nsp]


def parse_args(argv=None) -> argparse.Namespace:
    """The example's command line (JAX counterpart: ``:37-63``)."""
    from .bert import BERT_CONFIGS
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="bert_2_128_2",
                    choices=sorted(BERT_CONFIGS))
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--remat", action="store_true",
                    help="rematerialise each encoder layer (not in the "
                         "port's get_bert: raises)")
    ap.add_argument("--zero1", action="store_true",
                    help="shard optimizer states over dp (dp is 1 here)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="mx.fault checkpoint directory: resumes from the "
                         "newest verified step on start, saves every "
                         "--ckpt-every steps (atomic; kill-safe)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed; default: MXNET_TEST_SEED or 42")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, device=None, **trainer_kw) -> tuple:
    """``(net, trainer, batch)`` of the example on ``device`` (default: the
    card): the model seeded from ``--seed``, the fused ``ShardedTrainer``
    (AdamW with fp32 masters; ``trainer_kw`` such as ``guard=`` and
    ``watchdog=`` go to it) and the synthetic batch as numpy arrays."""
    from .. import random
    from ..context import resolve_device
    from ..parallel import ShardedTrainer
    from .bert import bert_pretrain_loss, get_bert

    if args.dp * args.tp * args.sp > 1:
        raise MXNetError(
            f"--dp {args.dp} --tp {args.tp} --sp {args.sp}: a mesh over more "
            "than one card comes with the multi-GPU slice; this build trains "
            "on one card (1x1x1)")
    if args.remat:
        raise MXNetError("--remat: the port's get_bert has no per-layer "
                         "rematerialisation")
    seed = args.seed if args.seed is not None \
        else int(os.environ.get("MXNET_TEST_SEED", "42"))
    random.seed(seed)
    dev = resolve_device(device)
    vocab = 1000 if args.model == "bert_2_128_2" else 30522
    P = max(1, round(0.15 * args.seq_len))
    net = get_bert(args.model, vocab_size=vocab, max_length=args.seq_len,
                   dropout=0.1, dtype=args.dtype, device=dev,
                   generator=torch.Generator().manual_seed(seed))
    trainer = ShardedTrainer(
        net, bert_pretrain_loss, "adamw",
        {"learning_rate": args.lr, "multi_precision": True}, device=dev,
        n_labels=3, seed=seed, **trainer_kw)
    rng = onp.random.RandomState(0)
    batch = synthetic_batch(rng, args.batch_size, args.seq_len, P, vocab)
    return net, trainer, batch


def main(argv=None, device=None) -> Optional[float]:
    """Run the example (module docstring); returns the last printed loss."""
    from .. import fault

    args = parse_args(argv)
    _, trainer, batch = build(args, device)
    trainer.step(*batch)      # set-up: state, the fused step's first run
    start = 0
    if args.ckpt_dir:
        try:
            resumed = trainer.restore_checkpoint(args.ckpt_dir)
            # checkpoint steps count the set-up step too: finish only the
            # remaining work
            start = min(max(resumed - 1, 0), args.steps)
            print(f"resumed from checkpoint step {resumed}; "
                  f"{args.steps - start} step(s) remaining")
        except fault.CheckpointError:
            pass              # cold start: nothing saved yet
    placed = trainer.place(*batch)
    last = None
    for step in range(start, args.steps):
        loss = trainer.step(*placed)
        if args.ckpt_dir and (step % args.ckpt_every == 0
                              or step == args.steps - 1):
            trainer.save_checkpoint(args.ckpt_dir)
        if step % 5 == 0 or step == args.steps - 1:
            last = float(loss)
            print(f"step {step:4d}  loss {last:.4f}")
    return last


if __name__ == "__main__":
    main()
