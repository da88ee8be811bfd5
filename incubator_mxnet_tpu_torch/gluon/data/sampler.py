"""Samplers (JAX counterpart: ``gluon/data/sampler.py``; reference:
``python/mxnet/gluon/data/sampler.py``). The shuffles draw from numpy's
global stream, as the JAX ones do, so one ``numpy.random.seed`` gives one
order in both packages."""
from __future__ import annotations

import numpy as onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FixedBucketSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start: int = 0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A new permutation at each pass."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = onp.random.permutation(self._length)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


_LAST_BATCH = ("keep", "discard", "rollover")


class BatchSampler(Sampler):
    """Groups a sampler's indices into batches; ``last_batch`` is
    ``"keep"``, ``"discard"`` or ``"rollover"`` (the partial batch starts
    the next pass)."""

    def __init__(self, sampler: Sampler, batch_size: int,
                 last_batch: str = "keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    f"last_batch must be one of {', '.join(_LAST_BATCH)}, "
                    f"but got {self._last_batch}")

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(
            f"last_batch must be one of {', '.join(_LAST_BATCH)}, but got "
            f"{self._last_batch}")


class FixedBucketSampler(Sampler):
    """Length-bucketing batch sampler (GluonNLP's ``FixedBucketSampler``):
    each sample goes to the first bucket key at least its length; each
    bucket is cut into batches of ``batch_size`` (larger for shorter keys
    when ``ratio > 0``) in sample order, the last one of a bucket possibly
    partial; ``shuffle`` permutes the batches at each pass."""

    def __init__(self, lengths, batch_size, num_buckets=10, ratio=0.0,
                 shuffle=False, bucket_keys=None):
        self._lengths = onp.asarray(lengths)
        self._batch_size = batch_size
        self._shuffle = shuffle
        mn, mx = int(self._lengths.min()), int(self._lengths.max())
        if bucket_keys is None:
            if num_buckets <= 1:
                bucket_keys = [mx]
            else:
                step = max(1, (mx - mn) // num_buckets)
                bucket_keys = list(range(mn + step, mx, step)) + [mx]
        self._bucket_keys = sorted(set(int(k) for k in bucket_keys))
        buckets = {k: [] for k in self._bucket_keys}
        for i, length in enumerate(self._lengths):
            for k in self._bucket_keys:
                if length <= k:
                    buckets[k].append(i)
                    break
        self._batches = []
        for k, idxs in buckets.items():
            bs = max(int(batch_size * (1 + ratio * (self._bucket_keys[-1] - k)
                                       / self._bucket_keys[-1])), batch_size) \
                if ratio > 0 else batch_size
            for s in range(0, len(idxs), bs):
                self._batches.append(idxs[s:s + bs])

    @property
    def bucket_keys(self):
        return self._bucket_keys

    def __iter__(self):
        order = onp.random.permutation(len(self._batches)) if self._shuffle \
            else range(len(self._batches))
        for i in order:
            yield self._batches[i]

    def __len__(self):
        return len(self._batches)

    def stats(self) -> str:
        return (f"FixedBucketSampler: {len(self._batches)} batches, "
                f"keys={self._bucket_keys}")
