"""Learning-rate schedules.

Counterpart: the JAX package's ``lr_scheduler.py`` (``:1-168``): the base
``LRScheduler`` with its linear or exponential warm-up, ``FactorScheduler``,
``MultiFactorScheduler``, ``PolyScheduler``, ``CosineScheduler`` and
``LinearWarmUp``. ``sched(num_update)`` is the host schedule, in Python
floats, the same numbers as the JAX package's. ``sched.torch_lr(t)`` is its
device twin, the counterpart of ``jax_lr`` (``:48``): the schedule as torch
ops on a device tensor ``t`` (the update count), so the fused
``parallel.ShardedTrainer`` step reads the learning rate inside its CUDA
graph without a host evaluation or transfer. It computes in float32, as
``jax_lr`` does, and matches the host schedule up to float32 rounding.
"""
from __future__ import annotations

import math
from typing import List

import torch

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "LinearWarmUp"]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 scalar on ``like``'s device, by a fill (no host
    copy, so a CUDA graph can capture it)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


class LRScheduler:
    """Base schedule with warm-up (JAX counterpart: ``lr_scheduler.py:11``):
    ``warmup_steps`` updates from ``warmup_begin_lr`` to ``base_lr``,
    linearly for ``warmup_mode="linear"``, else exponentially."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update: int) -> float:
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = ((self.warmup_final_lr - self.warmup_begin_lr)
                   * num_update / self.warmup_steps)
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr + (
            self.warmup_final_lr - self.warmup_begin_lr) * (
            1 - math.exp(-num_update / max(self.warmup_steps / 5.0, 1e-8)))

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError

    # -- device twin -----------------------------------------------------
    def _torch_warmup_lr(self, t: torch.Tensor) -> torch.Tensor:
        """``get_warmup_lr`` on a device update count (JAX counterpart:
        ``_jax_warmup_lr``, ``:32``)."""
        tf = t.to(torch.float32)
        span = _f32(self.warmup_final_lr - self.warmup_begin_lr, t)
        begin = _f32(self.warmup_begin_lr, t)
        if self.warmup_mode == "linear":
            return begin + span * tf / _f32(self.warmup_steps, t)
        return begin + span * (
            1.0 - torch.exp(-tf / max(self.warmup_steps / 5.0, 1e-8)))

    def _torch_main_lr(self, t: torch.Tensor) -> torch.Tensor:
        """The schedule after warm-up; subclasses implement it."""
        raise NotImplementedError

    def torch_lr(self, t: torch.Tensor) -> torch.Tensor:
        """The schedule at the device update count ``t`` (an integer
        tensor), as a float32 device scalar (JAX counterpart: ``jax_lr``,
        ``:48``). Warm-up is a ``where``, not Python control flow, so one
        captured graph covers the whole run."""
        t = t.clamp_min(0)
        main = self._torch_main_lr(t)
        if not self.warmup_steps:
            return main.to(torch.float32)
        return torch.where(t < self.warmup_steps, self._torch_warmup_lr(t),
                           main).to(torch.float32)


class FactorScheduler(LRScheduler):
    """``base_lr * factor ** (num_update // step)``, floored at
    ``stop_factor_lr`` (JAX counterpart: ``lr_scheduler.py:68``)."""

    def __init__(self, step: int, factor=1.0, stop_factor_lr=1e-8,
                 base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update: int) -> float:
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr * (self.factor ** (num_update // self.step))
        return max(lr, self.stop_factor_lr)

    def _torch_main_lr(self, t):
        n = torch.div(t, self.step, rounding_mode="floor").to(torch.float32)
        lr = _f32(self.base_lr, t) * torch.pow(_f32(self.factor, t), n)
        return torch.maximum(lr, _f32(self.stop_factor_lr, t))


class MultiFactorScheduler(LRScheduler):
    """``base_lr * factor ** (steps passed)`` (JAX counterpart:
    ``lr_scheduler.py:88``)."""

    def __init__(self, step: List[int], factor=1.0, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = sorted(step)
        self.factor = factor

    def __call__(self, num_update: int) -> float:
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = sum(1 for s in self.step if s <= num_update)
        return self.base_lr * (self.factor ** n)

    def _torch_main_lr(self, t):
        n = torch.zeros((), dtype=torch.float32, device=t.device)
        for s in self.step:
            n = n + (t >= s).to(torch.float32)
        return _f32(self.base_lr, t) * torch.pow(_f32(self.factor, t), n)


class PolyScheduler(LRScheduler):
    """Polynomial decay to ``final_lr`` at ``max_update`` (JAX
    counterpart: ``lr_scheduler.py:105``)."""

    def __init__(self, max_update: int, base_lr=0.01, pwr=2, final_lr=0.0,
                 **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update: int) -> float:
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        t = min(num_update - self.warmup_steps,
                self.max_update - self.warmup_steps)
        frac = 1.0 - t / max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * (
            frac ** self.power)

    def _torch_main_lr(self, t):
        span = max(self.max_update - self.warmup_steps, 1)
        tt = torch.minimum((t - self.warmup_steps).to(torch.float32),
                           _f32(span, t))
        frac = 1.0 - tt / _f32(span, t)
        return _f32(self.final_lr, t) + _f32(
            self.base_lr - self.final_lr, t) * torch.pow(
            frac, _f32(self.power, t))


class CosineScheduler(LRScheduler):
    """Cosine decay to ``final_lr`` at ``max_update`` (JAX counterpart:
    ``lr_scheduler.py:129``)."""

    def __init__(self, max_update: int, base_lr=0.01, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update: int) -> float:
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        t = min(num_update - self.warmup_steps,
                self.max_update - self.warmup_steps)
        frac = t / max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * 0.5 * (
            1 + math.cos(math.pi * frac))

    def _torch_main_lr(self, t):
        span = max(self.max_update - self.warmup_steps, 1)
        tt = torch.minimum((t - self.warmup_steps).to(torch.float32),
                           _f32(span, t))
        frac = tt / _f32(span, t)
        return _f32(self.final_lr, t) + _f32(
            self.base_lr - self.final_lr, t) * 0.5 * (
            1.0 + torch.cos(_f32(math.pi, t) * frac))


class LinearWarmUp(LRScheduler):
    """Linear warm-up in front of another schedule (JAX counterpart:
    ``lr_scheduler.py:153``)."""

    def __init__(self, schedule: LRScheduler, start_lr: float, length: int):
        super().__init__(schedule.base_lr, warmup_steps=length,
                         warmup_begin_lr=start_lr)
        self.schedule = schedule

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self.schedule(num_update)

    def _torch_main_lr(self, t):
        return self.schedule.torch_lr(t)
