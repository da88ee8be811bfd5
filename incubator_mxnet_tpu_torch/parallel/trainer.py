"""Single-device training step over a ``torch.nn.Module``.

Counterpart: the JAX package's ``parallel/trainer.py`` (``ShardedTrainer``,
``:73-515``), the subset one device runs: forward on the data arguments,
``loss_fn`` on the outputs and labels, mean, backward, the global gradient
norm in fp32 (``:394-395``), the finite check (``:496-497``) and the
optimizer update, on an fp32 master copy where the weight is
float16/bfloat16 and ``multi_precision`` is set (``:471-481``). The mesh,
sharding, ZeRO-1, the kvstore fallback, guard policies, numerics, autotune
and checkpoints come with later slices.

The port's parameters are the module's own: the step updates them in
place, so :meth:`ShardedTrainer.sync_to_block` has nothing to do. After a
step each parameter's ``.grad`` holds that step's gradient. No step waits
for the card: the loss, the gradient norm and the finite verdict stay on
the device until a caller reads them.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as onp
import torch
from torch import nn

from .. import autograd
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import resolve_device
from ..nn import set_dropout_generator

__all__ = ["ShardedTrainer"]

_HALF = (torch.float16, torch.bfloat16)


class ShardedTrainer:
    """Drives a module's training on one device (JAX counterpart:
    ``parallel/trainer.py:73``).

    ``optimizer`` is a registered name (``"adamw"``) or an
    :class:`~..optimizer.Optimizer`. ``device`` defaults to the card and
    raises without one; the module is moved there. The forward runs under
    ``autograd.train_mode()`` (Dropout active); every ``Dropout`` of the
    module draws from one generator on that device, seeded with ``seed``.
    """

    def __init__(self, block: nn.Module, loss_fn: Callable, optimizer,
                 optimizer_params: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 n_labels: int = 1, seed: int = 0):
        self._device = resolve_device(device)
        self._block = block.to(self._device)
        self._loss_fn = loss_fn
        self._optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self._n_labels = n_labels
        self.generator = torch.Generator(device=self._device).manual_seed(seed)
        set_dropout_generator(block, self.generator)
        self._params: Optional[List[nn.Parameter]] = None
        self._states: Optional[list] = None
        self._mp: Optional[List[bool]] = None
        self._t = 0
        self._last = None            # (grad norm, finite) on the device

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_update(self) -> int:
        return self._t

    @property
    def last_grad_norm(self) -> Optional[float]:
        """The last step's global gradient norm, accumulated in fp32
        (reading it waits for the card)."""
        return None if self._last is None else float(self._last[0])

    @property
    def last_finite(self) -> Optional[bool]:
        """Were the last step's loss and gradient norm finite?"""
        return None if self._last is None else bool(self._last[1])

    def _init_state(self) -> None:
        """Parameters in sorted-name order (the JAX trainer's order),
        their optimizer states, and which of them update through an fp32
        master (``_mp``)."""
        opt = self._optimizer
        self._params = [p for _, p in sorted(self._block.named_parameters())]
        self._states = [opt.create_state_multi_precision(i, p.detach())
                        for i, p in enumerate(self._params)]
        self._mp = [bool(opt.multi_precision and p.dtype in _HALF and s
                         and s[0].dtype == torch.float32
                         and s[0].shape == p.shape)
                    for p, s in zip(self._params, self._states)]

    def place(self, *batch) -> tuple:
        """Batch arrays (numpy or tensors) as tensors on the device; tensors
        already there pass through."""
        out = []
        for a in batch:
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                onp.ascontiguousarray(a))
            out.append(t.to(self._device, non_blocking=True))
        return tuple(out)

    def step(self, *batch) -> torch.Tensor:
        """One training step on ``batch`` = data arguments then
        ``n_labels`` labels; returns the mean loss (a device scalar)."""
        n_data = len(batch) - self._n_labels
        if n_data < 1:
            raise MXNetError("step() needs at least one data argument")
        if self._params is None:
            self._init_state()
        vals = self.place(*batch)
        self._t += 1
        t, opt, params = self._t, self._optimizer, self._params
        for p in params:
            p.grad = None
        with autograd.train_mode():
            out = self._block(*vals[:n_data])
            loss = torch.mean(self._loss_fn(out, *vals[n_data:]))
        loss.backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            finite = torch.isfinite(loss) & torch.isfinite(gnorm)
            for i, (p, g) in enumerate(zip(params, grads)):
                self._states[i] = opt.update(i, p, g, self._states[i])
        opt.num_update = t
        self._last = (gnorm, finite)
        return loss.detach()

    def sync_to_block(self) -> None:
        """Nothing to write back: the parameters are the module's own."""
