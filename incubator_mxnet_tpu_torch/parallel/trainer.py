"""Single-device training step over a ``torch.nn.Module``, fused into one
CUDA graph.

Counterpart: the JAX package's ``parallel/trainer.py`` (``ShardedTrainer``,
``:73-515``), the subset one device runs: forward on the data arguments,
``loss_fn`` on the outputs and labels, mean, backward, the global gradient
norm in fp32 (``:390-395``), the finite verdict (``:492-497``) and the
optimizer update, on an fp32 master copy where the weight is
float16/bfloat16 and ``multi_precision`` is set (``:471-481``); the learning
rate is the optimizer's before the step and its schedule position is the
step count less one (``:425-448``, ``:611-633``). The mesh, sharding,
ZeRO-1, the kvstore fallback, guard policies, numerics, autotune and
checkpoints come with later slices.

Two paths, as in the JAX package (``fused=``, ``:127-135``):

- **fused** (the default on the card; ``MXTPU_FUSED_STEP=0`` or
  ``fused=False`` opts out): the whole step is one function over static
  buffers (:class:`_FusedStep`): the batch copied into buffers of its
  signature (shapes and dtypes), ``lr`` and ``t`` device scalars written
  before each step, then forward under ``train_mode``, the mean loss,
  ``torch.autograd.grad``, the norm from one ``torch._foreach_norm``, the
  finite verdict and ``Optimizer.update_multi`` over every parameter, in
  place, its bias corrections and schedule computed on the device. The
  first step of a signature runs it eagerly on the capture stream (a real
  step, the counterpart of JAX's first trace), the second captures it into
  a CUDA graph and replays it, and every later step only replays it: one
  update per ``step()``. A new signature captures a new graph
  (:attr:`captures` counts them as JAX counts compiles); a capture error
  raises. After a step each parameter's ``.grad`` is the graph's gradient
  buffer, holding that step's gradient.
- **eager** (the CPU, or ``fused=False``): the same step in PyTorch's own
  way, ``loss.backward()`` and the per-parameter ``Optimizer.step``, the
  plain path the fused one is held against. Its ``t`` is a device scalar
  too, so both paths compute the same bias corrections: on the card, under
  ``torch.use_deterministic_algorithms``, they give the same bits.

``fused=None`` on a CPU device runs eagerly; ``fused=True`` there raises.
The CPU tests run the fused function without capture
(``_fused_step(..., capture=False)``). The port's parameters are the
module's own, updated in place, so :meth:`ShardedTrainer.sync_to_block`
has nothing to do. No step waits for the card: the loss, the gradient norm
and the finite verdict stay on the device until a caller reads them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as onp
import torch
from torch import nn

from .. import autograd
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import resolve_device
from ..nn import Dropout, set_dropout_generator
from ..ops.cuda import graphs
from ..ops.optimizer_ops import sum_sq_total
from ..optimizer.optimizer import _uses_master
from ..util import getenv

__all__ = ["ShardedTrainer"]


class _FusedStep:
    """The fused step of one batch signature: its static buffers, the
    function over them, and its graph once captured."""

    def __init__(self, trainer: "ShardedTrainer", vals):
        dev = trainer.device
        self.inputs = [torch.empty_like(v) for v in vals]
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.t = torch.zeros((), dtype=torch.int32, device=dev)
        self.graph: Optional[graphs.Graph] = None
        self.out = None              # (loss, gnorm, finite, grads)

    def load(self, vals, lr: float, t: int) -> None:
        """Write the batch, ``lr`` and ``t`` into the static buffers (device
        copies and fills, no host sync)."""
        for dst, src in zip(self.inputs, vals):
            dst.copy_(src, non_blocking=True)
        self.lr.fill_(lr)
        self.t.fill_(t)

    def run(self, tr: "ShardedTrainer"):
        """The step of ``tr`` over the static buffers: ``(loss, gnorm,
        finite, grads)``, parameters and optimizer states updated in place.
        Reads no host value (JAX counterpart: ``_build_step``'s ``step``,
        ``parallel/trainer.py:441-508``)."""
        n_data = len(self.inputs) - tr._n_labels
        lr = self.lr
        sched = tr._optimizer.lr_scheduler
        if tr._lr_fold:
            # the schedule at this step's position t-1, scaled by the lr
            # input over the base rate baked in (``:441-448``)
            base = float(sched.base_lr or 0.0)
            scale = lr / base if base else 1.0
            lr = sched.torch_lr(self.t - 1) * scale
        with autograd.train_mode():
            out = tr._block(*self.inputs[:n_data])
            loss = torch.mean(tr._loss_fn(out, *self.inputs[n_data:]))
        grads = torch.autograd.grad(loss, tr._params, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, tr._params)]
        with torch.no_grad():
            gnorm = torch.sqrt(sum_sq_total(grads))
            finite = torch.isfinite(loss) & torch.isfinite(gnorm)
            tr._optimizer.update_multi(tr._indices, tr._params, grads,
                                       tr._states, lr=lr, t=self.t)
        return loss.detach(), gnorm, finite, grads


class ShardedTrainer:
    """Drives a module's training on one device (JAX counterpart:
    ``parallel/trainer.py:73``).

    ``optimizer`` is a registered name (``"adamw"``) or an
    :class:`~..optimizer.Optimizer`. ``device`` defaults to the card and
    raises without one; the module is moved there. The forward runs under
    ``autograd.train_mode()`` (Dropout active); every ``Dropout`` of the
    module draws from one generator on that device, seeded with ``seed``.
    ``fused`` picks the path (module docstring): ``None`` is the fused step
    on the card unless ``MXTPU_FUSED_STEP=0``, the eager one on the CPU.
    """

    def __init__(self, block: nn.Module, loss_fn: Callable, optimizer,
                 optimizer_params: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 n_labels: int = 1, seed: int = 0,
                 fused: Optional[bool] = None):
        self._device = resolve_device(device)
        if fused is None:
            fused = (getenv("MXTPU_FUSED_STEP") == "1"
                     and self._device.type == "cuda")
        elif fused and self._device.type != "cuda":
            raise MXNetError("fused=True captures the step in a CUDA graph: "
                             f"it needs a card, not {self._device}; pass "
                             "fused=None or False on the CPU")
        self._fused = bool(fused)
        self._block = block.to(self._device)
        self._loss_fn = loss_fn
        self._optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self._n_labels = n_labels
        self.generator = torch.Generator(device=self._device).manual_seed(seed)
        set_dropout_generator(block, self.generator)
        self._params: Optional[List[nn.Parameter]] = None
        self._indices: Optional[List[int]] = None
        self._states: Optional[list] = None
        self._mp: Optional[List[bool]] = None
        self._t = 0
        self._last = None            # (grad norm, finite) on the device
        #: the schedule is evaluated inside the fused step (``:435``)
        self._lr_fold = False
        self._steps: Dict[tuple, _FusedStep] = {}
        self._storage: tuple = ()    # the parameters' data_ptr at capture
        #: CUDA graphs captured so far (one per batch signature)
        self.captures = 0
        #: graphs the last ``step()`` replayed: 1 on a fused replay, else 0
        self.last_step_graphs = 0
        #: ``"fused"`` or ``"eager"``: the path the last ``step()`` took
        self.last_path: Optional[str] = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def fused(self) -> bool:
        return self._fused

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
        """Parameters in sorted-name order (the JAX trainer's order), their
        names for the optimizer's ``idx2name`` (a Gluon block's prefix
        names, else torch's), their optimizer states, and which of them
        update through an fp32 master (``_mp``)."""
        opt = self._optimizer
        named = sorted(self._block.named_parameters())
        self._params = [p for _, p in named]
        self._indices = list(range(len(self._params)))
        prefix = {}
        if hasattr(self._block, "collect_params"):
            prefix = {id(p._var): name for name, p in
                      self._block.collect_params().items()}
        opt.idx2name = {i: prefix.get(id(p), name)
                        for i, (name, p) in enumerate(named)}
        self._states = [opt.create_state_multi_precision(i, p.detach())
                        for i, p in enumerate(self._params)]
        #: which parameters update through an fp32 master
        self._mp = [_uses_master(opt.multi_precision, p, s)
                    for p, s in zip(self._params, self._states)]
        sched = opt.lr_scheduler
        self._lr_fold = bool(sched is not None and hasattr(sched, "torch_lr"))

    def place(self, *batch) -> tuple:
        """Batch arrays (numpy or tensors) as tensors on the device; tensors
        already there pass through."""
        out = []
        for a in batch:
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                onp.ascontiguousarray(a))
            out.append(t.to(self._device, non_blocking=True))
        return tuple(out)

    def _lr_input(self) -> float:
        """The ``lr`` the step reads: the optimizer's rate before the step
        (JAX ``_refresh_scalars``, ``:611``); with the schedule folded into
        the fused step, its base rate."""
        opt = self._optimizer
        if self._lr_fold:
            return float(opt.lr_scheduler.base_lr or 0.0)
        return float(opt.learning_rate)

    def step(self, *batch) -> torch.Tensor:
        """One training step on ``batch`` = data arguments then
        ``n_labels`` labels; returns the mean loss (a device scalar)."""
        n_data = len(batch) - self._n_labels
        if n_data < 1:
            raise MXNetError("step() needs at least one data argument")
        if self._params is None:
            self._init_state()
        vals = self.place(*batch)
        if self._fused:
            return self._fused_step(vals, capture=True)
        return self._eager_step(vals)

    def _eager_step(self, vals) -> torch.Tensor:
        """The step in PyTorch's own way, each parameter updated by
        ``Optimizer.step`` (JAX counterpart: the same ``step`` math,
        ``:463-481``), on the host's learning rate and, as in the JAX
        step, a device step count ``t`` (``:631-632``)."""
        n_data = len(vals) - self._n_labels
        opt, params = self._optimizer, self._params
        lr = float(opt.learning_rate)
        self._t += 1
        t = torch.full((), self._t, dtype=torch.int32, device=self._device)
        for p in params:
            p.grad = None
        with autograd.train_mode():
            out = self._block(*vals[:n_data])
            loss = torch.mean(self._loss_fn(out, *vals[n_data:]))
        loss.backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            gnorm = torch.sqrt(sum_sq_total(grads))
            finite = torch.isfinite(loss) & torch.isfinite(gnorm)
            for i, (p, g) in enumerate(zip(params, grads)):
                s = self._states[i]
                lr_i = lr * opt._mult(i, "lr_mult", opt.lr_mult)
                wd_i = opt._get_wd(i)
                if self._mp[i]:
                    master, rest = opt.step(s[0], g.float(), s[1:], lr_i,
                                            wd_i, t)
                    p.copy_(master)
                    self._states[i] = (master,) + tuple(rest)
                else:
                    new_w, rest = opt.step(p, g.to(p.dtype), s, lr_i, wd_i,
                                           t)
                    p.copy_(new_w)
                    self._states[i] = tuple(rest)
        opt.num_update = self._t
        self._last = (gnorm, finite)
        self.last_path, self.last_step_graphs = "eager", 0
        return loss.detach()

    def _fused_step(self, vals, capture: bool) -> torch.Tensor:
        """The fused step (module docstring); ``capture=False`` runs its
        function eagerly every time, on the current stream (the CPU
        tests)."""
        storage = tuple(p.data_ptr() for p in self._params)
        if storage != self._storage:
            # parameters re-initialised or moved since the graphs were
            # captured: they read the old storage, so they all go
            self._steps, self._storage = {}, storage
        sig = tuple((tuple(v.shape), v.dtype) for v in vals)
        entry = self._steps.get(sig)
        if entry is None:
            entry = self._steps[sig] = _FusedStep(self, vals)
        lr = self._lr_input()
        self._t += 1
        entry.load(vals, lr, self._t)
        self.last_step_graphs = 0
        if not capture:
            entry.out = entry.run(self)
        elif entry.out is None:
            # first step of this signature: a real step, run eagerly on
            # the capture stream (initialises what the capture needs)
            entry.out = graphs.run_on_capture_stream(
                self._device, lambda: entry.run(self))
        else:
            if entry.graph is None:
                entry.graph = graphs.Graph(self._device, self._generators())
                entry.out = entry.graph.capture(lambda: entry.run(self))
                self.captures += 1
            entry.graph.replay()
            self.last_step_graphs = 1
        loss, gnorm, finite, grads = entry.out
        with torch.no_grad():
            for p, g in zip(self._params, grads):
                p.grad = g
        self._optimizer.num_update = self._t
        self._last = (gnorm, finite)
        self.last_path = "fused"
        # the graph rewrites its loss buffer on the next replay
        return loss.clone()

    def _generators(self) -> List[torch.Generator]:
        """The generators the step draws from: the trainer's, and any other
        a Dropout of the module was given."""
        gens = [self.generator]
        for m in self._block.modules():
            if isinstance(m, Dropout) and m.generator is not None:
                gens.append(m.generator)
        return gens

    def sync_to_block(self) -> None:
        """Nothing to write back: the parameters are the module's own."""
