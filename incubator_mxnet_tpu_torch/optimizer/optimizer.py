"""Optimizers over tensors.

Counterpart: the JAX package's ``optimizer/optimizer.py``: the registry
(``create`` ``:34``), the ``Optimizer`` base (``:40-146``: learning rate,
its ``lr_scheduler`` and per-parameter multipliers (``param_dict``,
``set_lr_mult``/``set_wd_mult``, ``idx2name``), weight decay,
``rescale_grad`` (which ``gluon.Trainer.step`` sets to ``scale /
batch_size``), ``clip_gradient``, ``multi_precision``, the update counts
from ``begin_num_update``, ``create_state_multi_precision``, the pure
``step`` and the in-place ``update``), ``SGD`` with momentum (``:150``),
``Adam`` (``:184``), ``AdamW`` (``:203-212``) and ``Updater`` /
``get_updater`` (``:517-546``). ``step(w, g, state, lr, wd, t)`` is pure:
it returns the new weight and state and changes nothing; ``update`` writes
the new weight into the parameter.

``update_multi(indices, weights, grads, states)`` is the multi-tensor
update of ``SGD``, ``Adam`` and ``AdamW``: the same arithmetic as
``update`` on each parameter, op for op, over all of them at once on
``torch._foreach_*``, writing weights, fp32 masters and moments in place
(so the tensors stay where a CUDA graph captured them). On the CPU it
gives ``update``'s numbers bit for bit. Its ``lr`` and ``t`` may be device
tensors: then the bias corrections ``1 - beta ** t`` are computed on the
device in float32, as the JAX package's compiled step computes them from
its float32 ``t`` (``parallel/trainer.py:441-481``), and the update reads
no host value, so the fused ``parallel.ShardedTrainer`` step captures it.
``step`` takes a tensor ``t`` as well, and then computes the same device
scalars: on the card the two paths give the same bits. For an integer
``t`` the scalars are the JAX package's ``Optimizer.update``'s, in Python
floats.

One difference in form, none in numbers: with ``multi_precision`` the JAX
package creates the Adam moments in the weight's dtype (bfloat16) and its
first step promotes them to float32 (``0.9 * m_bf16 + 0.1 * g_f32``,
``parallel/trainer.py:473``); here they are float32 from the start, like
the master weight. The moments start at zero, so both give the same values.
The other optimizers of the JAX package come with a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Updater", "register",
           "create", "get_updater", "update_groups"]

_HALF = (torch.float16, torch.bfloat16)

_registry: Dict[str, type] = {}


def register(klass: type) -> type:
    """Register an optimizer class under its lower-cased name."""
    _registry[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    """An optimizer by registered name (case-insensitive), or ``name``
    itself when it is one already (JAX counterpart: ``optimizer.py:34``)."""
    if isinstance(name, Optimizer):
        return name
    klass = _registry.get(str(name).lower())
    if klass is None:
        raise MXNetError(f"optimizer registry has no entry '{name}'. "
                         f"Known: {sorted(_registry)}")
    return klass(**kwargs)


def _uses_master(multi_precision: bool, weight: torch.Tensor, state) -> bool:
    """Does ``weight`` update through the fp32 master ``state[0]``?"""
    return bool(multi_precision and weight.dtype in _HALF and state
                and state[0].dtype == torch.float32
                and state[0].shape == weight.shape)


def update_groups(optimizer: "Optimizer", weights: Sequence[torch.Tensor],
                  states: Sequence[tuple]) -> List[List[int]]:
    """Positions of ``weights`` grouped by (device, dtype, fp32 master or
    not), in order of first appearance: the groups whose update one
    ``update_multi`` call runs on the fast multi-tensor path."""
    groups: Dict[tuple, List[int]] = {}
    for pos, (w, s) in enumerate(zip(weights, states)):
        key = (w.device, w.dtype,
               _uses_master(optimizer.multi_precision, w, s))
        groups.setdefault(key, []).append(pos)
    return list(groups.values())


class Optimizer:
    """Base optimizer; state is a tuple of tensors per parameter (JAX
    counterpart: ``optimizer.py:40``)."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, lr_scheduler=None, multi_precision=False,
                 param_dict=None, begin_num_update=0, **kwargs):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision
        #: index -> Parameter (its lr_mult / wd_mult), set by the Trainer
        self.param_dict = param_dict or {}
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.idx2name: Dict[int, str] = {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr) -> None:
        if self.lr_scheduler is not None:
            raise MXNetError("learning rate is managed by the LRScheduler")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]) -> None:
        """Learning-rate multipliers by parameter index or name."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]) -> None:
        """Weight-decay multipliers by parameter index or name."""
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index) -> None:
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr: str, table: Dict[Any, float]) -> float:
        """A parameter's ``lr_mult``/``wd_mult``: from its Parameter, else
        by index, else by name (JAX counterpart: ``optimizer.py:88-105``)."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def create_state(self, index, weight: torch.Tensor) -> Tuple:
        return ()

    def create_state_multi_precision(self, index, weight: torch.Tensor
                                     ) -> Tuple:
        """``(fp32 master,) + state`` for a float16/bfloat16 weight under
        ``multi_precision``, the state built on the master (so float32),
        else the weight's own state."""
        if self.multi_precision and weight.dtype in (torch.float16,
                                                     torch.bfloat16):
            master = weight.detach().float()
            return (master,) + self.create_state(index, master)
        return self.create_state(index, weight)

    def _prep_grad(self, g):
        g = g * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def step(self, w, g, state, lr, wd, t):
        """Pure update rule ``-> (new_weight, new_state)``; subclasses
        implement it."""
        raise NotImplementedError

    def update(self, index, weight, grad, state) -> Tuple:
        """One update of ``weight`` (an NDArray or tensor, written in
        place) from ``grad``; returns the new state (JAX counterpart:
        ``optimizer.py:126``). A float16/bfloat16 weight whose state starts
        with a float32 master is updated through the master."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w, g = getattr(weight, "_data", weight), getattr(grad, "_data", grad)
        with torch.no_grad():
            if _uses_master(self.multi_precision, w, state):
                master, rest = self.step(state[0], g.float(), state[1:], lr,
                                         wd, t)
                w.copy_(master)
                return (master,) + tuple(rest)
            new_w, new_state = self.step(w, g.to(w.dtype), state, lr, wd, t)
            w.copy_(new_w)
            return tuple(new_state)

    update_multi_precision = update

    # -- multi-tensor update ---------------------------------------------
    def _hparams(self, indices) -> Tuple[list, list, list]:
        """``(lrs, wds, ts)`` of one update of each index, counted in
        order, as a loop of :meth:`update` would count them."""
        lrs, wds, ts = [], [], []
        for i in indices:
            self._update_count(i)
            lrs.append(self._get_lr(i))
            wds.append(self._get_wd(i))
            ts.append(self._index_update_count[i])
        return lrs, wds, ts

    def update_multi(self, indices, weights, grads, states, lr=None,
                     wd=None, t=None) -> None:
        """One update of every ``weights[k]`` (tensors, NDArrays or
        Parameters' tensors) from ``grads[k]``, writing weights and
        ``states[k]`` in place.

        Without ``lr``/``wd``/``t`` the update counts and hyperparameters
        are those of a loop of :meth:`update` over ``indices`` in order.
        Given, ``lr`` and ``t`` are each a list (one per index) or a
        device scalar tensor; a tensor ``lr`` is the base rate, multiplied
        by each parameter's ``lr_mult``. The base class runs
        :meth:`update` per parameter on host scalars and copies the new
        state into the old; ``SGD``, ``Adam`` and ``AdamW`` run on
        ``torch._foreach_*``."""
        if lr is None:
            lr, wd_c, t = self._hparams(indices)
            wd = wd_c if wd is None else wd
        elif wd is None:
            wd = [self._get_wd(i) for i in indices]
        if isinstance(lr, torch.Tensor) or isinstance(t, torch.Tensor):
            if type(self)._multi is Optimizer._multi:
                raise MXNetError(f"{type(self).__name__}.update_multi takes "
                                 "no device lr or t")
            if not isinstance(t, torch.Tensor):
                raise MXNetError("update_multi: a device lr needs a device "
                                 "t")
        ws = [getattr(w, "_data", w) for w in weights]
        gs = [getattr(g, "_data", g) for g in grads]
        with torch.no_grad():
            for group in update_groups(self, ws, states):
                self._run_group([indices[k] for k in group],
                                [ws[k] for k in group],
                                [gs[k] for k in group],
                                [states[k] for k in group],
                                _pick(lr, group), [wd[k] for k in group],
                                _pick(t, group))

    def _run_group(self, indices, ws, gs, states, lr, wds, t) -> None:
        """One group of :func:`update_groups`: the math on the fp32
        masters when the group has them, then the weights rounded from
        them."""
        master = _uses_master(self.multi_precision, ws[0], states[0])
        if master:
            mws = [s[0] for s in states]
            mgs = [g.float() for g in gs]
            rest = [tuple(s[1:]) for s in states]
        else:
            mws = ws
            mgs = [g if g.dtype == w.dtype else g.to(w.dtype)
                   for g, w in zip(gs, ws)]
            rest = [tuple(s) for s in states]
        if isinstance(lr, torch.Tensor):
            lr = (lr, [self._mult(i, "lr_mult", self.lr_mult)
                       for i in indices])
        self._multi(indices, mws, mgs, rest, lr, wds, t)
        if master:
            torch._foreach_copy_(ws, mws)

    def _multi(self, indices, ws, gs, states, lr, wds, t) -> None:
        """The update of one group on host scalars: :meth:`step` per
        parameter, its new weight and state copied into the old ones."""
        for w, g, s, lr_k, wd_k, t_k in zip(ws, gs, states, lr, wds, t):
            new_w, new_s = self.step(w, g, s, lr_k, wd_k, t_k)
            w.copy_(new_w)
            for a, b in zip(s, new_s):
                a.copy_(b)

    def _prep_grads(self, gs) -> List[torch.Tensor]:
        """:meth:`_prep_grad` of every gradient, as new tensors."""
        gs = torch._foreach_mul(gs, self.rescale_grad)
        if self.clip_gradient is not None:
            gs = torch._foreach_clamp_min(gs, -self.clip_gradient)
            gs = torch._foreach_clamp_max(gs, self.clip_gradient)
        return gs

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _pick(v, positions):
    """``v[k]`` for each position of a per-index list; a tensor as is."""
    if isinstance(v, torch.Tensor):
        return v
    return [v[k] for k in positions]


def _lrs(lr, fn=None):
    """``fn(lr_k)`` for each parameter, as a ``torch._foreach_mul`` factor:
    ``lr`` is a list of host scalars, or ``(device lr, lr_mults)``, whose
    rates are one device scalar when every multiplier is 1."""
    fn = fn or (lambda x: x)
    if isinstance(lr, tuple):
        base, mults = lr
        if all(m == 1.0 for m in mults):
            return fn(base)
        return [fn(base * m) for m in mults]
    return [fn(x) for x in lr]


def _mul_(ts, factor) -> None:
    """``ts[k] *= factor_k`` in place. ``torch._foreach_mul_`` rounds a
    scalar to a float16/bfloat16 tensor's own type first on the CPU, where
    the out-of-place op (and ``tensor * scalar``) computes in float32; so
    for those types it multiplies out of place and copies back."""
    if ts and ts[0].dtype in _HALF:
        torch._foreach_copy_(ts, torch._foreach_mul(ts, factor))
    else:
        torch._foreach_mul_(ts, factor)


def _bias_correction(beta: float, t):
    """``1 - beta ** t`` as the JAX package computes it: for an integer
    ``t`` (``Optimizer.update``'s count) in Python floats, for a tensor
    ``t`` (the step count of ``ShardedTrainer``'s compiled step) on the
    device in float32 (JAX counterpart: ``optimizer.py:189, :209``)."""
    if isinstance(t, torch.Tensor):
        return 1.0 - torch.pow(beta, t.to(torch.float32))
    return 1.0 - beta ** t


def _adam_lr(lr, beta1: float, beta2: float, t):
    """Adam's ``lr * sqrt(1 - beta2**t) / (1 - beta1**t)``: in float32 from
    the Python-float corrections for an integer ``t``, as ``jnp.sqrt`` of a
    Python float rounds to float32 in the JAX step (``optimizer.py:189``);
    on the device for a tensor ``t``."""
    bc1, bc2 = _bias_correction(beta1, t), _bias_correction(beta2, t)
    if isinstance(t, torch.Tensor):
        return lr * bc2 ** 0.5 / bc1
    return float(onp.float32(lr) * onp.sqrt(onp.float32(bc2))
                 / onp.float32(bc1))


@register
class SGD(Optimizer):
    """SGD with optional momentum and L2 weight decay folded into the
    gradient (JAX counterpart: ``optimizer.py:150``)."""

    def __init__(self, momentum=0.0, lazy_update=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(weight),)

    def step(self, w, g, state, lr, wd, t):
        g = self._prep_grad(g) + wd * w
        if self.momentum == 0.0:
            return w - lr * g, ()
        mom = state[0] * self.momentum - lr * g
        return w + mom, (mom,)

    def _multi(self, indices, ws, gs, states, lr, wds, t):
        g = self._prep_grads(gs)
        torch._foreach_add_(g, torch._foreach_mul(ws, wds))
        g = torch._foreach_mul(g, _lrs(lr))             # lr * g
        if self.momentum == 0.0:
            torch._foreach_sub_(ws, g)
            return
        moms = [s[0] for s in states]
        _mul_(moms, self.momentum)
        torch._foreach_sub_(moms, g)
        torch._foreach_add_(ws, moms)


@register
class Adam(Optimizer):
    """Adam with L2 weight decay folded into the gradient (JAX counterpart:
    ``optimizer.py:184``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _moments(self, g, state):
        m = self.beta1 * state[0] + (1 - self.beta1) * g
        v = self.beta2 * state[1] + (1 - self.beta2) * (g * g)
        return m, v

    def step(self, w, g, state, lr, wd, t):
        g = self._prep_grad(g) + wd * w
        m, v = self._moments(g, state)
        lr_t = _adam_lr(lr, self.beta1, self.beta2, t)
        return w - lr_t * m / (v.sqrt() + self.epsilon), (m, v)

    def _multi_moments(self, g, states):
        """``m`` and ``v`` of every parameter, updated in place as
        :meth:`_moments` computes them."""
        ms, vs = [s[0] for s in states], [s[1] for s in states]
        _mul_(ms, self.beta1)
        torch._foreach_add_(ms, torch._foreach_mul(g, 1 - self.beta1))
        g2 = torch._foreach_mul(g, g)
        g2 = torch._foreach_mul(g2, 1 - self.beta2)
        _mul_(vs, self.beta2)
        torch._foreach_add_(vs, g2)
        return ms, vs

    def _multi(self, indices, ws, gs, states, lr, wds, t):
        g = self._prep_grads(gs)
        torch._foreach_add_(g, torch._foreach_mul(ws, wds))
        ms, vs = self._multi_moments(g, states)
        if isinstance(t, torch.Tensor):
            lr_t = _lrs(lr, lambda x: _adam_lr(x, self.beta1, self.beta2, t))
        else:
            lr_t = [_adam_lr(lr_k, self.beta1, self.beta2, t_k)
                    for lr_k, t_k in zip(lr, t)]
        step = torch._foreach_mul(ms, lr_t)
        den = torch._foreach_add(torch._foreach_sqrt(vs), self.epsilon)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(ws, step)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (JAX counterpart:
    ``optimizer.py:203``)."""

    def step(self, w, g, state, lr, wd, t):
        g = self._prep_grad(g)
        m, v = self._moments(g, state)
        mhat = m / _bias_correction(self.beta1, t)
        vhat = v / _bias_correction(self.beta2, t)
        return w - lr * (mhat / (vhat.sqrt() + self.epsilon) + wd * w), (m, v)

    def _multi(self, indices, ws, gs, states, lr, wds, t):
        g = self._prep_grads(gs)
        ms, vs = self._multi_moments(g, states)
        if isinstance(t, torch.Tensor):
            mhat = torch._foreach_div(ms, _bias_correction(self.beta1, t))
            vhat = torch._foreach_div(vs, _bias_correction(self.beta2, t))
        else:
            mhat = torch._foreach_div(
                ms, [_bias_correction(self.beta1, t_k) for t_k in t])
            vhat = torch._foreach_div(
                vs, [_bias_correction(self.beta2, t_k) for t_k in t])
        den = torch._foreach_add(torch._foreach_sqrt(vhat), self.epsilon)
        torch._foreach_div_(mhat, den)
        torch._foreach_add_(mhat, torch._foreach_mul(ws, wds))
        mhat = torch._foreach_mul(mhat, _lrs(lr))
        torch._foreach_sub_(ws, mhat)


class Updater:
    """A stateful ``(index, grad, weight)`` applier (JAX counterpart:
    ``optimizer.py:517``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, Tuple] = {}

    def __call__(self, index, grad, weight) -> None:
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, getattr(weight, "_data", weight).detach())
        self.states[index] = self.optimizer.update(index, weight, grad,
                                                   self.states[index])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
