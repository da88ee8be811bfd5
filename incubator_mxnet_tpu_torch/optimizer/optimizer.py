"""Optimizers over tensors.

Counterpart: the JAX package's ``optimizer/optimizer.py``: the registry
(``create`` ``:34``), the ``Optimizer`` base (``:40-146``: learning rate and
its per-parameter multipliers, weight decay, ``rescale_grad`` (which
``gluon.Trainer.step`` sets to ``scale / batch_size``), ``clip_gradient``,
``multi_precision``, the update counts, ``create_state_multi_precision``,
the pure ``step`` and the in-place ``update``), ``SGD`` with momentum
(``:150``), ``Adam`` (``:184``), ``AdamW`` (``:203-212``) and ``Updater`` /
``get_updater`` (``:517-546``). ``step(w, g, state, lr, wd, t)`` is pure:
it returns the new weight and state and changes nothing; ``update`` writes
the new weight into the parameter.

One difference in form, none in numbers: with ``multi_precision`` the JAX
package creates the Adam moments in the weight's dtype (bfloat16) and its
first step promotes them to float32 (``0.9 * m_bf16 + 0.1 * g_f32``,
``parallel/trainer.py:473``); here they are float32 from the start, like
the master weight. The moments start at zero, so both give the same values.
Learning-rate schedulers and the other optimizers come with a later slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Updater", "register",
           "create", "get_updater"]

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


class Optimizer:
    """Base optimizer; state is a tuple of tensors per parameter."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, multi_precision=False, param_dict=None):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        #: index -> Parameter (its lr_mult / wd_mult), set by the Trainer
        self.param_dict = param_dict or {}
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr) -> None:
        self.lr = lr

    def _update_count(self, index) -> None:
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index) -> float:
        if index in self.param_dict:
            return self.lr * self.param_dict[index].lr_mult
        return self.lr

    def _get_wd(self, index) -> float:
        if index in self.param_dict:
            return self.wd * self.param_dict[index].wd_mult
        return self.wd

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
            if (self.multi_precision and w.dtype in _HALF and state
                    and state[0].dtype == torch.float32
                    and state[0].shape == w.shape):
                master, rest = self.step(state[0], g.float(), state[1:], lr,
                                         wd, t)
                w.copy_(master)
                return (master,) + tuple(rest)
            new_w, new_state = self.step(w, g.to(w.dtype), state, lr, wd, t)
            w.copy_(new_w)
            return tuple(new_state)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


@register
class SGD(Optimizer):
    """SGD with optional momentum and L2 weight decay folded into the
    gradient (JAX counterpart: ``optimizer.py:150``)."""

    def __init__(self, momentum=0.0, **kwargs):
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


def _bias_correction(beta: float, t: int) -> float:
    """``1 - beta ** t`` in float32, as the JAX step computes it from a
    float32 ``beta`` and the step counter promoted to float32."""
    return float(onp.float32(1.0) - onp.float32(beta) ** onp.float32(t))


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
        v = self.beta2 * state[1] + (1 - self.beta2) * g.square()
        return m, v

    def step(self, w, g, state, lr, wd, t):
        g = self._prep_grad(g) + wd * w
        m, v = self._moments(g, state)
        lr_t = (lr * _bias_correction(self.beta2, t) ** 0.5
                / _bias_correction(self.beta1, t))
        return w - lr_t * m / (v.sqrt() + self.epsilon), (m, v)


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
