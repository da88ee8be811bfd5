"""Optimizers over tensors.

Counterpart: the JAX package's ``optimizer/optimizer.py``: the registry
(``create`` ``:34``), the ``Optimizer`` base (``:40-146``: learning rate,
weight decay, ``rescale_grad``, ``clip_gradient``, ``multi_precision``,
``create_state_multi_precision`` and the pure ``step``), ``Adam``
(``:184``) and ``AdamW`` (``:203-212``). ``step(w, g, state, lr, wd, t)``
is pure: it returns the new weight and state and changes nothing.

One difference in form, none in numbers: with ``multi_precision`` the JAX
package creates the Adam moments in the weight's dtype (bfloat16) and its
first step promotes them to float32 (``0.9 * m_bf16 + 0.1 * g_f32``,
``parallel/trainer.py:473``); here they are float32 from the start, like
the master weight. The moments start at zero, so both give the same values.
Learning-rate schedulers come with a later slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "Adam", "AdamW", "register", "create"]

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
                 clip_gradient=None, multi_precision=False):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = 0

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

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


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
