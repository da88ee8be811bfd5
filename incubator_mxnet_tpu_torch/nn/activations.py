"""Activation layers (JAX counterpart: ``gluon/nn/activations.py``):
``Activation`` by name, and ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``,
``Swish``, ``GELU`` (tanh approximation) and ``SiLU``."""
from __future__ import annotations

from ..gluon.block import HybridBlock
from ..ops import nn as _ops

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU", "SiLU"]


class Activation(HybridBlock):
    """A named activation, no parameters (JAX counterpart:
    ``gluon/nn/activations.py:9``)."""

    def __init__(self, activation: str, **kwargs):
        if activation not in _ops.ACTIVATIONS:
            raise ValueError(f"activation {activation!r} is not ported yet; "
                             f"known: {sorted(_ops.ACTIVATIONS)}")
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    """``x`` if ``x >= 0`` else ``alpha * x`` (JAX counterpart:
    ``gluon/nn/activations.py:26``)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learnt slope per channel, ``alpha`` of shape
    ``(in_channels,)`` starting at 0.25 (JAX counterpart:
    ``gluon/nn/activations.py:37``)."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        from .. import initializer
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """Exponential linear unit (JAX counterpart:
    ``gluon/nn/activations.py:52``)."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled exponential linear unit (JAX counterpart:
    ``gluon/nn/activations.py:63``)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (JAX counterpart:
    ``gluon/nn/activations.py:70``)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.Activation(x * self._beta, act_type="sigmoid")


class GELU(HybridBlock):
    """GELU, tanh approximation (JAX counterpart:
    ``gluon/nn/activations.py:81``)."""

    def hybrid_forward(self, F, x):
        return F.gelu_tanh(x)


class SiLU(HybridBlock):
    """``x * sigmoid(x)`` (JAX counterpart:
    ``gluon/nn/activations.py:88``)."""

    def hybrid_forward(self, F, x):
        return F.silu(x)
