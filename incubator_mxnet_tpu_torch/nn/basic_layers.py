"""Basic layers as ``torch.nn.Module``s.

Counterparts: the JAX package's ``gluon/nn/basic_layers.py`` (``Dense``
``:86``, ``Dropout`` ``:130``, ``LayerNorm`` ``:228``, ``Embedding`` ``:310``)
and ``gluon/nn/activations.py`` (``Activation``). Parameter names match the
JAX suffixes (``weight``, ``bias``, ``gamma``, ``beta``) so that
``convert.params_from_jax`` can pair them. Shapes are given at construction:
the Gluon deferred shape inference waits for the Gluon port. Parameters are
created as zeros; ``initializer.initialize`` fills them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..base import torch_dtype
from ..ops import nn as F

__all__ = ["Activation", "Dense", "Dropout", "LayerNorm", "Embedding",
           "set_dropout_generator"]


class Activation(nn.Module):
    """A named activation, no parameters (JAX counterpart:
    ``gluon/nn/activations.py:9``)."""

    def __init__(self, act_type: str):
        super().__init__()
        if act_type not in F.ACTIVATIONS:
            raise ValueError(f"activation {act_type!r} is not ported yet; "
                             f"known: {sorted(F.ACTIVATIONS)}")
        self.act_type = act_type

    def forward(self, x):
        return F.activation(x, self.act_type)


class Dense(nn.Module):
    """``act(x @ W.T + b)`` with ``weight (units, in_units)`` (JAX
    counterpart: ``gluon/nn/basic_layers.py:86``). ``flatten`` collapses all
    axes but the first before the product."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 flatten: bool = True, dtype="float32", in_units: int = 0):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense needs in_units > 0 (deferred shape "
                             "inference waits for the Gluon port)")
        dt = torch_dtype(dtype)
        self._units = units
        self._flatten = flatten
        self.weight = nn.Parameter(torch.zeros(units, in_units, dtype=dt))
        self.bias = nn.Parameter(torch.zeros(units, dtype=dt))
        self.act = Activation(activation) if activation else None

    def forward(self, x):
        out = F.fully_connected(x, self.weight, self.bias,
                                flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class Dropout(nn.Module):
    """Inverted dropout drawn from an explicit ``torch.Generator`` (or the
    default one); the identity in ``eval()`` (JAX counterpart:
    ``gluon/nn/basic_layers.py:130``). The generator must live on the
    device of the inputs."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return x * (u < keep).to(x.dtype) / keep


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> int:
    """Make every :class:`Dropout` inside ``module`` draw from
    ``generator`` (one generator on the module's device, seeded by the
    caller, e.g. the trainer); returns how many layers now use it."""
    n = 0
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            n += 1
    return n


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis with float32
    ``gamma``/``beta`` whatever the model's dtype, as in JAX (JAX
    counterpart: ``gluon/nn/basic_layers.py:228``)."""

    def __init__(self, epsilon: float = 1e-5, in_channels: int = 0):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("LayerNorm needs in_channels > 0 (deferred "
                             "shape inference waits for the Gluon port)")
        self._epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(in_channels))
        self.beta = nn.Parameter(torch.zeros(in_channels))

    def forward(self, x):
        return F.layer_norm(x, self.gamma, self.beta, eps=self._epsilon)


class Embedding(nn.Module):
    """Row lookup into ``weight (input_dim, output_dim)`` (JAX counterpart:
    ``gluon/nn/basic_layers.py:310``)."""

    def __init__(self, input_dim: int, output_dim: int, dtype="float32"):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(input_dim, output_dim, dtype=torch_dtype(dtype)))

    def forward(self, x):
        return F.embedding(x, self.weight)
