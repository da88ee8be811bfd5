"""Basic layers as Gluon ``HybridBlock``\\ s.

Counterparts: the JAX package's ``gluon/nn/basic_layers.py``
(``Sequential`` ``:24``, ``HybridSequential`` ``:55``, ``Dense`` ``:86``,
``Dropout`` ``:130``, ``LayerNorm`` ``:228``, ``Embedding`` ``:310``) and
``gluon/nn/activations.py`` (``Activation``). ``gluon.nn`` re-exports this
module. Parameter names match the JAX ones (``weight``, ``bias``,
``gamma``, ``beta``, under the same prefixes). ``in_units``/
``in_channels`` may be 0: the parameter then waits, as an
``UninitializedParameter``, for the first forward to give its shape.
``Dropout`` is active only under ``autograd.is_training()``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..gluon.block import Block, HybridBlock
from ..ops import nn as _ops

__all__ = ["Sequential", "HybridSequential", "Activation", "Dense",
           "Dropout", "LayerNorm", "Embedding", "set_dropout_generator"]


class _Stack:
    """Children in order: ``add``, indexing, ``len`` and iteration."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_Stack, Block):
    """Blocks run one after another (JAX counterpart:
    ``gluon/nn/basic_layers.py:24``)."""

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """HybridBlocks run one after another (JAX counterpart:
    ``gluon/nn/basic_layers.py:55``)."""

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


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


class Dense(HybridBlock):
    """``act(x @ W.T + b)`` with ``weight (units, in_units)`` (JAX
    counterpart: ``gluon/nn/basic_layers.py:86``). ``flatten`` collapses
    all axes but the first before the product."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, flatten: bool = True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units: int = 0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), init=bias_initializer, dtype=dtype,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation else None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class Dropout(HybridBlock):
    """Inverted dropout, active only under ``autograd.is_training()`` (JAX
    counterpart: ``gluon/nn/basic_layers.py:130``). The mask comes from
    ``generator`` when one is set (``set_dropout_generator``), else from the
    device's stream of :mod:`..random`."""

    def __init__(self, rate: float, axes=(),
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(**kwargs)
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = float(rate)
        self._axes = tuple(axes)
        self.generator = generator

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self.rate, axes=self._axes,
                         generator=self.generator)


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


class LayerNorm(HybridBlock):
    """Layer normalisation over the last axis (JAX counterpart:
    ``gluon/nn/basic_layers.py:228``). ``gamma``/``beta`` are float32
    whatever the model's dtype, and ``cast`` keeps them so (ROADMAP queue
    C): a bfloat16 input's normalised value times ``gamma`` is float32."""

    def __init__(self, epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, beta_initializer="zeros",
                 gamma_initializer="ones", in_channels: int = 0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[-1]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def cast(self, dtype):
        super().cast("float32")

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, eps=self._epsilon)


class Embedding(HybridBlock):
    """Row lookup into ``weight (input_dim, output_dim)``, ids clipped into
    range (JAX counterpart: ``gluon/nn/basic_layers.py:310``)."""

    def __init__(self, input_dim: int, output_dim: int, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight)
