"""Basic layers as Gluon ``HybridBlock``\\ s.

Counterparts: the JAX package's ``gluon/nn/basic_layers.py``
(``Sequential`` ``:24``, ``HybridSequential`` ``:55``, ``Dense`` ``:86``,
``Dropout`` ``:130``, ``BatchNorm`` ``:148``, ``SyncBatchNorm`` ``:215``,
``LayerNorm`` ``:228``, ``GroupNorm`` ``:258``, ``InstanceNorm``
``:284``, ``Embedding`` ``:310``, ``Flatten`` ``:337``,
``Identity`` ``:347``, ``Lambda`` ``:354``, ``HybridLambda`` ``:368``).
``gluon.nn`` re-exports this module. Parameter names match the JAX ones
(``weight``, ``bias``, ``gamma``, ``beta``, ``running_mean``,
``running_var``, under the same prefixes). ``in_units``/``in_channels``
may be 0: the parameter then waits, as an ``UninitializedParameter``, for
the first forward to give its shape. ``Dropout`` is active only under
``autograd.is_training()``; so is BatchNorm's use of batch statistics.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import autograd
from ..base import dtype_name
from ..gluon.block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "SyncBatchNorm", "LayerNorm", "GroupNorm",
           "InstanceNorm", "Embedding", "Flatten",
           "Identity", "Lambda", "HybridLambda", "set_dropout_generator"]


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


class BatchNorm(HybridBlock):
    """Batch normalisation over axis ``axis`` with running statistics
    (JAX counterpart: ``gluon/nn/basic_layers.py:148-212``).

    Under ``autograd.is_training()`` (and not ``use_global_stats``) it
    normalises by the batch's statistics and moves ``running_mean`` and
    ``running_var`` toward them, ``new = running * momentum + batch * (1 -
    momentum)`` with the biased batch variance, in place and without
    gradient: so the update also runs inside a captured CUDA graph (a
    hybridized block's cached op, ``ShardedTrainer``'s fused step), where a
    new tensor could not be assigned. Otherwise it normalises by the
    running statistics. ``running_mean``/``running_var`` are aux
    parameters: ``grad_req="null"``, saved in ``.params`` files. ``cast``
    to a half type keeps all four parameters float32; the output takes
    the input's dtype."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        if dtype_name(dtype) in ("float16", "bfloat16"):
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = autograd.is_training() and not self._use_global_stats
        out, mean, var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            mom = self._momentum
            with torch.no_grad():
                running_mean.mul_(mom).add_(mean.to(running_mean.dtype),
                                            alpha=1 - mom)
                running_var.mul_(mom).add_(var.to(running_var.dtype),
                                           alpha=1 - mom)
        return out


class SyncBatchNorm(BatchNorm):
    """BatchNorm over the whole batch across devices (JAX counterpart:
    ``gluon/nn/basic_layers.py:215``); on one card it is BatchNorm.
    ``num_devices`` is accepted as there."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class LayerNorm(HybridBlock):
    """Layer normalisation over ``axis`` (JAX counterpart:
    ``gluon/nn/basic_layers.py:228``, arguments in its order).
    ``gamma``/``beta`` are float32 whatever the model's dtype, and ``cast``
    keeps them so (ROADMAP queue C): a bfloat16 input's normalised value
    times ``gamma`` is float32."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
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
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def cast(self, dtype):
        super().cast("float32")

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Group normalisation over ``num_groups`` channel groups and the
    spatial axes (JAX counterpart: ``gluon/nn/basic_layers.py:258``)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._num_groups = num_groups
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
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class InstanceNorm(HybridBlock):
    """Instance normalisation over each sample's and channel's spatial
    axes (JAX counterpart: ``gluon/nn/basic_layers.py:284``; ``axis`` is
    taken and the channels stay on axis 1, as there)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
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
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class Embedding(HybridBlock):
    """Row lookup into ``weight (input_dim, output_dim)``, ids clipped into
    range (JAX counterpart: ``gluon/nn/basic_layers.py:310``).
    ``sparse_grad`` is taken; the gradient is dense, as there."""

    def __init__(self, input_dim: int, output_dim: int, dtype="float32",
                 weight_initializer=None, sparse_grad: bool = False,
                 **kwargs):
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


class Flatten(HybridBlock):
    """All axes but the batch axis collapsed (JAX counterpart:
    ``gluon/nn/basic_layers.py:337``)."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return "Flatten"


class Identity(HybridBlock):
    """The input, unchanged (JAX counterpart:
    ``gluon/nn/basic_layers.py:347``)."""

    def hybrid_forward(self, F, x):
        return x


class Lambda(Block):
    """A function as a Block; a string names an ``mx.nd`` op (JAX
    counterpart: ``gluon/nn/basic_layers.py:354``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from .. import ndarray as nd
            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """``function(F, x, *args)`` as a HybridBlock; a string names an op of
    ``F`` (JAX counterpart: ``gluon/nn/basic_layers.py:368``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name = function if isinstance(function, str) \
            else function.__name__
        self._func = function

    def hybrid_forward(self, F, x, *args):
        if isinstance(self._func, str):
            return getattr(F, self._func)(x, *args)
        return self._func(F, x, *args)
