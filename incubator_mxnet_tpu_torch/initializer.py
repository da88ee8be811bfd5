"""Weight initializers, each drawing from an explicit ``torch.Generator``.

Counterpart: the JAX package's ``initializer.py`` (``:29-188``): the
registry and ``create``, the name dispatch of
``Initializer.__call__`` (``*weight`` -> ``_init_weight``, ``*bias`` ->
``_init_bias``, ``*gamma`` ones, ``*beta`` zeros, BatchNorm's
``*running_mean`` zeros and ``*running_var`` ones), and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal`` and ``Xavier``. The random ones draw
in float32 on the CPU from ``generator`` (default: the CPU stream of
:mod:`..random`) and then copy into the parameter, so one seed gives the
same weights whatever the parameter's dtype or device. Draws differ from
the JAX package's (another generator); parity tests copy weights across
(``convert.params_from_jax`` or a ``.params`` file).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from . import random as _random
from .base import MXNetError
from .context import cpu

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "register", "create", "initialize"]

_registry: Dict[str, type] = {}


def register(klass: type) -> type:
    """Register an initializer class under its lower-cased name."""
    _registry[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs) -> "Initializer":
    """An initializer by registered name (``"xavier"``, ``"zeros"`` ...),
    or ``init`` itself when it is one; ``None`` is ``Uniform(0.07)`` (JAX
    counterpart: ``initializer.py:29``)."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform(0.07)
    klass = _registry.get(_ALIASES.get(str(init).lower(), str(init).lower()))
    if klass is None:
        raise MXNetError(f"initializer registry has no entry '{init}'. "
                         f"Known: {sorted(_registry)}")
    return klass(**kwargs)


class Initializer:
    """Fills an array by its parameter's name (JAX counterpart:
    ``initializer.py:47``). ``arr`` is an NDArray or a tensor; the
    ``_init_*`` methods receive the tensor and write it in place."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr) -> None:
        name = str(name)
        t = getattr(arr, "_data", arr)
        with torch.no_grad():
            if name.endswith("weight"):
                self._init_weight(name, t)
            elif name.endswith("bias"):
                self._init_bias(name, t)
            elif name.endswith("gamma"):
                self._init_one(name, t)
            elif name.endswith("beta"):
                self._init_zero(name, t)
            elif name.endswith(("running_mean", "moving_mean")):
                self._init_zero(name, t)
            elif name.endswith(("running_var", "moving_var")):
                self._init_one(name, t)
            else:
                self._init_default(name, t)

    def _init_zero(self, name, arr):
        arr.zero_()

    def _init_one(self, name, arr):
        arr.fill_(1.0)

    def _init_bias(self, name, arr):
        self._init_zero(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


class _Random(Initializer):
    """An initializer that draws: ``generator`` or the CPU stream."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    def _draw(self, arr, fill) -> None:
        draw = torch.empty(arr.shape, dtype=torch.float32)
        fill(draw, self.generator or _random.generator(cpu()))
        arr.copy_(draw)


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(name, arr)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        arr.copy_(torch.as_tensor(self.value, dtype=arr.dtype)
                  .expand(arr.shape))


@register
class Uniform(_Random):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        self._draw(arr, lambda d, g: d.uniform_(-self.scale, self.scale,
                                                generator=g))


@register
class Normal(_Random):
    """N(0, sigma²)."""

    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        self._draw(arr, lambda d, g: d.normal_(0.0, self.sigma, generator=g))


@register
class Xavier(_Random):
    """Uniform in ``±sqrt(magnitude / factor)`` (or normal with that
    deviation), ``factor`` the mean of fan-in and fan-out ("avg"), or one of
    them (JAX counterpart: ``initializer.py:158``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
        fan_out = shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in}.get(
            self.factor_type, fan_out)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._draw(arr, lambda d, g: d.uniform_(-scale, scale,
                                                    generator=g))
        else:
            self._draw(arr, lambda d, g: d.normal_(0.0, scale, generator=g))


_ALIASES = {"zeros": "zero", "ones": "one", "glorot": "xavier"}


def initialize(module: nn.Module,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialise every parameter of ``module`` by its name, in
    ``named_parameters()`` order, with :class:`Xavier` defaults: ``*bias``
    and ``*beta`` zeros, ``*gamma`` ones, anything else Xavier-uniform
    (JAX counterpart: ``Initializer.__call__``, ``initializer.py:51``,
    under ``Block.initialize``). ``generator`` is a CPU generator; ``None``
    means one seeded with 0."""
    init = Xavier(generator=generator if generator is not None
                  else torch.Generator().manual_seed(0))
    for name, p in module.named_parameters():
        init(name, p)
    return module
