"""Weight initializers, each drawing from an explicit ``torch.Generator``.

Counterpart: the JAX package's ``initializer.py`` (``:29-294``): the
registry and ``create``, ``InitDesc``, the name dispatch of
``Initializer.__call__`` (``*weight`` -> ``_init_weight``, ``*bias`` ->
``_init_bias``, ``*gamma`` ones, ``*beta`` zeros, BatchNorm's
``*running_mean`` zeros and ``*running_var`` ones), and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu`` (alias ``he``), ``Bilinear``, ``LSTMBias``, ``Mixed`` (the
first matching name pattern wins) and ``Load`` (by name from a dict or a
``.params`` file, else ``default_init``). ``Orthogonal`` takes the QR
factor of a normal draw in its taller orientation, so it fills any 2-D
shape (the JAX one fills square ones). The random ones draw
in float32 on the CPU from ``generator`` (default: the CPU stream of
:mod:`..random`) and then copy into the parameter, so one seed gives the
same weights whatever the parameter's dtype or device. Draws differ from
the JAX package's (another generator); parity tests copy weights across
(``convert.params_from_jax`` or a ``.params`` file).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional

import numpy as onp
import torch
from torch import nn

from . import random as _random
from .base import MXNetError
from .context import cpu

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "register", "create", "initialize"]

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


class InitDesc(str):
    """A parameter's name carrying its init attributes (JAX counterpart:
    ``initializer.py:37``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


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


@register
class Orthogonal(_Random):
    """``scale`` times an orthonormal matrix: the QR factor of a normal
    draw, signs fixed by R's diagonal (JAX counterpart:
    ``initializer.py:138``; ``rand_type`` is taken, the draw is normal, as
    there)."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator, scale=scale, rand_type=rand_type)
        self.scale = scale

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        a = torch.empty((nout, nin), dtype=torch.float32)
        a.normal_(generator=self.generator or _random.generator(cpu()))
        tall = nout >= nin
        q, r = torch.linalg.qr(a if tall else a.t())
        q = q * torch.sign(torch.diagonal(r))
        q = q if tall else q.t()
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class MSRAPrelu(Xavier):
    """He initialisation for PReLU units: Xavier normal with magnitude
    ``2 / (1 + slope²)`` (JAX counterpart: ``initializer.py:187``)."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         generator=generator)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a deconvolution (JAX counterpart:
    ``initializer.py:199``)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        f = onp.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = onp.arange(math.prod(shape))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = ((1 - onp.abs(x / f - c)) * (1 - onp.abs(y / f - c)))
        arr.copy_(torch.from_numpy(
            weight.astype(onp.float32).reshape(shape)))


@register
class LSTMBias(Initializer):
    """Zeros but the forget gate's quarter, ``forget_bias`` (JAX
    counterpart: ``initializer.py:213``)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        n = arr.shape[0] // 4
        arr.zero_()
        arr[n:2 * n] = self.forget_bias

    _init_bias = _init_weight
    _init_default = _init_weight


@register
class Mixed(Initializer):
    """The initializer of the first regular expression that matches the
    parameter's name (JAX counterpart: ``initializer.py:231``)."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise ValueError("Mixed needs len(patterns) == len(initializers)")
        self.map = [(re.compile(p), create(i)) for p, i in
                    zip(patterns, initializers)]

    def __call__(self, name, arr) -> None:
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr)
                return
        raise ValueError(
            f"Parameter {name!r} matches no pattern in Mixed; add a "
            "catch-all '.*' entry as the reference requires")


@register
class Load(Initializer):
    """Values by parameter name from a dict or a ``.params`` file (names
    may carry ``arg:``/``aux:``), else ``default_init`` (JAX counterpart:
    ``initializer.py:253``)."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .ndarray import load
            param = load(param)
        if not isinstance(param, dict):
            raise ValueError(
                "Load needs a name->NDArray dict (or a .params file saved "
                f"from one); got {type(param).__name__} — save with "
                "nd.save(fname, {name: array, ...})")
        self.param = {(k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                       else k): v for k, v in param.items()}
        self.default_init = create(default_init) \
            if default_init is not None else None
        self.verbose = verbose

    def __call__(self, name, arr) -> None:
        name = str(name)
        if name not in self.param:
            if self.default_init is None:
                raise ValueError(
                    f"Parameter {name!r} missing from the loaded file and "
                    "no default_init was given")
            self.default_init(name, arr)
            return
        t, src = getattr(arr, "_data", arr), self.param[name]
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(
                f"Parameter {name!r} has shape {tuple(t.shape)} but the "
                f"loaded value has {tuple(src.shape)}")
        src = getattr(src, "_data", src)
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(onp.asarray(src))
        with torch.no_grad():
            t.copy_(src)
        if self.verbose:
            print(f"Initialized {name} from the loaded file")


_ALIASES = {"zeros": "zero", "ones": "one", "glorot": "xavier",
            "he": "msraprelu"}


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
