"""Samplers: ``mx.nd.random.*`` and ``mx.random.*``.

Counterpart: the JAX package's ``ndarray/random.py``. Each sampler draws
from the explicit ``torch.Generator`` of its device (:mod:`..random`), so
``mx.random.seed(n)`` repeats the draws of every sampler on every device.
Parameters may be numbers or NDArrays; with ``shape=None`` an NDArray
parameter gives the output its shape (``(1,)`` for numbers), and the
output is ``param op draw`` broadcast as in the reference. Under
``autograd.record()`` the gradient flows into NDArray parameters of
``uniform``, ``normal``, ``exponential`` and ``gamma`` and into the
log-probabilities of ``multinomial(get_prob=True)``. The draws differ from
the JAX package's (threefry there, Philox or the CPU's Mersenne twister
here); the tests hold the distributions, not the streams.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import random as _rng
from ..base import torch_dtype
from ..context import Context, as_context
from .ndarray import NDArray, _recorded

__all__ = ["uniform", "normal", "randn", "randint", "exponential", "gamma",
           "poisson", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "bernoulli", "seed"]


def _ctx(ctx, *params) -> Context:
    """``ctx``, else the context of the first NDArray parameter, else the
    current context."""
    if ctx is not None:
        return as_context(ctx)
    for p in params:
        if isinstance(p, NDArray):
            return p.context
    return as_context(None)


def _dt(dtype) -> torch.dtype:
    return torch.float32 if dtype is None or dtype == "None" \
        else torch_dtype(dtype)


def _shape(shape, *params) -> tuple:
    if shape is None:
        for p in params:
            if isinstance(p, NDArray):
                return p.shape
        return (1,)
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _val(p, device):
    """A parameter as a tensor on ``device`` (numbers as they are)."""
    return p._data.to(device) if isinstance(p, NDArray) else p


def _draw(ctx, params, fn, out=None):
    """``fn(generator, device, *param values)`` recorded for autograd
    under ``record()`` when a parameter is an NDArray; written into
    ``out`` when given."""
    dev = ctx.torch_device
    gen = _rng.generator(ctx)
    vals = [_val(p, dev) for p in params]
    with torch.set_grad_enabled(autograd.is_recording()):
        res = fn(gen, dev, *vals)
    res = _recorded(res) if any(isinstance(p, NDArray) for p in params) \
        else NDArray(res.detach())
    if out is not None:
        out._check_inplace_ok()
        with torch.no_grad():
            out._data.copy_(res._data)
        return out
    return res


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    """Samples of U(low, high)."""
    ctx = _ctx(ctx, low, high)
    shape = _shape(shape, low, high)

    def fn(g, dev, lo, hi):
        u = torch.rand(shape, generator=g, device=dev, dtype=_dt(dtype))
        return lo + u * (hi - lo)
    return _draw(ctx, (low, high), fn, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kwargs):
    """Samples of N(loc, scale^2)."""
    ctx = _ctx(ctx, loc, scale)
    shape = _shape(shape, loc, scale)

    def fn(g, dev, mu, sd):
        return mu + torch.randn(shape, generator=g, device=dev,
                                dtype=_dt(dtype)) * sd
    return _draw(ctx, (loc, scale), fn, out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kwargs):
    return normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                  ctx=ctx)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None,
            **kwargs):
    """Integers uniform in ``[low, high)``."""
    ctx = _ctx(ctx)
    shape = _shape(shape)
    return _draw(ctx, (), lambda g, dev: torch.randint(
        int(low), int(high), shape, generator=g, device=dev,
        dtype=torch_dtype(dtype)), out)


def _exponential(shape, g, dev, dtype=torch.float32):
    return torch.empty(shape, device=dev, dtype=dtype).exponential_(
        1.0, generator=g)


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None,
                **kwargs):
    """Samples of the exponential distribution of mean ``scale``."""
    ctx = _ctx(ctx, scale)
    shape = _shape(shape, scale)
    return _draw(ctx, (scale,), lambda g, dev, lam: _exponential(
        shape, g, dev, _dt(dtype)) * lam, out)


def _gamma(alpha, shape, g, dev):
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return torch._standard_gamma(a.expand(shape).contiguous(), generator=g)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None,
          **kwargs):
    """Samples of Gamma(shape ``alpha``, scale ``beta``)."""
    ctx = _ctx(ctx, alpha, beta)
    shape = _shape(shape, alpha, beta)
    return _draw(ctx, (alpha, beta), lambda g, dev, a, b: (
        _gamma(a, shape, g, dev) * b).to(_dt(dtype)), out)


def _poisson(lam, shape, g, dev):
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    return torch.poisson(lam.expand(shape).contiguous(), generator=g)


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None, **kwargs):
    """Samples of Poisson(``lam``) (as ``dtype``, default float32)."""
    ctx = _ctx(ctx, lam)
    shape = _shape(shape, lam)
    return _draw(ctx, (lam,), lambda g, dev, lv: _poisson(
        lv, shape, g, dev).to(_dt(dtype)), out)


def negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None,
                      out=None, **kwargs):
    """Failures before the ``k``-th success at success rate ``p``:
    Poisson(Gamma(k, (1 - p) / p))."""
    ctx = _ctx(ctx, k, p)
    shape = _shape(shape, k, p)

    def fn(g, dev, kv, pv):
        lam = _gamma(kv, shape, g, dev) * (1.0 - pv) / pv
        return _poisson(lam, shape, g, dev).to(_dt(dtype))
    return _draw(ctx, (k, p), fn, out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  ctx=None, out=None, **kwargs):
    """The negative binomial of mean ``mu`` and dispersion ``alpha``."""
    ctx = _ctx(ctx, mu, alpha)
    shape = _shape(shape, mu, alpha)

    def fn(g, dev, m, a):
        r = 1.0 / a
        pv = r / (r + m)
        lam = _gamma(r, shape, g, dev) * (1.0 - pv) / pv
        return _poisson(lam, shape, g, dev).to(_dt(dtype))
    return _draw(ctx, (mu, alpha), fn, out)


def multinomial(data, shape=1, get_prob=False, dtype="int32", **kwargs):
    """Class indices drawn from the probabilities ``data`` (K,) or
    (N, K): ``shape`` draws per distribution (the default int 1 drops the
    draw axis). ``get_prob`` also returns each draw's log-probability,
    recorded for autograd (REINFORCE)."""
    ctx = data.context
    dims = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in dims:
        n *= int(d)
    squeeze = isinstance(shape, int) and shape == 1
    p = data._data.detach()
    rows = p.reshape(-1, p.shape[-1]).float().clamp_min(1e-30)
    flat = torch.multinomial(rows, n, replacement=True,
                             generator=_rng.generator(ctx))   # (rows, n)
    lead = () if p.dim() == 1 else (p.shape[0],)

    def shaped(t):
        t = t.reshape(lead + (n,))
        return t[..., 0] if squeeze else t.reshape(lead + dims)
    res = NDArray(shaped(flat).to(torch_dtype(dtype)))
    if not get_prob:
        return res
    with torch.set_grad_enabled(autograd.is_recording()):
        lg = torch.log(data._data.clamp_min(1e-30))
        picked = torch.gather(lg.reshape(-1, lg.shape[-1]), 1, flat)
        logp = _recorded(shaped(picked))
    return res, logp


def shuffle(data, **kwargs):
    """``data`` with its first axis in a random order."""
    ctx = data.context
    perm = torch.randperm(data.shape[0], generator=_rng.generator(ctx),
                          device=ctx.torch_device)
    with torch.set_grad_enabled(autograd.is_recording()):
        return _recorded(data._data[perm])


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, out=None,
              **kwargs):
    """1 with probability ``prob``, else 0."""
    ctx = _ctx(ctx, prob)
    shape = _shape(shape, prob)
    return _draw(ctx, (prob,), lambda g, dev, pv: (torch.rand(
        shape, generator=g, device=dev) < pv).to(torch_dtype(dtype)), out)


def seed(seed_state, ctx="all"):
    """``mx.random.seed`` (reference: ``mx.nd.random.seed``)."""
    _rng.seed(seed_state, ctx=ctx)
