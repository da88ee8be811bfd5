"""Random streams: one seeded ``torch.Generator`` per device.

Counterpart: the JAX package's ``random.py`` (``seed`` at ``:74``, the
per-context streams of ``_key_for``/``next_key`` at ``:87-107``, the
sampling functions at ``:131-150``). ``seed(n)`` reseeds every stream:
the CPU's starts from ``n`` itself, ``gpu(i)``'s from a number derived
from ``n`` and ``i``; ``seed(n, ctx)`` seeds one device's stream. A stream
is reseeded in place, so a CUDA graph that registered its generator (a
hybridized block, :mod:`.ops.cuda.graphs`) draws the reseeded stream. The
Gluon ``Dropout`` draws from its device's stream unless a trainer gave it
its own generator (``nn.set_dropout_generator``), the initializers draw
from the CPU's (:mod:`..initializer`), and the samplers (``uniform``,
``normal`` ... ``shuffle``, :mod:`.ndarray.random`) from their device's.
Draws differ from the JAX package's (threefry there, Philox here).
"""
from __future__ import annotations

import threading

import torch

from .context import Context, as_context

__all__ = ["seed", "generator", "uniform", "normal", "randn", "randint",
           "exponential", "poisson", "gamma", "negative_binomial",
           "generalized_negative_binomial", "multinomial", "shuffle"]

_lock = threading.Lock()
_root_seed = 0
_gens = {}


def _derive(root: int, ctx: Context) -> int:
    if ctx.device_type == "cpu":
        return root
    return (root * 1_000_003 + ctx.device_typeid * 1_009
            + ctx.device_id) % (1 << 63)


def _make(ctx: Context, s: int) -> torch.Generator:
    return torch.Generator(device=ctx.torch_device).manual_seed(s)


def seed(seed_state: int, ctx="all") -> None:
    """Seed every device's stream (``ctx="all"``) or one device's
    (reference: MXRandomSeed / MXRandomSeedContext)."""
    global _root_seed
    with _lock:
        if isinstance(ctx, str) and ctx == "all":
            _root_seed = int(seed_state)
            for c, g in _gens.items():
                g.manual_seed(_derive(_root_seed, c))
        else:
            c = as_context(ctx)
            if c in _gens:
                _gens[c].manual_seed(int(seed_state))
            else:
                _gens[c] = _make(c, int(seed_state))


def generator(ctx=None) -> torch.Generator:
    """The stream of ``ctx``'s device (default: the current context)."""
    c = as_context(ctx)
    with _lock:
        g = _gens.get(c)
        if g is None:
            g = _gens[c] = _make(c, _derive(_root_seed, c))
    return g


def _delegate(name):
    def fn(*args, **kwargs):
        from .ndarray import random as _ndr
        return getattr(_ndr, name)(*args, **kwargs)
    fn.__name__ = name
    fn.__doc__ = f"mx.random.{name}: see mx.nd.random.{name}."
    return fn


uniform = _delegate("uniform")
normal = _delegate("normal")
randn = _delegate("randn")
randint = _delegate("randint")
exponential = _delegate("exponential")
poisson = _delegate("poisson")
gamma = _delegate("gamma")
negative_binomial = _delegate("negative_binomial")
generalized_negative_binomial = _delegate("generalized_negative_binomial")
multinomial = _delegate("multinomial")
shuffle = _delegate("shuffle")
