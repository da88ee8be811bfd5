"""Random streams: one seeded ``torch.Generator`` per device.

Counterpart: the JAX package's ``random.py`` (``seed`` at ``:74``, the
per-context streams of ``_key_for``/``next_key`` at ``:87-107``, the
sampling functions at ``:131-150``). ``seed(n)`` reseeds every stream:
the CPU's starts from ``n`` itself, ``gpu(i)``'s from a number derived
from ``n`` and ``i``; ``seed(n, ctx)`` seeds one device's stream. A stream
is reseeded in place, so a CUDA graph that registered its generator (a
hybridized block, :mod:`.ops.cuda.graphs`) draws the reseeded stream. The
Gluon ``Dropout`` draws from its device's stream unless a trainer gave it
its own generator (``nn.set_dropout_generator``), and the initializers draw
from the CPU's (:mod:`..initializer`). Draws differ from the JAX package's
(threefry there, Philox here).
"""
from __future__ import annotations

import threading

import torch

from .context import Context, as_context

__all__ = ["seed", "generator", "uniform", "normal"]

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


def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, dtype="float32"):
    """Samples of U(low, high) from ``ctx``'s stream."""
    from .ndarray import empty
    out = empty(shape, ctx=ctx, dtype=dtype)
    out._data.uniform_(low, high, generator=generator(out.context))
    return out


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, dtype="float32"):
    """Samples of N(loc, scale²) from ``ctx``'s stream."""
    from .ndarray import empty
    out = empty(shape, ctx=ctx, dtype=dtype)
    out._data.normal_(loc, scale, generator=generator(out.context))
    return out
