"""The port's op registry: one table of every ``mx.nd`` op.

Counterpart: the JAX package's ``ops/registry.py`` (``OpDef``,
``register_op`` and ``OPS`` at ``:223-277``). Each op is a function on
tensors registered under its MXNet name and aliases; ``mx.nd`` reflects
every entry (:mod:`..ndarray.op`), so ``mx.nd.<op>``, the ``F`` of
``hybrid_forward`` and ``amp.init()`` all read this one table. A name
registered twice keeps the later function, as in the JAX registry (whose
``make_loss`` is the ``MakeLoss`` alias of ``ops/vision.py``, registered
after ``ops/tensor.py``'s). The declarative parameter schemas of the JAX
registry are not ported: each op takes MXNet's keyword arguments and
drops the ones it does not use (``**_``), as the JAX ops do.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

__all__ = ["OpDef", "OPS", "register_op", "alias_op"]


class OpDef:
    """One registered op: its name, function, aliases and module."""

    __slots__ = ("name", "fn", "aliases", "module")

    def __init__(self, name: str, fn: Callable,
                 aliases: Tuple[str, ...] = ()):
        self.name = name
        self.fn = fn
        self.aliases = tuple(aliases)
        self.module = fn.__module__


#: name or alias -> :class:`OpDef`
OPS: Dict[str, OpDef] = {}


def register_op(name: Optional[str] = None, aliases: Tuple[str, ...] = ()):
    """Register ``fn`` as ``name`` (default: its own name) and each of
    ``aliases``; returns ``fn`` unchanged."""
    def _do(fn: Callable) -> Callable:
        opdef = OpDef(name or fn.__name__, fn, aliases)
        for n in (opdef.name,) + opdef.aliases:
            OPS[n] = opdef
        return fn
    return _do


def alias_op(existing: str, *names: str) -> None:
    """More names for a registered op."""
    opdef = OPS[existing]
    for n in names:
        OPS[n] = opdef
        if n not in opdef.aliases:
            opdef.aliases = opdef.aliases + (n,)
