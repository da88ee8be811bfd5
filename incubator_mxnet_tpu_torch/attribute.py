"""Attribute scoping for symbol construction: ``AttrScope``.

Counterpart: the JAX package's ``attribute.py`` (a copy: the port imports
nothing of the JAX package). Symbols composed inside ``with
mx.AttrScope(ctx_group='dev1'):`` carry the scope's attributes
(``group2ctx``, ``lr_mult``/``wd_mult`` annotations, subgraph hints). They
are stored on the node under an ``_attr_`` key prefix so they never collide
with operator parameters; ``Symbol.attr``/``list_attr`` strip the prefix.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["AttrScope", "current_attrs"]

_PREFIX = "_attr_"


class AttrScope:
    """Attach ``key=value`` string attributes to every symbol created inside
    the ``with`` block. Scopes nest; inner values win."""

    _local = threading.local()

    def __init__(self, **attrs: str):
        for k, v in attrs.items():
            if not isinstance(v, str):
                raise ValueError(
                    f"AttrScope value for {k!r} must be a string, got "
                    f"{type(v).__name__} (attributes are serialized as "
                    "strings)")
        self._attrs = attrs

    @classmethod
    def _stack(cls):
        if not hasattr(cls._local, "stack"):
            cls._local.stack = []
        return cls._local.stack

    def __enter__(self):
        self._stack().append(self._attrs)
        return self

    def __exit__(self, *exc):
        self._stack().pop()


def current_attrs() -> Dict[str, str]:
    """Merged scope attributes, outermost first, keyed with the storage
    prefix (used by ``Symbol.__init__``)."""
    merged: Dict[str, str] = {}
    for frame in AttrScope._stack():
        for k, v in frame.items():
            merged[_PREFIX + k] = v
    return merged
