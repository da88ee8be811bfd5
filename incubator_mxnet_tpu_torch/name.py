"""Automatic symbol naming: ``NameManager`` and ``Prefix``.

Counterpart: the JAX package's ``name.py`` (a copy: the port imports
nothing of the JAX package). The scope that turns ``FullyConnected(...)``
into ``fullyconnected0`` and, under ``with mx.name.Prefix('encoder_'):``,
into ``encoder_fullyconnected0``; ``symbol._auto_name`` consults the
innermost manager of the calling thread.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Counts per op-type hint and yields ``<hint><n>`` names. Use as a
    context manager to install; nesting restores the outer manager."""

    _local = threading.local()

    def __init__(self):
        self._counter: Dict[str, int] = {}

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        n = self._counter.setdefault(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    @classmethod
    def current(cls) -> "NameManager":
        stack = getattr(cls._local, "stack", None)
        if stack:
            return stack[-1]
        if not hasattr(cls._local, "default"):
            cls._local.default = NameManager()
        return cls._local.default

    def __enter__(self):
        if not hasattr(self._local, "stack"):
            NameManager._local.stack = []
        NameManager._local.stack.append(self)
        return self

    def __exit__(self, *exc):
        NameManager._local.stack.pop()


class Prefix(NameManager):
    """Prepend a fixed prefix to every auto-generated name in scope."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        return self._prefix + super().get(None, hint)
