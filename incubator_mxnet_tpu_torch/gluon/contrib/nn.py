"""Experimental Gluon layers (JAX counterpart: ``gluon/contrib/nn.py``):
``Concurrent``/``HybridConcurrent`` (the same input to every branch, the
outputs concatenated on an axis: the Inception block) and ``Identity``
(the ``nn`` block). ``SparseEmbedding`` is not ported yet."""
from __future__ import annotations

from ..block import HybridBlock
from ...nn import Identity

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]


class HybridConcurrent(HybridBlock):
    """Feed the input to every child and concatenate their outputs along
    ``axis``; children are added with ``add`` and named ``branch<i>``."""

    def __init__(self, axis: int = -1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def add(self, block) -> None:
        self.register_child(block, f"branch{len(self._children)}")

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self._children.values()],
                        dim=self.axis)

    def __len__(self):
        return len(self._children)


class Concurrent(HybridConcurrent):
    """The imperative name of :class:`HybridConcurrent`."""
