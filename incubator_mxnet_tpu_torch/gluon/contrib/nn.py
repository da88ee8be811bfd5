"""Experimental Gluon layers (JAX counterpart: ``gluon/contrib/nn.py``):
``Concurrent``/``HybridConcurrent`` (the same input to every branch, the
outputs concatenated on an axis: the Inception block) and ``Identity``
(the ``nn`` block), and ``SparseEmbedding``: ``nn.Embedding`` with
the reference's call, its gradient dense, as in the JAX package
(``:56``)."""
from __future__ import annotations

from ..block import HybridBlock
from ...nn import Embedding, Identity

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding"]


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


class SparseEmbedding(Embedding):
    """The reference's row-sparse-gradient embedding, dense underneath (JAX
    counterpart: ``gluon/contrib/nn.py:56``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=False, **kwargs)
