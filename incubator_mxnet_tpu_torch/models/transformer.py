"""Transformer building blocks of BERT and the NMT Transformer, as Gluon
blocks.

Counterpart: the JAX package's ``models/transformer.py`` (``:26-151``). A
self-attention cell has one fused QKV projection, a cross-attention cell a
query projection and one fused KV projection over the memory (the encdec
layout); either feeds ``F.dot_product_attention`` (the op namespace's
:func:`~..ops.attention.dot_product_attention`, where ``amp.init()`` casts
its inputs), which takes the flash kernel, with ``causal`` passed through (the band
bottom-right aligned, as in the JAX package). Children and prefixes are the
JAX ones (attribute ``attention`` with prefix ``attn_``, ``qkv_``,
``query_``, ``kv_``, ``ffn1_`` ...), so structural and prefix parameter
names match the JAX package's. The cell's LayerNorms are given their width,
so a model initialises without a forward. ``StackedTransformerEncoder``
comes with a later slice.
"""
from __future__ import annotations

from ..gluon.block import HybridBlock
from ..nn import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell"]


class MultiHeadAttention(HybridBlock):
    """Multi-head attention (JAX counterpart: ``models/transformer.py:26``).

    ``forward(query, kv=None, mask=None)``: ``kv=None`` (or ``query``)
    is self-attention through one fused QKV projection; a cell built with
    ``cross_attention=True`` attends from ``query`` over ``kv`` (query
    projection ``query_`` and fused KV projection ``kv_``). Only the
    projections a cell uses exist. ``mask`` broadcastable to (B, H, Lq,
    Lk), 1 = attend; ``causal`` hides the keys after each query (the band
    aligned to the last key when Lq != Lk)."""

    def __init__(self, units: int, num_heads: int, dropout: float = 0.0,
                 causal: bool = False, dtype="float32",
                 cross_attention: bool = False,
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        self._cross = cross_attention
        with self.name_scope():
            if cross_attention:
                self.q_proj = Dense(units, flatten=False, in_units=units,
                                    dtype=dtype, prefix="query_",
                                    weight_initializer=weight_initializer)
                self.kv_proj = Dense(2 * units, flatten=False,
                                     in_units=units, dtype=dtype,
                                     prefix="kv_",
                                     weight_initializer=weight_initializer)
            else:
                self.qkv = Dense(3 * units, flatten=False, in_units=units,
                                 dtype=dtype, prefix="qkv_",
                                 weight_initializer=weight_initializer)
            self.proj = Dense(units, flatten=False, in_units=units,
                              dtype=dtype, prefix="proj_",
                              weight_initializer=weight_initializer)
            self.dropout = Dropout(dropout) if dropout else None

    def _heads(self, x, n):
        # (B, L, n*C) -> n contiguous (B, H, L, d) tensors: the layout the
        # flash kernel reads
        B, L = x.shape[0], x.shape[1]
        H, d = self._num_heads, self._units // self._num_heads
        return [p.reshape(B, L, H, d).transpose(1, 2).contiguous()
                for p in x.chunk(n, dim=2)]

    def hybrid_forward(self, F, query, kv=None, mask=None):
        B, Lq = query.shape[0], query.shape[1]
        if not self._cross:
            if kv is not None and kv is not query:
                raise ValueError(
                    "this MultiHeadAttention was built for self-attention; "
                    "pass cross_attention=True to attend over a memory")
            q, k, v = self._heads(self.qkv(query), 3)
        else:
            q, = self._heads(self.q_proj(query), 1)
            k, v = self._heads(self.kv_proj(query if kv is None else kv), 2)
        out = F.dot_product_attention(q, k, v, mask, causal=self._causal)
        out = out.transpose(1, 2).reshape(B, Lq, self._units)
        out = self.proj(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(HybridBlock):
    """dense(hidden) -> ``activation`` -> dense(units) -> dropout (JAX
    counterpart: ``models/transformer.py:104``)."""

    def __init__(self, units: int, hidden_size: int, dropout: float = 0.0,
                 activation: str = "gelu", dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn1 = Dense(hidden_size, flatten=False, in_units=units,
                              activation=activation, dtype=dtype,
                              prefix="ffn1_",
                              weight_initializer=weight_initializer)
            self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                              dtype=dtype, prefix="ffn2_",
                              weight_initializer=weight_initializer)
            self.dropout = Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.ffn2(self.ffn1(x))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Post-LN encoder layer: ``x = LN(x + MHA(x)); x = LN(x + FFN(x))``,
    LayerNorm epsilon 1e-12 (JAX counterpart:
    ``models/transformer.py:128``)."""

    def __init__(self, units: int, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, layer_norm_eps: float = 1e-12,
                 dtype="float32", weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(
                units, num_heads, dropout=dropout, dtype=dtype,
                prefix="attn_", weight_initializer=weight_initializer)
            self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 prefix="ln1_")
            self.ffn = PositionwiseFFN(
                units, hidden_size, dropout=dropout, dtype=dtype,
                prefix="ffn_", weight_initializer=weight_initializer)
            self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 prefix="ln2_")

    def hybrid_forward(self, F, x, mask=None):
        x = self.ln1(x + self.attention(x, None, mask))
        return self.ln2(x + self.ffn(x))
