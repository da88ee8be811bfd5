"""Transformer building blocks of the BERT encoder, as Gluon blocks.

Counterpart: the JAX package's ``models/transformer.py`` (``:26-151``). One
fused QKV projection feeds :func:`~..ops.attention.dot_product_attention`,
which takes the flash kernel. Children and prefixes are the JAX ones
(attribute ``attention`` with prefix ``attn_``, ``qkv_``, ``ffn1_`` ...),
so structural and prefix parameter names match the JAX package's. The
cell's LayerNorms are given their width, so a model initialises without a
forward. Causal and cross-attention and ``StackedTransformerEncoder`` come
with later slices.
"""
from __future__ import annotations

from ..gluon.block import HybridBlock
from ..nn import Dense, Dropout, LayerNorm
from ..ops.attention import dot_product_attention

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell"]


class MultiHeadAttention(HybridBlock):
    """Non-causal self-attention with one fused QKV projection (JAX
    counterpart: ``models/transformer.py:26``; its causal and
    cross-attention options come with the NMT slice). ``forward(query,
    kv=None, mask=None)``; ``mask`` broadcastable to (B, H, L, L), 1 =
    attend."""

    def __init__(self, units: int, num_heads: int, dropout: float = 0.0,
                 dtype="float32", weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        with self.name_scope():
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
        if kv is not None and kv is not query:
            raise ValueError("cross-attention is not ported yet")
        B, L = query.shape[0], query.shape[1]
        q, k, v = self._heads(self.qkv(query), 3)
        out = dot_product_attention(q, k, v, mask)
        out = out.transpose(1, 2).reshape(B, L, self._units)
        out = self.proj(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(HybridBlock):
    """dense(hidden) -> GELU -> dense(units) -> dropout (JAX counterpart:
    ``models/transformer.py:104``)."""

    def __init__(self, units: int, hidden_size: int, dropout: float = 0.0,
                 dtype="float32", weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn1 = Dense(hidden_size, flatten=False, in_units=units,
                              activation="gelu", dtype=dtype, prefix="ffn1_",
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
