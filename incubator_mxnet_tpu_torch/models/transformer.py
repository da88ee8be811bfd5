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
so a model initialises without a forward. :class:`StackedTransformerEncoder`
(``:154-285``) keeps every layer's parameters in one tensor per kind, with
a leading layer axis.
"""
from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..nn import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "StackedTransformerEncoder"]


class MultiHeadAttention(HybridBlock):
    """Multi-head attention (JAX counterpart: ``models/transformer.py:26``).

    ``forward(query, kv=None, mask=None)``: ``kv=None`` (or ``query``)
    is self-attention through one fused QKV projection; a cell built with
    ``cross_attention=True`` attends from ``query`` over ``kv`` (query
    projection ``query_`` and fused KV projection ``kv_``). Only the
    projections a cell uses exist. ``mask`` broadcastable to (B, H, Lq,
    Lk), 1 = attend; ``causal`` hides the keys after each query (the band
    aligned to the last key when Lq != Lk). ``use_bias=False`` builds every
    projection without a bias."""

    def __init__(self, units: int, num_heads: int, dropout: float = 0.0,
                 causal: bool = False, use_bias: bool = True,
                 dtype="float32", cross_attention: bool = False,
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
                self.q_proj = Dense(units, flatten=False, use_bias=use_bias,
                                    in_units=units, dtype=dtype,
                                    prefix="query_",
                                    weight_initializer=weight_initializer)
                self.kv_proj = Dense(2 * units, flatten=False,
                                     use_bias=use_bias, in_units=units,
                                     dtype=dtype, prefix="kv_",
                                     weight_initializer=weight_initializer)
            else:
                self.qkv = Dense(3 * units, flatten=False, use_bias=use_bias,
                                 in_units=units, dtype=dtype, prefix="qkv_",
                                 weight_initializer=weight_initializer)
            self.proj = Dense(units, flatten=False, use_bias=use_bias,
                              in_units=units, dtype=dtype, prefix="proj_",
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
    LayerNorm epsilon 1e-12, the FFN's ``activation`` GELU by default (JAX
    counterpart: ``models/transformer.py:128``)."""

    def __init__(self, units: int, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, layer_norm_eps: float = 1e-12,
                 activation: str = "gelu", dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(
                units, num_heads, dropout=dropout, dtype=dtype,
                prefix="attn_", weight_initializer=weight_initializer)
            self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 prefix="ln1_")
            self.ffn = PositionwiseFFN(
                units, hidden_size, dropout=dropout, activation=activation,
                dtype=dtype, prefix="ffn_",
                weight_initializer=weight_initializer)
            self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 prefix="ln2_")

    def hybrid_forward(self, F, x, mask=None):
        x = self.ln1(x + self.attention(x, None, mask))
        return self.ln2(x + self.ffn(x))


class StackedTransformerEncoder(HybridBlock):
    """Post-LN transformer encoder whose parameters carry a leading
    ``(num_layers,)`` axis (JAX counterpart: ``models/transformer.py:154``,
    under the same names: ``qkv_weight`` (N, 3C, C), ``proj_weight``,
    ``ffn1_weight`` (N, H, C), ``ffn2_weight``, their biases, and
    ``ln1_gamma``/``ln1_beta``/``ln2_gamma``/``ln2_beta``).

    ``forward(x)`` on (B, L, C) runs the layers in a loop, where the JAX
    block scans over the layer axis. Each layer is the JAX block's layer as
    written: plain scores in float32 over all keys (no mask), softmax,
    exact GELU, post-LN with epsilon ``layer_norm_eps``. The JAX package
    computes it outside the flash kernels, so it is plain torch products
    here.

    Under an active mesh whose ``pp`` is more than 1 and divides the
    layers, with ``B`` divisible by ``n_micro`` (a ``ShardedTrainer``
    step), the stack is ``pp`` stages of ``N/pp`` layers and the forward
    runs the GPipe schedule (:func:`~..parallel.pipeline.pipeline_apply`)
    on ``n_micro`` microbatches of this rank's rows (JAX ``:241-285``).
    Every parameter's ``local_axis`` is ``pp``: under a rule that cuts the
    layer axis over ``pp`` the trainer hands over this rank's layers
    ungathered, and their gradients stay this rank's. A stack given whole
    is cut to this rank's stage by
    :func:`~..parallel.collectives.replicated_slice`; one given as a stage
    where the schedule does not apply is gathered."""

    _KINDS = ("qkv_w", "qkv_b", "proj_w", "proj_b", "ffn1_w", "ffn1_b",
              "ffn2_w", "ffn2_b", "ln1_g", "ln1_b", "ln2_g", "ln2_b")

    def __init__(self, num_layers: int, units: int, hidden_size: int,
                 num_heads: int, layer_norm_eps: float = 1e-12,
                 n_micro: int = 4, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._N = num_layers
        self._units = units
        self._hidden = hidden_size
        self._heads = num_heads
        self._eps = layer_norm_eps
        self._n_micro = n_micro
        N, C, H = num_layers, units, hidden_size
        with self.name_scope():
            get = self.params.get
            self.qkv_w = get("qkv_weight", shape=(N, 3 * C, C),
                             init="xavier", dtype=dtype)
            self.qkv_b = get("qkv_bias", shape=(N, 3 * C), init="zeros",
                             dtype=dtype)
            self.proj_w = get("proj_weight", shape=(N, C, C), init="xavier",
                              dtype=dtype)
            self.proj_b = get("proj_bias", shape=(N, C), init="zeros",
                              dtype=dtype)
            self.ffn1_w = get("ffn1_weight", shape=(N, H, C), init="xavier",
                              dtype=dtype)
            self.ffn1_b = get("ffn1_bias", shape=(N, H), init="zeros",
                              dtype=dtype)
            self.ffn2_w = get("ffn2_weight", shape=(N, C, H), init="xavier",
                              dtype=dtype)
            self.ffn2_b = get("ffn2_bias", shape=(N, C), init="zeros",
                              dtype=dtype)
            self.ln1_g = get("ln1_gamma", shape=(N, C), init="ones",
                             dtype=dtype)
            self.ln1_b = get("ln1_beta", shape=(N, C), init="zeros",
                             dtype=dtype)
            self.ln2_g = get("ln2_gamma", shape=(N, C), init="ones",
                             dtype=dtype)
            self.ln2_b = get("ln2_beta", shape=(N, C), init="zeros",
                             dtype=dtype)
        for n in self._KINDS:
            getattr(self, n).local_axis = "pp"

    def _ln(self, v, g, b):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + self._eps) * g + b

    def _layer(self, p, x):
        """One layer on (B, L, C) (JAX counterpart: ``_layer``,
        ``:211-236``)."""
        C, Hd = self._units, self._heads
        D = C // Hd
        B, L, _ = x.shape

        def heads(t):
            return t.reshape(B, L, Hd, D).transpose(1, 2)

        qkv = torch.matmul(x, p["qkv_w"].t()) + p["qkv_b"]
        q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * (D ** -0.5)
        a = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.matmul(a, v).transpose(1, 2).reshape(B, L, C)
        o = torch.matmul(o, p["proj_w"].t()) + p["proj_b"]
        x = self._ln(x + o, p["ln1_g"], p["ln1_b"])
        h = torch.nn.functional.gelu(
            torch.matmul(x, p["ffn1_w"].t()) + p["ffn1_b"],
            approximate="none")
        f = torch.matmul(h, p["ffn2_w"].t()) + p["ffn2_b"]
        return self._ln(x + f, p["ln2_g"], p["ln2_b"])

    def _stack(self, p, x):
        for i in range(next(iter(p.values())).shape[0]):
            x = self._layer({n: v[i] for n, v in p.items()}, x)
        return x

    def hybrid_forward(self, F, x, **kw):
        from ..parallel import collectives
        from ..parallel.mesh import current_active_mesh
        from ..parallel.pipeline import pipeline_apply
        tree = {n: kw[n] for n in self._KINDS}
        mesh = current_active_mesh()
        pp = mesh.axis_size("pp") if mesh is not None else 1
        staged = tree["qkv_w"].shape[0] != self._N
        if pp > 1 and self._N % pp == 0 \
                and x.shape[0] % self._n_micro == 0:
            if not staged:
                tree = {n: collectives.replicated_slice(v, "pp", 0,
                                                        mesh=mesh)
                        for n, v in tree.items()}
            M, B = self._n_micro, x.shape[0]
            xm = x.reshape((M, B // M) + tuple(x.shape[1:]))
            out = pipeline_apply({n: v[None] for n, v in tree.items()}, xm,
                                 self._stack, axis="pp", mesh=mesh)
            return out.reshape(x.shape)
        if staged:
            tree = {n: collectives.replicated_gather(v, "pp", 0, mesh=mesh)
                    for n, v in tree.items()}
        return self._stack(tree, x)
