"""Transformer NMT (encoder-decoder), its incremental decode step and beam
search, as Gluon blocks and functions on tensors.

Counterpart: the JAX package's ``models/nmt.py`` (GluonNLP's
``machine_translation`` Transformer and its ``BeamSearchSampler``).
Children, prefixes and parameter names are the JAX ones (``src_embed_``,
``enc_layer0_attn_qkv_``, ``dec_layer0_crossattn_kv_`` ...); the output
projection is tied to the target embedding (one parameter), so ``.params``
files and ``convert.params_from_jax`` move weights between the packages.

Training is teacher-forced over the whole target: encoder self-attention
under the source key mask, decoder causal self-attention and
cross-attention over the memory (target length != source length) all take
:func:`~..ops.attention.dot_product_attention`, so on the card each is the
flash kernel forward and, under autograd, its two backward kernels.

Decoding is incremental (:func:`nmt_step` over a contiguous KV cache,
:func:`nmt_paged_step` over a paged pool, the model math of
``serve.decode``): one query per row, so its attention is plain torch, as
the JAX package computes it in ``jnp`` (``nmt.py:260-272``), not in
Pallas. The cache writes are in place (``index_put_``) on preallocated
tensors, the counterpart of the JAX step's donated buffers, and the step
returns the same tensors, so one CUDA graph can capture it.
:func:`beam_search` runs the incremental step; :func:`beam_search_reference`
re-decodes the whole prefix each step and is the parity oracle.
:func:`mt_example` is the loop of the JAX package's
``examples/machine_translation.py``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as onp
import torch

from .. import autograd
from .. import ndarray as F
from ..gluon.block import HybridBlock
from ..ndarray import NDArray
from ..ndarray.op import _nd_op
from ..nn import Dropout, Embedding, LayerNorm
from ..ops.nn import top_k as _top_k
from .transformer import MultiHeadAttention, PositionwiseFFN

__all__ = ["TransformerEncoder", "TransformerDecoder", "NMTModel",
           "source_mask", "label_smoothed_ce", "beam_search",
           "beam_search_reference", "incremental_decode_params",
           "cross_attention_kv", "nmt_step", "nmt_paged_step",
           "make_mt_batch", "mt_example", "MT_CONFIG",
           "transformer_sharding_rules"]

#: LayerNorm epsilon of the NMT layers and of the decode step's
#: normalisation (``nn.LayerNorm``'s default, ``nmt.py:208``)
_LN_EPS = 1e-5


def position_encoding(L: int, C: int) -> onp.ndarray:
    """The sinusoid table ``(L, C)``: angles in numpy float64, stored as
    float32, exactly as the JAX package computes it (``nmt.py:33-43``), so
    both packages hold the same bits."""
    pos = onp.arange(L)[:, None]
    dim = onp.arange(C // 2)[None, :]
    angle = pos / onp.power(10000.0, 2 * dim / C)
    out = onp.zeros((L, C), "float32")
    out[:, 0::2] = onp.sin(angle)
    out[:, 1::2] = onp.cos(angle)
    return out


class _PositionTable:
    """One block's position table, as a tensor per (device, dtype), made at
    the first forward that asks for it and kept: a CUDA graph that captured
    a later forward reads it from the same memory."""

    def __init__(self, L: int, C: int):
        self._host = position_encoding(L, C)
        self._tables: Dict[tuple, torch.Tensor] = {}

    def get(self, device, dtype=torch.float32) -> torch.Tensor:
        key = (torch.device(device), dtype)
        t = self._tables.get(key)
        if t is None:
            t = self._tables[key] = torch.from_numpy(self._host).to(
                device=device, dtype=dtype)
        return t


def source_mask(valid_length, B: int, L: int):
    """``(B, 1, 1, L)`` 0/1 float32 key mask ``arange(L) < valid_length``,
    or None (JAX counterpart: ``NMTModel._src_mask``, ``nmt.py:169``);
    the flash wrapper reads it as a key-padding mask."""
    if valid_length is None:
        return None
    steps = torch.arange(L, dtype=torch.float32,
                         device=valid_length.device).reshape(1, L)
    m = F.broadcast_lesser(steps, valid_length.to(torch.float32).reshape(
        B, 1))
    return m.reshape(B, 1, 1, L)


class _EncoderLayer(HybridBlock):
    """Post-LN: ``x = LN(x + MHA(x)); x = LN(x + FFN(x))``, ReLU FFN
    (JAX counterpart: ``nmt.py:46``)."""

    def __init__(self, units, hidden, heads, dropout, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.attn = MultiHeadAttention(units, heads, dropout=dropout,
                                           prefix="attn_")
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_")
            self.ffn = PositionwiseFFN(units, hidden, dropout=dropout,
                                       activation="relu", prefix="ffn_")
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_")

    def hybrid_forward(self, F, x, mask=None):
        x = self.ln1(x + self.attn(x, None, mask))
        return self.ln2(x + self.ffn(x))


class _DecoderLayer(HybridBlock):
    """Post-LN: causal self-attention, cross-attention over the memory,
    ReLU FFN (JAX counterpart: ``nmt.py:62``)."""

    def __init__(self, units, hidden, heads, dropout, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.self_attn = MultiHeadAttention(units, heads, dropout=dropout,
                                                causal=True,
                                                prefix="selfattn_")
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_")
            self.cross_attn = MultiHeadAttention(units, heads,
                                                 dropout=dropout,
                                                 cross_attention=True,
                                                 prefix="crossattn_")
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_")
            self.ffn = PositionwiseFFN(units, hidden, dropout=dropout,
                                       activation="relu", prefix="ffn_")
            self.ln3 = LayerNorm(in_channels=units, prefix="ln3_")

    def hybrid_forward(self, F, x, memory, mem_mask=None):
        x = self.ln1(x + self.self_attn(x))
        x = self.ln2(x + self.cross_attn(x, memory, mem_mask))
        return self.ln3(x + self.ffn(x))


class _Stack(HybridBlock):
    """``x * sqrt(units) + pe[:L]``, dropout, then the layers ``layer0``
    ... (JAX counterparts: ``TransformerEncoder``/``TransformerDecoder``,
    ``nmt.py:83-135``)."""

    _layer = None

    def __init__(self, units=512, hidden_size=2048, num_layers=6,
                 num_heads=8, dropout=0.1, max_length=512, **kw):
        super().__init__(**kw)
        self._units = units
        self._max_length = max_length
        self._pe = _PositionTable(max_length, units)
        with self.name_scope():
            self.layers = []
            for i in range(num_layers):
                layer = self._layer(units, hidden_size, num_heads, dropout,
                                    prefix=f"layer{i}_")
                self.register_child(layer, f"layer{i}")
                self.layers.append(layer)
            self.dropout = Dropout(dropout) if dropout else None

    def _embed(self, x, pe_dtype):
        L = x.shape[1]
        pe = self._pe.get(x.device, pe_dtype)[:L]
        x = x * (self._units ** 0.5) + pe.unsqueeze(0)
        return self.dropout(x) if self.dropout is not None else x


class TransformerEncoder(_Stack):
    """The encoder stack (JAX counterpart: ``nmt.py:83``); its position
    table takes the input's dtype, as there."""

    _layer = _EncoderLayer

    def hybrid_forward(self, F, x, mask=None):
        x = self._embed(x, x.dtype)
        for layer in self.layers:
            x = layer(x, mask)
        return x


class TransformerDecoder(_Stack):
    """The decoder stack (JAX counterpart: ``nmt.py:111``); its position
    table is float32, as there."""

    _layer = _DecoderLayer

    def hybrid_forward(self, F, x, memory, mem_mask=None):
        x = self._embed(x, torch.float32)
        for layer in self.layers:
            x = layer(x, memory, mem_mask)
        return x


class NMTModel(HybridBlock):
    """Encoder-decoder with the target embedding tied to the output
    projection (JAX counterpart: ``nmt.py:138``).

    ``forward(src, tgt, src_valid_length=None)`` -> ``(B, Lt, tgt_vocab)``
    logits (teacher forcing: shifting the target is the caller's concern).
    ``proj_weight`` *is* ``tgt_embed.weight`` (one parameter, one torch
    tensor, two structural names) unless ``tie_weights=False``. Every
    parameter's shape is known at construction."""

    def __init__(self, src_vocab: int, tgt_vocab: int, units=512,
                 hidden_size=2048, num_layers=6, num_heads=8, dropout=0.1,
                 max_length=512, tie_weights=True, **kw):
        super().__init__(**kw)
        self._units = units
        self._tgt_vocab = tgt_vocab
        with self.name_scope():
            self.src_embed = Embedding(src_vocab, units, prefix="src_embed_")
            self.tgt_embed = Embedding(tgt_vocab, units, prefix="tgt_embed_")
            self.encoder = TransformerEncoder(units, hidden_size, num_layers,
                                              num_heads, dropout, max_length,
                                              prefix="enc_")
            self.decoder = TransformerDecoder(units, hidden_size, num_layers,
                                              num_heads, dropout, max_length,
                                              prefix="dec_")
            if tie_weights:
                self.proj_weight = self.tgt_embed.weight
            else:
                self.proj_weight = self.params.get(
                    "proj_weight", shape=(tgt_vocab, units))
            self.proj_bias = self.params.get("proj_bias", shape=(tgt_vocab,),
                                             init="zeros")

    def encode(self, src, src_valid_length=None):
        """``(memory (B, Ls, U), mask (B, 1, 1, Ls) or None)`` (JAX
        counterpart: ``nmt.py:176``); NDArrays in, NDArrays out."""
        if isinstance(src, NDArray):
            with torch.set_grad_enabled(autograd.is_recording()):
                mem, mask = self.encode(src._data, None if src_valid_length
                                        is None else src_valid_length._data)
            return NDArray(mem), (None if mask is None else NDArray(mask))
        B, L = src.shape
        mask = source_mask(src_valid_length, B, L)
        return self.encoder(self.src_embed(src), mask), mask

    def hybrid_forward(self, F, src, tgt, src_valid_length=None,
                       proj_weight=None, proj_bias=None):
        B, Ls = src.shape[0], src.shape[1]
        mask = source_mask(src_valid_length, B, Ls)
        memory = self.encoder(self.src_embed(src), mask)
        out = self.decoder(self.tgt_embed(tgt), memory, mask)
        return F.FullyConnected(out, proj_weight, proj_bias, flatten=False)


@_nd_op
def label_smoothed_ce(logits, label, eps: float = 0.1):
    """Per-token softmax cross-entropy against ``(1 - eps) * one_hot(label)
    + eps / V``, the targets of the JAX package's
    ``examples/machine_translation.py:74-81`` (GluonNLP's label
    smoothing), from sparse labels: ``-((1 - eps) * logp[label] + eps / V *
    sum(logp))`` over the last axis, in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    V = logp.shape[-1]
    picked = logp.gather(-1, label.to(torch.int64).unsqueeze(-1)).squeeze(-1)
    return -((1.0 - eps) * picked + (eps / V) * logp.sum(dim=-1))


# ---------------------------------------------------------------------------
# incremental (KV-cached) decode: the model math of serve.decode
# ---------------------------------------------------------------------------

def _ln(x, g, b):
    """LayerNorm as the JAX decode step writes it (``nmt.py:211-214``)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * g + b


def incremental_decode_params(model: NMTModel) -> dict:
    """The decoder-side parameters of ``model`` as a dict of its own tensors
    (no copies), the layout :func:`nmt_step` and :func:`nmt_paged_step`
    read, plus the float32 position table on their device (JAX
    counterpart: ``nmt.py:217``)."""
    def d(p):
        return p._tensor()

    layers = []
    for layer in model.decoder.layers:
        sa, ca = layer.self_attn, layer.cross_attn
        layers.append({
            "qkv_w": d(sa.qkv.weight), "qkv_b": d(sa.qkv.bias),
            "sproj_w": d(sa.proj.weight), "sproj_b": d(sa.proj.bias),
            "q_w": d(ca.q_proj.weight), "q_b": d(ca.q_proj.bias),
            "kv_w": d(ca.kv_proj.weight), "kv_b": d(ca.kv_proj.bias),
            "cproj_w": d(ca.proj.weight), "cproj_b": d(ca.proj.bias),
            "ln1_g": d(layer.ln1.gamma), "ln1_b": d(layer.ln1.beta),
            "ln2_g": d(layer.ln2.gamma), "ln2_b": d(layer.ln2.beta),
            "ln3_g": d(layer.ln3.gamma), "ln3_b": d(layer.ln3.beta),
            "ffn1_w": d(layer.ffn.ffn1.weight),
            "ffn1_b": d(layer.ffn.ffn1.bias),
            "ffn2_w": d(layer.ffn.ffn2.weight),
            "ffn2_b": d(layer.ffn.ffn2.bias),
        })
    embed = d(model.tgt_embed.weight)
    return {"embed": embed, "proj_w": d(model.proj_weight),
            "proj_b": d(model.proj_bias),
            "pe": model.decoder._pe.get(embed.device),
            "num_heads": model.decoder.layers[0].self_attn._num_heads,
            "layers": layers}


def cross_attention_kv(params: dict, memory: torch.Tensor) -> torch.Tensor:
    """Every decoder layer's cross-attention K/V from the encoder memory
    ``(B, Ls, U)``: ``(NL, B, Ls, 2U)`` (JAX counterpart: ``nmt.py:253``)."""
    return torch.stack([memory @ p["kv_w"].T + p["kv_b"]
                        for p in params["layers"]])


def _attend(q, keys, vals, mask, num_heads):
    """Single-query attention: ``q (B, U)``, ``keys/vals (B, T, U)``,
    ``mask (B, T)`` bool, True = attend -> ``(B, U)``; hidden scores are
    -1e9 and the softmax runs in float32 (JAX counterpart:
    ``nmt.py:260``)."""
    B, T, U = keys.shape
    H, dh = num_heads, U // num_heads
    s = torch.einsum("bhd,bthd->bht", q.reshape(B, H, dh).float(),
                     keys.reshape(B, T, H, dh).float()) * (dh ** -0.5)
    s = s.masked_fill(~mask[:, None, :], -1e9)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bht,bthd->bhd", a,
                        vals.reshape(B, T, H, dh)).reshape(B, U)


def _step_body(params, tokens, positions, cross_kv, mem_mask, self_kv_of,
               write_kv):
    """One decoder token per row; the contiguous and paged steps differ
    only in how self-attention K/V are stored (``write_kv``) and read back
    (``self_kv_of``) (JAX counterpart: ``nmt.py:275``)."""
    H = params["num_heads"]
    U = params["embed"].shape[1]
    x = (params["embed"][tokens.long()] * (U ** 0.5)
         + params["pe"][positions.long()])
    for li, p in enumerate(params["layers"]):
        qkv = x @ p["qkv_w"].T + p["qkv_b"]
        q, k, v = qkv.chunk(3, dim=-1)
        write_kv(li, k, v)
        keys, vals, smask = self_kv_of(li)
        attn = _attend(q, keys, vals, smask, H)
        x = _ln(x + (attn @ p["sproj_w"].T + p["sproj_b"]),
                p["ln1_g"], p["ln1_b"])
        cq = x @ p["q_w"].T + p["q_b"]
        ck, cv = cross_kv[li].chunk(2, dim=-1)
        cmask = (torch.ones(ck.shape[:2], dtype=torch.bool, device=x.device)
                 if mem_mask is None else mem_mask)
        cattn = _attend(cq, ck, cv, cmask, H)
        x = _ln(x + (cattn @ p["cproj_w"].T + p["cproj_b"]),
                p["ln2_g"], p["ln2_b"])
        h = torch.relu(x @ p["ffn1_w"].T + p["ffn1_b"])
        x = _ln(x + (h @ p["ffn2_w"].T + p["ffn2_b"]),
                p["ln3_g"], p["ln3_b"])
    return x @ params["proj_w"].T + params["proj_b"]


def nmt_step(params, cache_k, cache_v, cross_kv, mem_mask, tokens,
             positions):
    """One incremental decoder step over a **contiguous** KV cache (JAX
    counterpart: ``nmt.py:303``).

    ``cache_k``/``cache_v``: ``(NL, B, T, U)``, written in place at each
    row's position; ``cross_kv``: ``(NL, B, Ls, 2U)``; ``mem_mask``:
    ``(B, Ls)`` bool, True = attend, or None; ``tokens``/``positions``:
    ``(B,)`` integer (per-row positions, so one batch holds sequences of
    different lengths). Returns ``(logits (B, V), cache_k, cache_v)``, the
    caches being the tensors given."""
    T = cache_k.shape[2]
    rows = torch.arange(cache_k.shape[1], device=cache_k.device)
    pos = positions.long()
    smask = torch.arange(T, device=cache_k.device)[None, :] <= pos[:, None]

    def write(li, k, v):
        cache_k[li].index_put_((rows, pos), k)
        cache_v[li].index_put_((rows, pos), v)

    def read(li):
        return cache_k[li], cache_v[li], smask

    logits = _step_body(params, tokens, positions, cross_kv, mem_mask, read,
                        write)
    return logits, cache_k, cache_v


def nmt_paged_step(params, block_size, pool_k, pool_v, block_tables,
                   positions, tokens, cross_kv, mem_mask):
    """One incremental decoder step over a **paged** KV cache (JAX
    counterpart: ``nmt.py:331``).

    ``pool_k``/``pool_v``: ``(NB, NL, block_size, U)``, the pages every
    in-flight sequence shares; ``block_tables``: ``(B, nb)`` integer rows
    of page ids; ``positions``/``tokens``: ``(B,)``. The token's K/V go in
    place into page ``block_tables[i, pos // block_size]``, slot ``pos %
    block_size``; attention reads the gathered pages up to ``pos``. Returns
    ``(logits, pool_k, pool_v)`` with the pools given: fixed shapes, however
    ragged the generation lengths."""
    B, nb = block_tables.shape
    T = nb * block_size
    U = params["embed"].shape[1]
    tables = block_tables.long()
    pos = positions.long()
    blk = tables.gather(1, (pos // block_size)[:, None])[:, 0]
    slot = pos % block_size
    smask = torch.arange(T, device=pool_k.device)[None, :] <= pos[:, None]

    def write(li, k, v):
        layer = torch.full_like(blk, li)
        pool_k.index_put_((blk, layer, slot), k)
        pool_v.index_put_((blk, layer, slot), v)

    def read(li):
        keys = pool_k[tables, li].reshape(B, T, U)
        vals = pool_v[tables, li].reshape(B, T, U)
        return keys, vals, smask

    logits = _step_body(params, tokens, positions, cross_kv, mem_mask, read,
                        write)
    return logits, pool_k, pool_v


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _as_tensor(x, device, dtype):
    if x is None:
        return None
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(onp.ascontiguousarray(onp.asarray(x)))
    return x.to(device=device, dtype=dtype)


def _beam_loop(step_logits, B, K, V, max_length, bos_id, eos_id, alpha,
               device, on_reorder=None):
    """The beam bookkeeping both searches share (JAX counterpart:
    ``nmt.py:420-450``, ``:497-522``): ``step_logits(t, seqs)`` gives the
    ``(B*K, V)`` logits of step ``t``; ``on_reorder(bidx)`` adopts the
    parents' cache rows. Returns ``(sequences (B, K, max_length), scores
    (B, K))``, length-normalised by the GNMT rule and sorted best first."""
    BK = B * K
    seqs = torch.full((BK, max_length + 1), eos_id, dtype=torch.int32,
                      device=device)
    seqs[:, 0] = bos_id
    scores = torch.tensor([0.0] + [-1e9] * (K - 1), dtype=torch.float32,
                          device=device).repeat(B)
    done = torch.zeros((BK,), dtype=torch.bool, device=device)
    eos_only = torch.full((V,), -1e9, dtype=torch.float32, device=device)
    eos_only[eos_id] = 0.0
    offsets = torch.arange(B, device=device)[:, None] * K
    for t in range(max_length):
        logp = torch.log_softmax(step_logits(t, seqs).float(), dim=-1)
        # finished beams only extend with eos at no cost
        logp = torch.where(done[:, None], eos_only[None], logp)
        cand = (scores[:, None] + logp).reshape(B, K * V)
        top_scores, top_idx = _top_k(cand, K)
        bidx = (top_idx // V + offsets).reshape(-1)
        tok = (top_idx % V).reshape(-1).to(torch.int32)
        seqs = seqs[bidx]
        seqs[:, t + 1] = tok
        if on_reorder is not None:
            on_reorder(bidx)
        done = done[bidx] | (tok == eos_id)
        scores = top_scores.reshape(-1)
    lengths = (seqs[:, 1:] != eos_id).to(torch.float32).sum(-1) + 1.0
    lp = ((5.0 + lengths) / 6.0) ** alpha
    final = (scores / lp).reshape(B, K)
    order = torch.argsort(-final, dim=-1, stable=True)
    seqs = seqs.reshape(B, K, -1).gather(
        1, order[:, :, None].expand(B, K, max_length + 1))
    return seqs[:, :, 1:], final.gather(1, order)


def _encode_for_search(model, src, src_valid_length, K):
    """Encode once; the memory and its bool key mask repeated ``K`` times
    per row (``jnp.repeat`` along axis 0)."""
    dev = model.tgt_embed.weight._tensor().device
    src = _as_tensor(src, dev, torch.int32)
    vl = _as_tensor(src_valid_length, dev, torch.float32)
    with autograd.predict_mode():
        memory, mask = model.encode(src, vl)
    mem = memory.repeat_interleave(K, dim=0)
    mmask = None if mask is None else mask.repeat_interleave(K, dim=0)
    return src.shape[0], mem, mmask, dev


@torch.no_grad()
def beam_search(model: NMTModel, src, src_valid_length=None,
                beam_size: int = 4, max_length: int = 32, bos_id: int = 1,
                eos_id: int = 2, alpha: float = 0.6):
    """Beam search on the incremental (KV-cached) decode path (JAX
    counterpart: ``nmt.py:370``): encodes once, computes every layer's
    cross-attention K/V once, then ``max_length`` :func:`nmt_step` calls;
    adopting a sibling beam's prefix gathers its cache rows. ``src`` and
    ``src_valid_length`` may be tensors, NDArrays or numpy arrays; they go
    to the model's device. Returns ``(sequences (B, beam, max_length)
    int32, scores (B, beam))`` as tensors there, BOS left out."""
    K = beam_size
    B, mem, mmask, dev = _encode_for_search(model, src, src_valid_length, K)
    params = incremental_decode_params(model)
    cross_kv = cross_attention_kv(params, mem)
    key_mask = None if mmask is None else mmask[:, 0, 0, :] > 0
    NL, U = len(params["layers"]), model._units
    cache = [torch.zeros((NL, B * K, max_length, U), dtype=cross_kv.dtype,
                         device=dev) for _ in range(2)]

    def step_logits(t, seqs):
        pos = torch.full((B * K,), t, dtype=torch.int32, device=dev)
        logits, _, _ = nmt_step(params, cache[0], cache[1], cross_kv,
                                key_mask, seqs[:, t], pos)
        return logits

    def reorder(bidx):
        cache[0], cache[1] = cache[0][:, bidx], cache[1][:, bidx]

    return _beam_loop(step_logits, B, K, model._tgt_vocab, max_length,
                      bos_id, eos_id, alpha, dev, reorder)


@torch.no_grad()
def beam_search_reference(model: NMTModel, src, src_valid_length=None,
                          beam_size: int = 4, max_length: int = 32,
                          bos_id: int = 1, eos_id: int = 2,
                          alpha: float = 0.6):
    """The beam search without a cache (JAX counterpart: ``nmt.py:453``,
    GluonNLP's ``BeamSearchSampler``): every step runs the whole decoder
    over the same fixed ``(B*beam, max_length)`` token buffer and reads
    column ``t`` (causal masking makes it depend on tokens <= t only), so
    each step is the flash forward at Lq = Lk = ``max_length`` (causal) and
    Lq = ``max_length`` against Lk = Ls (cross). The parity oracle of
    :func:`beam_search`; same arguments and returns."""
    K = beam_size
    B, mem, mmask, dev = _encode_for_search(model, src, src_valid_length, K)
    proj_w = model.proj_weight._tensor()
    proj_b = model.proj_bias._tensor()

    def step_logits(t, seqs):
        with autograd.predict_mode():
            out = model.decoder(model.tgt_embed(seqs[:, :max_length]), mem,
                                mmask)
        return F.FullyConnected(out, proj_w, proj_b, flatten=False)[:, t]

    return _beam_loop(step_logits, B, K, model._tgt_vocab, max_length,
                      bos_id, eos_id, alpha, dev)


# ---------------------------------------------------------------------------
# the machine-translation example's loop
# ---------------------------------------------------------------------------

BOS, EOS = 1, 2
#: the example's configuration in the JAX package's tier-1 test
MT_CONFIG = dict(task="copy", vocab=12, seq_len=5, batch_size=32, lr=2e-3,
                 beam_size=4, smooth_eps=0.1, seed=42)


def make_mt_batch(rng, batch_size, seq_len, vocab, task="copy"):
    """``(src, decoder input, label)`` of the synthetic copy/reverse task:
    the decoder input is BOS + the target, the label the target + EOS (the
    JAX package's ``examples/machine_translation.py:27``, unchanged)."""
    src = rng.randint(3, vocab, (batch_size, seq_len)).astype("int32")
    tgt_core = src[:, ::-1] if task == "reverse" else src
    tgt_in = onp.concatenate(
        [onp.full((batch_size, 1), BOS, "int32"), tgt_core], axis=1)
    label = onp.concatenate(
        [tgt_core, onp.full((batch_size, 1), EOS, "int32")], axis=1)
    return src, tgt_in, label


def mt_example(steps: int = 300, net: Optional[NMTModel] = None,
               ctx=None) -> dict:
    """The JAX package's ``examples/machine_translation.py`` loop
    (``:60-100``) at the configuration of its tier-1 test
    (``tests/test_examples.py:43-47``, :data:`MT_CONFIG`): ``NMTModel``
    (units 64, hidden 128, 2 layers, 4 heads, dropout 0) seeded through
    ``mx.random.seed`` and ``Xavier``, or ``net`` as given; Adam through
    ``gluon.Trainer``; label-smoothed targets as dense distributions into
    ``SoftmaxCrossEntropyLoss(sparse_label=False)``; ``autograd.record()``
    -> ``loss.backward()`` -> ``trainer.step``; then :func:`beam_search` on
    a held-out batch of 16 and the exact-match share of the best beam. Runs
    on ``ctx`` (default: the current context). Returns ``{"losses": [mean
    loss per step], "accuracy": exact-match share}``."""
    from .. import initializer, random
    from ..context import current_context
    from ..gluon import Trainer
    from ..gluon.loss import SoftmaxCrossEntropyLoss
    from ..ndarray import array

    c = MT_CONFIG
    task, vocab, seq_len = c["task"], c["vocab"], c["seq_len"]
    batch_size, smooth_eps = c["batch_size"], c["smooth_eps"]
    ctx = ctx or current_context()
    if net is None:
        random.seed(c["seed"])
        net = NMTModel(src_vocab=vocab, tgt_vocab=vocab, units=64,
                       hidden_size=128, num_layers=2, num_heads=4,
                       dropout=0.0, max_length=seq_len + 2)
        net.initialize(initializer.Xavier(), ctx=ctx)
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": c["lr"]})
    loss_fn = SoftmaxCrossEntropyLoss(sparse_label=False)
    rng = onp.random.RandomState(0)
    losses = []
    for _ in range(steps):
        src, tgt_in, label = make_mt_batch(rng, batch_size, seq_len, vocab,
                                           task)
        smoothed = onp.full((label.size, vocab), smooth_eps / vocab,
                            "float32")
        smoothed[onp.arange(label.size), label.reshape(-1)] += \
            1.0 - smooth_eps
        with autograd.record():
            logits = net(array(src, ctx=ctx), array(tgt_in, ctx=ctx))
            loss = loss_fn(logits.reshape((-1, vocab)),
                           array(smoothed, ctx=ctx))
        loss.backward()
        trainer.step(batch_size)
        losses.append(loss._data.detach().mean())
    src, _, label = make_mt_batch(rng, 16, seq_len, vocab, task)
    seqs, _ = beam_search(net, src, beam_size=c["beam_size"],
                          max_length=seq_len + 1, bos_id=BOS, eos_id=EOS)
    best = seqs[:, 0, :seq_len].cpu().numpy()
    return {"losses": [float(x) for x in losses],
            "accuracy": float((best == label[:, :seq_len]).all(axis=1)
                              .mean())}


def transformer_sharding_rules(extra=()):
    """The JAX package's ``tp`` rules of the NMT Transformer for
    ``parallel.ShardedTrainer`` (``models/nmt.py:192``)."""
    from ..parallel.sharding import P, ShardingRules
    return ShardingRules(list(extra) + [
        (r".*(qkv|query|kv)_weight", P("tp", None)),
        (r".*(qkv|query|kv)_bias", P("tp")),
        (r".*(proj|ffn2)_weight", P(None, "tp")),
        (r".*ffn1_weight", P("tp", None)),
        (r".*ffn1_bias", P("tp")),
        (r".*embed_weight", P("tp", None)),
    ])
