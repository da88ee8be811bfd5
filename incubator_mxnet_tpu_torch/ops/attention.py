"""Scaled-dot-product attention with the JAX package's routing.

Counterpart: the JAX package's ``ops/attention.py`` (``dot_product_attention``
at ``:98-162``, ``_mask_bias`` at ``:40``). ``impl="auto"`` takes the flash
kernel when :func:`~.cuda.flash_attention.flash_supported` holds: on the card
that is the Hopper kernel, on the CPU its plain version. ``impl="xla"`` is
the plain scores/softmax path (XLA's fused jnp graph in the JAX package).
Under an active mesh whose ``sp`` axis has more than one rank, self-attention
lowers to ring attention (:func:`_maybe_ring`).

The four ``interleaved_matmul_*`` ops (JAX ``:164-234``) are MXNet's
reference-layout attention products: self-attention reads the fused QKV
projection ``(seq, batch, heads * 3 * head_dim)``, interleaved per head as
``[q, k, v]``; the ``qk`` products give ``(batch * heads, Lq, Lk)`` scores
with q pre-scaled by ``head_dim ** -0.5``, and the ``valatt`` products
``(Lq, batch, heads * head_dim)``. The JAX package leaves them to XLA; here
they are ``torch.matmul`` (cuBLAS on the card), accumulating in float32
(``preferred_element_type``) and cast back to the input's dtype.
"""
from __future__ import annotations

import torch

from ..util import getenv
from .cuda.flash_attention import flash_attention, flash_supported

__all__ = ["dot_product_attention", "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt", "interleaved_matmul_encdec_qk",
           "interleaved_matmul_encdec_valatt", "INTERLEAVED"]

#: the reference-layout ops, registered by ``ndarray/op.py``
INTERLEAVED = ("interleaved_matmul_selfatt_qk",
               "interleaved_matmul_selfatt_valatt",
               "interleaved_matmul_encdec_qk",
               "interleaved_matmul_encdec_valatt")

_NEG = -1e30


def _mask_bias(mask, dtype):
    """0/1 mask -> additive bias (0 keep, -1e30 drop) (JAX counterpart:
    ``ops/attention.py:40``)."""
    keep = mask.to(torch.bool)
    return torch.where(keep, torch.zeros((), dtype=dtype, device=mask.device),
                       torch.full((), _NEG, dtype=dtype, device=mask.device))


def _maybe_ring(query, key, value, mask, causal, scale):
    """Ring attention over ``sp`` when the active mesh shards the sequence
    (JAX counterpart: ``ops/attention.py:45-95``): self-attention (Lq ==
    Lk, divisible by ``sp``), batch and heads divisible by ``dp`` and
    ``tp``, and a key-padding mask or none; else None.

    The rest of the model is replicated over ``sp``: every rank of the axis
    holds the whole sequence. ``q``/``k``/``v`` (and the key mask) are cut
    to this rank's sequence block with :func:`~..parallel.collectives.
    replicated_slice` (the backward gathers the blocks' gradients), and the
    ring's output is gathered back with ``replicated_gather`` (the
    backward keeps this rank's slice), which gives the numbers of the JAX
    package's sequence-sharded step."""
    from ..parallel.mesh import current_active_mesh
    mesh = current_active_mesh()
    if mesh is None or mesh.shape.get("sp", 1) <= 1:
        return None
    if query.ndim != 4 or key.shape != value.shape:
        return None
    B, H, Lq, D = query.shape
    Lk = key.shape[2]
    sp = mesh.shape["sp"]
    if Lq != Lk or Lq % sp:
        return None
    if B % max(mesh.shape.get("dp", 1), 1) \
            or H % max(mesh.shape.get("tp", 1), 1):
        return None
    key_mask = None
    if mask is not None:
        from .cuda.flash_attention import _as_key_mask
        key_mask = _as_key_mask(mask, B, H, Lq, Lk)
        if key_mask is None or key_mask.shape[1] % sp:
            return None                 # dense masks stay on the local path
    from ..parallel import collectives
    from ..parallel.ring import ring_attention

    def local(x, dim):
        return collectives.replicated_slice(x, "sp", dim, mesh=mesh)

    ql, kl, vl = (local(x.contiguous(), 2) for x in (query, key, value))
    ml = None if key_mask is None else local(key_mask.contiguous(), 1)
    o = ring_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(), ml,
                       axis="sp", causal=causal, scale=scale, mesh=mesh)
    return collectives.replicated_gather(o, "sp", 2, mesh=mesh)


def dot_product_attention(query, key, value, mask=None, causal=False,
                          scale=None, impl="auto", window=None):
    """Fused scaled-dot-product attention over ``query (B, H, Lq, D)`` and
    ``key/value (B, H, Lk, D)``; ``mask`` broadcastable to (B, H, Lq, Lk),
    1 = attend. ``impl``: "auto" | "xla" | "flash" (env override
    ``MXTPU_ATTN_IMPL``). ``window`` (with ``causal=True``): attend to the
    ``window`` most recent keys only. JAX counterpart:
    ``ops/attention.py:98``."""
    impl = getenv("MXTPU_ATTN_IMPL") or impl
    scale = (query.shape[-1] ** -0.5) if scale is None else scale
    if window is not None:
        window = int(window)
        if not causal:
            raise ValueError("window= requires causal=True")
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        if impl == "ring":
            raise ValueError(
                "impl='ring' does not support window= (the band does not "
                "decompose over ring hops); use impl='auto'/'flash'")
    if impl in ("auto", "ring") and window is None:
        ring_out = _maybe_ring(query, key, value, mask, causal, scale)
        if ring_out is not None:
            return ring_out
    if impl == "flash" or (impl == "auto"
                           and flash_supported(query, key, value, mask)):
        return flash_attention(query, key, value, mask=mask, causal=causal,
                               scale=scale, window=window)
    s = torch.matmul(query.float(), key.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s + _mask_bias(mask, torch.float32)
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        ones = torch.ones((lq, lk), dtype=torch.bool, device=s.device)
        cm = torch.tril(ones, diagonal=lk - lq)
        if window is not None:
            cm = cm & torch.triu(ones, diagonal=lk - lq - window + 1)
        s = s.masked_fill(~cm, _NEG)
    p = torch.softmax(s, dim=-1).to(query.dtype)
    return torch.matmul(p.float(), value.float()).to(query.dtype)


# ---------------------------------------------------------------------------
# reference-layout interleaved ops (module docstring)
# ---------------------------------------------------------------------------

def _heads_first(x, L, B, heads, d):
    """(L, B, heads, d) slice -> (B, heads, L, d)."""
    return x.reshape(L, B, heads, d).permute(1, 2, 0, 3)


def _split(packed, heads, n):
    """``(L, B, heads * n * d)`` interleaved per head -> ``n`` tensors of
    ``(B, heads, L, d)`` and ``d``."""
    L, B, C = packed.shape
    d = C // (n * heads)
    x = packed.reshape(L, B, heads, n, d)
    return [x[:, :, :, i, :].permute(1, 2, 0, 3) for i in range(n)], d


def _scores(q, k, d, dtype):
    s = torch.matmul((q * (d ** -0.5)).float(), k.float().transpose(-1, -2))
    B, H, Lq, Lk = s.shape
    return s.to(dtype).reshape(B * H, Lq, Lk)


def _weighted(att, v, Lq, dtype):
    B, H, Lk, d = v.shape
    out = torch.matmul(att.reshape(B, H, Lq, Lk).float(), v.float())
    return out.permute(2, 0, 1, 3).reshape(Lq, B, H * d).to(dtype)


def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1, **_):
    """Scaled ``q k^T`` of the packed QKV projection: ``(B * heads, L,
    L)`` (JAX counterpart: ``ops/attention.py:184``)."""
    (q, k, _v), d = _split(queries_keys_values, int(heads), 3)
    return _scores(q, k, d, queries_keys_values.dtype)


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1, **_):
    """``attention @ v`` of the packed QKV projection: ``(L, B, heads *
    d)`` (JAX counterpart: ``ops/attention.py:193``)."""
    (_q, _k, v), _ = _split(queries_keys_values, int(heads), 3)
    return _weighted(attention, v, v.shape[2], queries_keys_values.dtype)


def interleaved_matmul_encdec_qk(queries, keys_values, heads=1, **_):
    """Scaled ``q k^T`` of decoder queries ``(Lq, B, heads * d)`` over the
    packed encoder KV projection ``(Lk, B, heads * 2 * d)``: ``(B * heads,
    Lq, Lk)`` (JAX counterpart: ``ops/attention.py:214``)."""
    heads = int(heads)
    Lq, B, C = queries.shape
    d = C // heads
    q = _heads_first(queries, Lq, B, heads, d)
    (k, _v), _ = _split(keys_values, heads, 2)
    return _scores(q, k, d, queries.dtype)


def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1, **_):
    """``attention @ v`` over the packed encoder KV projection: ``(Lq, B,
    heads * d)`` (JAX counterpart: ``ops/attention.py:226``)."""
    (_k, v), _ = _split(keys_values, int(heads), 2)
    return _weighted(attention, v, attention.shape[1], keys_values.dtype)
