"""Ring attention: sequence parallelism over the ``sp`` mesh axis.

Counterpart: the JAX package's ``parallel/ring.py``. The sequence is
sharded over ``sp``; each rank holds its query block and, hop by hop, every
rank's K/V block, which travels round the ring by the differentiable
:func:`~.collectives.ppermute` together with its key mask (K and V stacked
into one tensor: the hops' backward sends then form one chain, which
every rank runs in the same order). Each hop's block
attention returns its output and log-sum-exp, and a running softmax merge
in float32 folds the hops together, so no rank holds the L x L scores.

Per hop, :func:`_hop_attn` takes the flash kernels through
:func:`~..ops.cuda.flash_attention.flash_block` (forward kernel; its
backward on the dK/dV and dQ kernels with the lse cotangent folded into
``delta``) when they take the shapes, else the plain einsum path with
explicit positions; ``MXTPU_RING_IMPL=xla`` forces the plain path. A block
that lies wholly after the queries under ``causal`` (mode 2) gives zeros
and an lse of -1e30 with no launch. A query row with no live key in the
whole sequence gives zeros (the JAX ring's ``:158-160``; the
whole-sequence kernel gives such a row the mean of V).

Shapes are ``[batch, heads, seq, head_dim]``; key masks are (B, L).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..util import getenv
from . import collectives
from .mesh import Mesh

__all__ = ["ring_attention", "ring_attention_sharded"]

_NEG_INF = -1e30


def _hop_flash_ok(q, k) -> bool:
    """Can this hop's block attention run the flash kernels (JAX
    counterpart: ``ring.py:35``)?"""
    if getenv("MXTPU_RING_IMPL") == "xla":
        return False
    from ..ops.cuda.flash_attention import _kernel_takes
    return _kernel_takes(q, k, k)


class _MaskedHop(torch.autograd.Function):
    """A block wholly after the queries (mode 2): zeros and an lse of
    -1e30, with no launch. Its backward gives the block zero gradients, so
    that the block's ``ppermute`` runs its backward on every rank of the
    ring, in the same order."""

    @staticmethod
    def forward(ctx, q, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        B, H, Lq, D = q.shape
        return (torch.zeros((B, H, Lq, D), dtype=torch.float32,
                            device=q.device),
                torch.full((B, H, Lq), _NEG_INF, dtype=torch.float32,
                           device=q.device))

    @staticmethod
    def backward(ctx, do, dlse):
        shape, dtype, device = ctx.kv
        return None, torch.zeros(shape, dtype=dtype, device=device)


def _hop_attn(q, kv, key_mask, causal_mode: int, q_off: int, k_off: int,
              scale: float):
    """One K/V block's attention: ``(o fp32, lse fp32)``; ``kv`` is the
    block's K and V stacked, (2, B, H, Lk, D). ``causal_mode`` 0 = full
    block, 1 = causal diagonal (same-rank positions), 2 = wholly masked
    (JAX counterpart: ``ring.py:48-96``)."""
    if causal_mode == 2:
        return _MaskedHop.apply(q, kv)
    # dense blocks, so that only dtype and head size can keep a hop on
    # the card off the kernels
    q, k, v = q.contiguous(), kv[0].contiguous(), kv[1].contiguous()
    Lq, Lk = q.shape[2], k.shape[2]
    if _hop_flash_ok(q, k):
        from ..ops.cuda.flash_attention import flash_block
        o, lse = flash_block(q, k, v, key_mask, causal_mode == 1, scale)
        # a row with no live key in this block: lse ~ -1e30, merge weight 0
        return o.float(), lse
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s.masked_fill(~key_mask.to(torch.bool)[:, None, None, :],
                          _NEG_INF)
    if causal_mode == 1:
        qpos = q_off + torch.arange(Lq, device=q.device)[:, None]
        kpos = k_off + torch.arange(Lk, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, _NEG_INF)
    m = s.amax(dim=-1)
    # dead entries keep exactly 0 weight, also in rows that are all dead
    p = torch.where(s > _NEG_INF * 0.5, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    o = o / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full((), _NEG_INF, device=q.device))
    return o, lse


def _merge(o, lse, o_i, lse_i):
    """Fold a hop's normalised partial into the running result (the
    log-sum-exp merge; JAX counterpart: ``ring.py:99``)."""
    lse_new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(torch.clamp(lse - lse_new, max=0.0))
    w_new = torch.exp(torch.clamp(lse_i - lse_new, max=0.0))
    return o * w_old[..., None] + o_i * w_new[..., None], lse_new


def _finish(o, lse, dtype):
    """Rows with no live key anywhere (lse at the -1e30 floor) -> zeros,
    cast to the queries' dtype."""
    o = torch.where((lse > _NEG_INF * 0.5)[..., None], o,
                    torch.zeros((), device=o.device))
    return o.to(dtype)


def hop_mode(src: int, idx: int, causal: bool) -> int:
    """The block mode of rank ``idx`` holding rank ``src``'s block: equal
    shards compare whole blocks by rank."""
    if not causal:
        return 0
    return 1 if src == idx else (0 if src < idx else 2)


def ring_attention(q, k, v, key_mask=None, axis: str = "sp",
                   causal: bool = False, scale: Optional[float] = None,
                   mesh: Optional[Mesh] = None):
    """Attention over sequence shards: ``q/k/v`` are this rank's
    ``[B, H, L_local, D]`` blocks of the sequence, ``key_mask`` its (B,
    L_local) block, which rides the ring with its K/V (JAX counterpart:
    ``ring.py:108``). Differentiable in q, k and v."""
    m = collectives._mesh(mesh)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    n = m.axis_size(axis)
    idx = m.axis_index(axis)
    B, H, lq, D = q.shape
    o = torch.zeros((B, H, lq, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, lq), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    mask = key_mask if key_mask is not None else torch.ones(
        (B, k.shape[2]), dtype=torch.int32, device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    # K and V travel as one tensor: one ppermute a hop, whose backwards
    # form one chain, so every rank runs them in the same order
    kv_cur, m_cur = torch.stack([k, v]), mask
    for i in range(n):
        src = (idx - i) % n          # whose block this rank holds now
        o_i, lse_i = _hop_attn(q, kv_cur, m_cur, hop_mode(src, idx, causal),
                               idx * lq, src * lq, scale)
        o, lse = _merge(o, lse, o_i, lse_i)
        if i < n - 1:
            kv_cur = collectives.ppermute(kv_cur, axis, perm, mesh=m)
            m_cur = collectives.ppermute(m_cur, axis, perm, mesh=m)
    return _finish(o, lse, q.dtype)


def ring_attention_sharded(mesh: Mesh, q, k, v, key_mask=None,
                           causal: bool = False,
                           scale: Optional[float] = None, axis: str = "sp"):
    """Host-level entry: global ``q/k/v`` ``[B, H, L, D]`` that every rank
    holds alike; this rank takes its block (batch over ``dp``, heads over
    ``tp``, sequence over ``axis``), runs :func:`ring_attention`, and the
    blocks are gathered back into the global output, differentiable in
    the global inputs (JAX counterpart: ``ring.py:151``)."""
    spec = (("dp", 0), ("tp", 1), (axis, 2))

    def local(x, dims):
        for a, d in dims:
            if d < x.dim():
                x = collectives.replicated_slice(x, a, d, mesh=mesh)
        return x

    ql, kl, vl = (local(x, spec) for x in (q, k, v))
    ml = None if key_mask is None else local(
        torch.as_tensor(key_mask, device=q.device), (("dp", 0), (axis, 1)))
    o = ring_attention(ql, kl, vl, ml, axis=axis, causal=causal,
                       scale=scale, mesh=mesh)
    for a, d in reversed(spec):
        o = collectives.replicated_gather(o, a, d, mesh=mesh)
    return o
