"""Expert parallelism over the ``ep`` mesh axis: switch-style MoE dispatch.

Counterpart: the JAX package's ``parallel/moe.py`` (``:31-110``). Top-1
(switch) routing with a fixed capacity per expert, so every shape is
static: each token goes to the expert of its largest router probability
(ties to the lower index, as XLA's ``argmax``), at its position among
the tokens routed there before it (a cumulative sum); a token past its
expert's capacity is dropped and contributes zero, so the residual around
the layer passes it through unchanged. Between the ranks of ``ep`` the
tokens travel in one differentiable :func:`~.collectives.all_to_all`
each way, and each rank runs its own experts as one batched product
over every source rank's tokens.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import collectives
from .mesh import Mesh, current_active_mesh, default_mesh

__all__ = ["moe_dispatch", "moe_ffn", "moe_ffn_sharded", "MoEFFN"]


def moe_dispatch(x: torch.Tensor, gate_logits: torch.Tensor,
                 n_experts: int, capacity: int):
    """Route each token to its top-1 expert within a fixed capacity.

    ``x`` (T, C); ``gate_logits`` (T, E). Returns ``(dispatched (E, cap,
    C), combine (T,), eidx (T,), pos (T,), keep (T,))``: ``combine`` is
    the router probability of the chosen expert, and (``eidx``, ``pos``,
    ``keep``) place each kept token in the dispatch buffer, into which the
    kept tokens are scatter-added."""
    T, C = x.shape
    probs = torch.softmax(gate_logits, dim=-1)
    eidx = torch.argmax(probs, dim=-1)
    combine = probs.gather(1, eidx[:, None])[:, 0]
    # one-hot by comparison: ``one_hot`` checks its input's range on the
    # host, which a CUDA graph capture refuses
    onehot = (eidx[:, None] == torch.arange(
        n_experts, device=eidx.device)).int()
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = pos.gather(1, eidx[:, None])[:, 0]
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, capacity - 1).long()
    contrib = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    dispatched = torch.zeros((n_experts, capacity, C), dtype=x.dtype,
                             device=x.device).index_put(
        (eidx, safe_pos), contrib, accumulate=True)
    return dispatched, combine, eidx, pos, keep


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: float32 for the 16-bit types (JAX
    ``preferred_element_type=jnp.float32``), else its own."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _experts(d, w1, b1, w2, b2, eq_in: str, eq_out: str):
    """The experts' FFN on dispatched tokens, accumulated in at least
    float32."""
    h = torch.einsum(eq_in, _acc(d), _acc(w1))
    lead = h.dim() - 3
    h = torch.relu(h + _acc(b1)[(None,) * lead + (slice(None), None)])
    y = torch.einsum(eq_out, _acc(h.to(d.dtype)), _acc(w2)).to(d.dtype)
    return y + b2[(None,) * lead + (slice(None), None)]


def _combine(y, eidx, pos, keep, combine):
    """Each kept token's expert output, scaled by its router probability;
    zero for a dropped token."""
    out = y[eidx, torch.where(keep, pos, 0).long()]
    out = torch.where(keep[:, None], out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    return out * combine[:, None].to(out.dtype)


def moe_ffn(params, x: torch.Tensor, gate_logits: torch.Tensor,
            capacity: int, axis: str = "ep",
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Expert-parallel switch FFN on this rank's tokens and experts.

    ``params``: dict with ``w1 (E_local, H, C)``, ``b1 (E_local, H)``,
    ``w2 (E_local, C, H)``, ``b2 (E_local, C)``, this rank's expert block.
    ``x`` (T_local, C) this rank's tokens; ``gate_logits`` (T_local,
    E_global). Returns (T_local, C)."""
    m = mesh if mesh is not None else (current_active_mesh()
                                       or default_mesh())
    ep = m.axis_size(axis)
    e_local = params["w1"].shape[0]
    E = ep * e_local
    T, C = x.shape
    dispatched, combine, eidx, pos, keep = moe_dispatch(
        x, gate_logits, E, capacity)
    # (E, cap, C) = (ep, e_local, cap, C): rank j receives, from every
    # rank, the tokens bound for its experts
    d = dispatched.reshape(ep, e_local, capacity, C)
    d = collectives.all_to_all(d, axis, 0, 0, mesh=m)
    # d: (ep_src, e_local, cap, C): the local experts on every source
    y = _experts(d, params["w1"], params["b1"], params["w2"], params["b2"],
                 "sekc,ehc->sekh", "sekh,ech->sekc")
    # the results back to their source ranks
    y = collectives.all_to_all(y, axis, 0, 0, mesh=m)
    return _combine(y.reshape(E, capacity, C), eidx, pos, keep, combine)


def moe_ffn_sharded(mesh: Mesh, params, x: torch.Tensor,
                    gate_logits: torch.Tensor, capacity: int,
                    axis: str = "ep") -> torch.Tensor:
    """Host-level entry: ``params`` leaves carry a global leading expert
    axis, of which this rank takes its block over ``axis``; the tokens
    shard over ``axis`` too (each expert shard is also a token shard: the
    standard MoE data layout). Returns the global (T, C) output on every
    rank (JAX counterpart: ``:88-101``)."""
    local = {k: collectives.replicated_slice(v, axis, 0, mesh=mesh)
             for k, v in params.items()}
    xs = collectives.replicated_slice(x, axis, 0, mesh=mesh)
    gs = collectives.replicated_slice(gate_logits, axis, 0, mesh=mesh)
    out = moe_ffn(local, xs, gs, capacity, axis=axis, mesh=mesh)
    return collectives.replicated_gather(out, axis, 0, mesh=mesh)


class MoEFFN:
    """Gluon-facing switch-FFN layer (:class:`~.moe_block.MoEFFNBlock`,
    built lazily: gluon is not imported with this package)."""

    def __new__(cls, *args, **kwargs):
        from .moe_block import MoEFFNBlock
        return MoEFFNBlock(*args, **kwargs)
