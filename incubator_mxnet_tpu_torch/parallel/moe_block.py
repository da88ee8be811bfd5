"""Gluon block wrapping the expert-parallel switch FFN (see moe.py).

Counterpart: the JAX package's ``parallel/moe_block.py`` (``:12-89``).
"""
from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from . import collectives
from .mesh import current_active_mesh
from .moe import _acc, _combine, _experts, moe_dispatch, moe_ffn

__all__ = ["MoEFFNBlock"]

_EXPERTS = ("w1", "b1", "w2", "b2")


class MoEFFNBlock(HybridBlock):
    """Switch-transformer FFN: router -> top-1 expert -> combine.

    Parameters, under the JAX names: ``router`` (E, C), ``w1`` (E, H, C),
    ``b1`` (E, H), ``w2`` (E, C, H), ``b2`` (E, C). The experts' carry a
    leading expert axis: shard it over ``ep`` with a rule such as
    ``(r".*(w1|w2|b1|b2)", P("ep"))``. Under an active mesh whose ``ep``
    divides the experts and the tokens (a ``parallel.ShardedTrainer``
    step), each rank takes its ``T/ep`` tokens and its expert block (the
    trainer hands the block over ungathered: the experts' ``local_axis``
    is ``ep``), runs the two exchanges of :func:`~.moe.moe_ffn`, and the
    output is put back together by
    :func:`~.collectives.replicated_gather`, whose backward keeps this
    rank's rows. Otherwise every expert runs here, at the capacity
    ``min(T, max(1, int(cf * T / E)))`` (under ``ep``, ``max(1, int(cf *
    (T / ep) / E))`` per rank)."""

    def __init__(self, num_experts: int, hidden: int, units: int,
                 capacity_factor: float = 1.25, **kw):
        super().__init__(**kw)
        self._E = num_experts
        self._cap_f = capacity_factor
        with self.name_scope():
            self.router = self.params.get("router", shape=(num_experts, units),
                                          init="xavier")
            self.w1 = self.params.get("w1", shape=(num_experts, hidden, units),
                                      init="xavier")
            self.b1 = self.params.get("b1", shape=(num_experts, hidden),
                                      init="zeros")
            self.w2 = self.params.get("w2", shape=(num_experts, units, hidden),
                                      init="xavier")
            self.b2 = self.params.get("b2", shape=(num_experts, units),
                                      init="zeros")
        for name in _EXPERTS:
            getattr(self, name).local_axis = "ep"

    def hybrid_forward(self, F, x, router=None, w1=None, b1=None, w2=None,
                       b2=None):
        B, L, C = x.shape
        T, E = B * L, self._E
        tokens = x.reshape(T, C)
        gate = torch.matmul(_acc(tokens), _acc(router).t())
        mesh = current_active_mesh()
        ep = mesh.axis_size("ep") if mesh is not None else 1
        experts = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
        if ep > 1 and E % ep == 0 and T % ep == 0:
            cap = max(1, int(self._cap_f * (T // ep) / E))
            local = {k: (v if v.shape[0] == E // ep else
                         collectives.replicated_slice(v, "ep", 0, mesh=mesh))
                     for k, v in experts.items()}
            tok = collectives.replicated_slice(tokens, "ep", 0, mesh=mesh)
            g = collectives.replicated_slice(gate, "ep", 0, mesh=mesh)
            out = moe_ffn(local, tok, g, cap, axis="ep", mesh=mesh)
            out = collectives.replicated_gather(out, "ep", 0, mesh=mesh)
        else:
            if mesh is not None and w1.shape[0] != E:
                # a trainer handed over this rank's expert block, but the
                # tokens do not split over ep: every expert runs here
                experts = {k: collectives.replicated_gather(
                    v, "ep", 0, mesh=mesh) for k, v in experts.items()}
            cap = min(T, max(1, int(self._cap_f * T / E)))
            d, combine, eidx, pos, keep = moe_dispatch(tokens, gate, E, cap)
            y = _experts(d, experts["w1"], experts["b1"], experts["w2"],
                         experts["b2"], "ekc,ehc->ekh", "ekh,ech->ekc")
            out = _combine(y, eidx, pos, keep, combine)
        return out.reshape(B, L, C)
