"""Pipeline parallelism over the ``pp`` mesh axis.

Counterpart: the JAX package's ``parallel/pipeline.py`` (``:33-107``): the
GPipe schedule, ``n_micro + n_stages - 1`` ticks. Stage parameters carry a
leading stage axis sharded over ``pp``; each rank applies its stage, and
activations hop to the next stage with the differentiable
:func:`~.collectives.ppermute`. As there, stage 0 ingests microbatch ``t``
at tick ``t`` and the last stage finishes microbatch ``t - (S - 1)``.

Where JAX runs ``lax.scan`` over the ticks and every stage computes at
every tick (its idle ticks on values never written), a rank here computes
only on its ``n_micro`` live ticks (stage ``s`` at ticks ``s .. s + M -
1``), and each tick's hop carries only the live pairs: the same values
reach the result. Autograd through the ticks is the backward pipeline, as
``lax.scan``'s transpose is in JAX: the cotangents hop back along the
inverse permutation. Each rank's backward meets its hops in descending
tick order (each hop's received activation feeds the next tick's stage),
so the ranks exchange the cotangents in one order. A hop whose received
value no stage reads (stage 0 receives nothing) is tied into the result
with a zero cotangent, so that its backward still runs and answers the
peer that sends to it.

The result is the last stage's buffer, broadcast over ``pp`` (JAX: a
``psum`` of the last stage's buffer, ``:76-77``). The computation after it
is replicated over ``pp``, so every rank holds the same cotangent: the
broadcast's backward hands the last stage that cotangent unchanged (an
all-reduce would multiply the stage gradients by ``pp``). The input is
replicated over ``pp`` too, and only stage 0 reads it: its backward
broadcasts stage 0's cotangent, so every rank holds the input's gradient.

Bubble fraction is the GPipe ``(S-1)/(M+S-1)``; pick ``n_micro >= 4·S``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as tdist

from ..base import MXNetError
from . import collectives
from .mesh import Mesh, current_active_mesh, default_mesh

__all__ = ["pipeline_apply", "pipeline_sharded"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _Replicated(torch.autograd.Function):
    """A value alike on every rank of the axis, read by one of them
    (module docstring). ``src_grad=True`` (the input, read by stage 0):
    the forward is the value itself, the backward broadcasts the
    reader's cotangent. ``src_grad=False`` (the result, the last stage's
    buffer): the forward broadcasts the reader's value, the backward
    keeps the cotangent at the reader and gives zeros elsewhere. ``tied``
    are the hops' unread outputs (module docstring): zero cotangents."""

    @staticmethod
    def forward(ctx, x, group, root_rank, is_root, src_grad, *tied):
        ctx.args = (group, root_rank, is_root, src_grad)
        ctx.tied = [t.shape for t in tied]
        out = x.detach().clone().contiguous()
        if not src_grad:
            tdist.broadcast(out, src=root_rank, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        group, root_rank, is_root, src_grad = ctx.args
        if src_grad:
            g = g.detach().clone().contiguous()
            tdist.broadcast(g, src=root_rank, group=group)
        elif not is_root:
            g = torch.zeros_like(g)
        zeros = tuple(g.new_zeros(s) for s in ctx.tied)
        return (g, None, None, None, None) + zeros


def _replicated(x, mesh: Mesh, axis: str, root: int, src_grad: bool,
                tied=()):
    return _Replicated.apply(x, mesh.group(axis), mesh.axis_ranks(axis)[root],
                             mesh.axis_index(axis) == root, src_grad, *tied)


def pipeline_apply(stage_params, x: torch.Tensor, stage_fn: Callable,
                   axis: str = "pp", n_micro: Optional[int] = None,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Microbatched pipeline forward on this rank's stage.

    ``stage_params``: a pytree (dicts, lists, tuples) whose leaves have a
    leading stage axis of local size 1 (this rank's block of a
    ``(n_stages, ...)`` stack over ``axis``). ``x``: (n_micro, mb, ...)
    microbatches, alike on every rank of ``axis``. ``stage_fn(params,
    xmb) -> ymb``: one stage on one microbatch (its output has its input's
    shape: the hops carry one fixed-shape buffer). Returns (n_micro, mb,
    ...) outputs, alike on every rank of ``axis``. ``mesh``: the active
    mesh, else the default one."""
    m = mesh if mesh is not None else (current_active_mesh()
                                       or default_mesh())
    S, idx = m.axis_size(axis), m.axis_index(axis)
    local = _tree_map(lambda p: p[0], stage_params)
    M = x.shape[0] if n_micro is None else int(n_micro)
    if M > x.shape[0]:
        raise MXNetError(f"n_micro {M} exceeds the {x.shape[0]} "
                         "microbatches of x")
    leaves = []
    _tree_map(leaves.append, stage_params)
    # the schedule is on the tape when anything it reads requires grad
    grad = torch.is_grad_enabled() and (x.requires_grad or any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in leaves))
    ys, tied, buf = [None] * M, [], None
    if S > 1 and x.requires_grad and grad:
        x = _replicated(x, m, axis, 0, src_grad=True)
        if idx != 0:
            # no stage of this rank reads x: its backward runs through the
            # tie, after the hops' (the tape runs newer nodes first)
            tied.append(x)
    for t in range(M + S - 1):
        y = None
        if 0 <= t - idx < M:
            y = stage_fn(local, x[t] if idx == 0 else buf)
            if idx == S - 1:
                ys[t - idx] = y
        # the hops of this tick: stage s to s + 1 while s is live
        pairs = [(s, s + 1) for s in range(S - 1) if 0 <= t - s < M]
        sends = (idx, idx + 1) in pairs
        recvs = (idx - 1, idx) in pairs
        if not (sends or recvs):
            continue
        if not sends:
            # a receive only: a zero leaf keeps the hop on the tape, so
            # that its backward sends the cotangent back
            y = torch.zeros_like(x[0]).requires_grad_(grad)
        got = collectives.ppermute(y, axis, pairs, mesh=m)
        if recvs:
            buf = got
        elif grad and got.requires_grad:
            tied.append(got)
    out = (torch.stack(ys) if idx == S - 1
           else torch.zeros((M,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device))
    if S == 1:
        return out
    return _replicated(out, m, axis, S - 1, src_grad=False, tied=tied)


def pipeline_sharded(mesh: Mesh, stage_params, x: torch.Tensor,
                     stage_fn: Callable, n_micro: int, axis: str = "pp",
                     batch_axis: Optional[str] = None) -> torch.Tensor:
    """Host-level entry: ``stage_params`` leaves are global ``(n_stages,
    ...)`` stacks, of which this rank takes its block over ``axis``; ``x``
    is a global (batch, ...) array, reshaped to (n_micro, batch/n_micro,
    ...). ``batch_axis`` (e.g. ``"dp"``) also shards the rows inside each
    microbatch, giving dp×pp from one entry point. Returns the global
    (batch, ...) output on every rank (JAX counterpart: ``:82-107``).
    Differentiable: a parameter's gradient is its global one on every
    rank."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"n_micro {n_micro}")
    xm = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    params = _tree_map(
        lambda p: collectives.replicated_slice(p, axis, 0, mesh=mesh),
        stage_params)
    if batch_axis is not None:
        xm = collectives.replicated_slice(xm, batch_axis, 1, mesh=mesh)
    out = pipeline_apply(params, xm, stage_fn, axis=axis, mesh=mesh)
    if batch_axis is not None:
        out = collectives.replicated_gather(out, batch_axis, 1, mesh=mesh)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))

