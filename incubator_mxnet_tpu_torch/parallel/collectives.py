"""Collective verbs over mesh axes, on ``torch.distributed``.

Counterpart: the JAX package's ``parallel/collectives.py``. There each verb
is an XLA collective inside ``shard_map``; here every rank already runs the
whole program on its own block (one process per rank), so ``shard_map``
has no counterpart and a verb is called directly on this rank's tensor.
It runs over the process group of each named axis of the mesh (the active
mesh, else the default one): ``axis`` is an axis name, a tuple of names
(the axes in row-major order, as ``lax`` reads a tuple) or None, which
means every rank of the world (on one rank with a group, a real
collective over it). A size-1 axis issues nothing.

The verbs are functions of values, as in JAX: they return new tensors and
leave their input alone. Only :func:`ppermute` records a backward
(:class:`_PPermute`: the cotangent travels along the inverse permutation,
as JAX differentiates ``lax.ppermute``). The other verbs are not
differentiable: where a computation is replicated over an axis, use the
conjugate pairs :func:`replicated_gather` (gather forward, this rank's
slice backward) and :func:`replicated_slice` (slice forward, gather
backward). ``torch.distributed.nn.functional.all_gather`` reduce-scatters
in its backward, which multiplies the gradient of a replicated
computation by the axis size.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

from ..base import MXNetError
from .mesh import Mesh, current_active_mesh, default_mesh

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "ppermute", "all_to_all", "axis_index", "axis_size",
           "psum_scatter", "run_all_reduce", "replicated_gather",
           "replicated_slice"]

Axis = Union[str, Sequence[str], None]


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    if mesh is not None:
        return mesh
    return current_active_mesh() or default_mesh()


def _lines(axis: Axis, mesh: Optional[Mesh]) -> List[Tuple[object, List[int]]]:
    """``(group, ranks)`` of each axis that communicates, in the order
    given; the world's group for ``axis=None``."""
    if axis is None:
        from . import dist
        if not dist.initialized():
            return []
        return [(tdist.group.WORLD, list(range(tdist.get_world_size())))]
    m = _mesh(mesh)
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    out = []
    for name in names:
        if m.axis_size(name) > 1:
            out.append((m.group(name), m.axis_ranks(name)))
    return out


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "mean": "SUM"}


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum",
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``ncclAllReduce`` over the axes: ``sum``, ``mean``, ``max`` or
    ``min``."""
    if op not in _OPS:
        raise ValueError(f"unsupported reduce op {op!r}")
    out = x.detach().clone().contiguous()
    n = 1
    for group, ranks in _lines(axis, mesh):
        tdist.all_reduce(out, op=getattr(tdist.ReduceOp, _OPS[op]),
                         group=group)
        n *= len(ranks)
    if op == "mean" and n > 1:
        out = out / n
    return out


def _gather_one(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    tdist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather(x: torch.Tensor, axis: Axis, *, tiled: bool = True,
               gather_axis: int = 0,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's block concatenated along ``gather_axis`` in axis order
    (``tiled=False``: stacked on a new ``gather_axis``)."""
    out = x.detach()
    if not tiled:
        out = out.unsqueeze(gather_axis)
    lines = _lines(axis, mesh)
    for group, ranks in reversed(lines):
        # the inner axis first: the outer one then tiles whole inner runs
        out = _gather_one(out, group, len(ranks), gather_axis)
    return out if lines else out.clone()


def _chunk(x: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise MXNetError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {n} ranks")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


def reduce_scatter(x: torch.Tensor, axis: Axis, *, scatter_axis: int = 0,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum over the axes, of which this rank keeps its block along
    ``scatter_axis`` (``lax.psum_scatter(..., tiled=True)``)."""
    out = x.detach()
    lines = _lines(axis, mesh)
    if not lines:
        return out.clone()
    rs = getattr(tdist, "reduce_scatter_single", None) \
        or tdist.reduce_scatter_tensor
    for group, ranks in lines:
        n = len(ranks)
        src = out.movedim(scatter_axis, 0).contiguous()
        if src.shape[0] % n:
            raise MXNetError(f"dimension {scatter_axis} of size "
                             f"{src.shape[0]} does not split over {n} ranks")
        dst = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        rs(dst, src, group=group)
        out = dst.movedim(0, scatter_axis)
    return out.contiguous()


psum_scatter = reduce_scatter


def broadcast(x: torch.Tensor, axis: str, root: int = 0,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank of the axis takes the value of the rank at index
    ``root`` (``ncclBcast``)."""
    out = x.detach().clone().contiguous()
    for group, ranks in _lines(axis, mesh):
        tdist.broadcast(out, src=ranks[root], group=group)
    return out


def _ppermute(x: torch.Tensor, group, ranks: List[int], me: int,
              perm) -> torch.Tensor:
    out = torch.zeros_like(x)
    ops = []
    x = x.contiguous()
    for s, d in perm:
        if s == me and d == me:
            out = x.clone()
        elif s == me:
            ops.append(tdist.P2POp(tdist.isend, x, ranks[d], group))
        elif d == me:
            ops.append(tdist.P2POp(tdist.irecv, out, ranks[s], group))
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` with its derivative: the cotangent goes back along
    the inverse permutation."""

    @staticmethod
    def forward(ctx, x, group, ranks, me, perm):
        ctx.args = (group, ranks, me, [(d, s) for s, d in perm])
        return _ppermute(x, group, ranks, me, perm)

    @staticmethod
    def backward(ctx, g):
        group, ranks, me, inv = ctx.args
        return _ppermute(g, group, ranks, me, inv), None, None, None, None


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[tuple],
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Send this rank's ``x`` to the axis index ``d`` of each pair ``(s,
    d)`` with ``s`` its own; a rank that receives nothing gets zeros, as in
    JAX. Differentiable."""
    m = _mesh(mesh)
    perm = [(int(s), int(d)) for s, d in perm]
    if m.axis_size(axis) == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, m.group(axis), m.axis_ranks(axis),
                           m.axis_index(axis), perm)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Block ``j`` of ``x`` along ``split_axis`` goes to the axis's rank
    ``j``; what arrives from rank ``i`` is block ``i`` along
    ``concat_axis`` (``lax.all_to_all(..., tiled=True)``)."""
    lines = _lines(axis, mesh)
    if not lines:
        return x.detach().clone()
    group, ranks = lines[0]
    n = len(ranks)
    src = torch.stack(torch.chunk(x.detach(), n, dim=split_axis))
    if src.shape[0] != n or x.shape[split_axis] % n:
        raise MXNetError(f"dimension {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over {n}")
    src = src.contiguous()
    dst = torch.empty_like(src)
    tdist.all_to_all_single(dst, src, group=group)
    return torch.cat(list(dst.unbind(0)), dim=concat_axis)


def axis_index(axis: str, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).axis_index(axis)


def axis_size(axis: str, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).axis_size(axis)


def run_all_reduce(mesh: Mesh, x: torch.Tensor, axis: str = "dp",
                   op: str = "sum", spec=None) -> torch.Tensor:
    """All-reduce of this rank's block over ``axis`` (the JAX entry takes a
    global array and its ``spec``; here the block is the rank's own and
    ``spec`` is not needed)."""
    return all_reduce(x, axis, op, mesh=mesh)


# ---------------------------------------------------------------------------
# The conjugate pairs of a computation replicated over an axis
# ---------------------------------------------------------------------------
def _index(m: Mesh, names) -> Tuple[int, int]:
    """(row-major index, count) of this rank over the axes ``names``."""
    idx, n = 0, 1
    for name in names:
        size = m.axis_size(name)
        idx = idx * size + m.axis_index(name)
        n *= size
    return idx, n


def _names(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class _ReplicatedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names, dim, mesh):
        ctx.args = (names, dim, mesh)
        return all_gather(x, names, gather_axis=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        names, dim, mesh = ctx.args
        i, n = _index(mesh, names)
        return _chunk(g, n, i, dim).contiguous(), None, None, None


class _ReplicatedSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names, dim, mesh):
        ctx.args = (names, dim, mesh)
        i, n = _index(mesh, names)
        return _chunk(x.detach(), n, i, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        names, dim, mesh = ctx.args
        return (all_gather(g.contiguous(), names, gather_axis=dim,
                           mesh=mesh), None, None, None)


def replicated_gather(x: torch.Tensor, axis, dim: int = 0,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Gather the blocks of ``x`` over ``axis`` along ``dim`` for a
    computation that every rank of the axis then runs alike; the backward
    keeps this rank's slice of the (equal) cotangents, without a sum."""
    m = _mesh(mesh)
    names = tuple(a for a in _names(axis) if m.axis_size(a) > 1)
    if not names:
        return x
    return _ReplicatedGather.apply(x, names, dim, m)


def replicated_slice(x: torch.Tensor, axis, dim: int = 0,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's block along ``dim`` of an ``x`` every rank of ``axis``
    holds alike; the backward gathers the blocks' cotangents."""
    m = _mesh(mesh)
    names = tuple(a for a in _names(axis) if m.axis_size(a) > 1)
    if not names:
        return x
    return _ReplicatedSlice.apply(x, names, dim, m)
