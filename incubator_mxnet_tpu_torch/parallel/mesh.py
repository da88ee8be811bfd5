"""Named meshes of ranks.

Counterpart: the JAX package's ``parallel/mesh.py``. A JAX mesh is a grid
of devices under one process; here it is a grid of **ranks** (one process,
one device each; :mod:`.dist`) with the same named axes, in the JAX
canonical order ``dp, pp, ep, sp, tp`` (outermost first):

======  =======================================
``dp``  data parallelism (batch dim)
``tp``  tensor/model parallelism (hidden dims)
``pp``  pipeline parallelism (layer stages)
``sp``  sequence/context parallelism (ring attention)
``ep``  expert parallelism (MoE expert dim)
======  =======================================

Each axis of size > 1 has its own process group: the ranks that differ
only in that axis's coordinate. A size-1 axis is free, as in JAX: it makes
no group and its collectives issue nothing, so a one-rank mesh is exactly
the mesh-less path and needs no ``init_process_group``.

``torch.distributed.new_group`` must be entered by every rank of the
world, in one order: every rank builds every mesh of more than one rank,
in the same order (``make_mesh`` with the same arguments everywhere).
``devices=`` selects ranks; a mesh over one of them (``make_mesh(
devices=[0])``, as the JAX tests take ``jax.devices()[:1]``) is a one-rank
mesh of the calling process, whatever its rank.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as onp

from ..base import MXNetError

__all__ = ["AXIS_DP", "AXIS_TP", "AXIS_PP", "AXIS_SP", "AXIS_EP",
           "CANONICAL_ORDER", "Mesh", "MeshConfig", "make_mesh",
           "local_mesh", "default_mesh", "set_default_mesh", "axis_size",
           "active_mesh", "current_active_mesh"]

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_EP = "ep"

#: outer -> inner, as the JAX package lays the axes out (``mesh.py:41``)
CANONICAL_ORDER = (AXIS_DP, AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP)

_DEFAULT: List[Optional["Mesh"]] = [None]


@dataclass
class MeshConfig:
    """Declarative mesh spec. Unset axes default to 1; one axis may be -1
    meaning "all remaining ranks" (like a reshape wildcard)."""

    dp: int = -1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {AXIS_DP: self.dp, AXIS_TP: self.tp, AXIS_PP: self.pp,
                 AXIS_SP: self.sp, AXIS_EP: self.ep}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"only one axis may be -1, got {wild}")
        known = 1
        for k, v in sizes.items():
            if v != -1:
                if v <= 0:
                    raise ValueError(
                        f"axis {k} must be positive or -1, got {v}")
                known *= v
        if wild:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by "
                                 f"fixed axes product {known}")
            sizes[wild[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh axes product {known} != device count {n_devices}")
        return sizes


class Mesh:
    """A grid of ranks with named axes (JAX counterpart:
    ``jax.sharding.Mesh``). ``shape`` maps each axis to its size;
    ``ranks`` is the grid in :data:`CANONICAL_ORDER`; ``rank`` is the
    calling process's rank and ``coords`` its coordinate on each axis."""

    def __init__(self, ranks: onp.ndarray,
                 axis_names: Sequence[str] = CANONICAL_ORDER):
        from . import dist
        self.ranks = onp.asarray(ranks, dtype=onp.int64)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.ranks.shape))
        self.size = int(self.ranks.size)
        self.rank = dist.process_index() if self.size > 1 \
            else int(self.ranks.flat[0])
        where = onp.argwhere(self.ranks == self.rank)
        self.coords: Optional[Dict[str, int]] = (
            dict(zip(self.axis_names, map(int, where[0]))) if len(where)
            else None)
        self._groups: Dict[str, object] = {}
        self._lines: Dict[str, List[int]] = {}
        if self.size > 1:
            self._make_groups()

    def _make_groups(self) -> None:
        from . import dist
        import torch.distributed as tdist
        if not dist.initialized():
            raise MXNetError(
                f"a mesh of {self.size} ranks needs the process group: call "
                "parallel.dist.initialize() in every rank first")
        n_world = tdist.get_world_size()
        if int(self.ranks.max()) >= n_world:
            raise MXNetError(f"mesh ranks {self.ranks.ravel().tolist()} "
                             f"exceed the world of {n_world}")
        for ax, name in enumerate(self.axis_names):
            size = self.shape[name]
            if size == 1:
                continue
            lines = onp.moveaxis(self.ranks, ax, -1).reshape(-1, size)
            for line in lines.tolist():
                g = (tdist.group.WORLD if len(line) == n_world
                     else tdist.new_group(line))
                if self.rank in line:
                    self._groups[name] = g
                    self._lines[name] = line

    def _member(self) -> Dict[str, int]:
        if self.coords is None:
            raise MXNetError(f"rank {self.rank} is not in this mesh "
                             f"{self.ranks.ravel().tolist()}")
        return self.coords

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on a size-1 axis)."""
        return self._member().get(axis, 0) if axis in self.shape else 0

    def group(self, axis: str):
        """The process group of ``axis`` through this rank, or None for a
        size-1 axis (nothing to communicate)."""
        self._member()
        return self._groups.get(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in axis
        order."""
        self._member()
        return self._lines.get(axis, [self.rank])

    def __repr__(self):
        return f"Mesh({self.shape}, ranks={self.ranks.ravel().tolist()})"


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[int]] = None, **axes) -> Mesh:
    """Build a named mesh: ``make_mesh(dp=2, tp=2)`` or with a
    :class:`MeshConfig`. ``devices`` are the ranks to lay out (default:
    every rank of the world), in :data:`CANONICAL_ORDER`."""
    from . import dist
    if config is None:
        config = MeshConfig(**{**dict(dp=-1), **axes}) if axes \
            else MeshConfig()
    if devices is None:
        devices = list(range(dist.process_count()))
    ranks = [int(d) for d in devices]
    sizes = config.resolve(len(ranks))
    shape = tuple(sizes[a] for a in CANONICAL_ORDER)
    if len(ranks) == 1:
        ranks = [dist.process_index()]
    return Mesh(onp.array(ranks).reshape(shape), CANONICAL_ORDER)


def local_mesh(**axes) -> Mesh:
    """Mesh over this process's own device: one rank."""
    from . import dist
    return make_mesh(devices=[dist.process_index()], **axes)


def default_mesh() -> Mesh:
    """The process-wide mesh (lazily a pure-DP mesh over every rank)."""
    if _DEFAULT[0] is None:
        _DEFAULT[0] = make_mesh()
    return _DEFAULT[0]


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    _DEFAULT[0] = mesh


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


# ---------------------------------------------------------------------------
# The active mesh: bound while a ShardedTrainer step runs, so mesh-aware ops
# see it (dot_product_attention lowers to ring attention over ``sp``).
# ---------------------------------------------------------------------------
_ACTIVE = threading.local()


class active_mesh:
    """Context manager binding the mesh visible to mesh-aware ops."""

    def __init__(self, mesh: Optional[Mesh]):
        self._mesh = mesh

    def __enter__(self):
        stack = getattr(_ACTIVE, "stack", None)
        if stack is None:
            stack = _ACTIVE.stack = []
        stack.append(self._mesh)
        return self._mesh

    def __exit__(self, *exc):
        _ACTIVE.stack.pop()


def current_active_mesh() -> Optional[Mesh]:
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None
