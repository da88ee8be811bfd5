"""Parameter and array sharding rules.

Counterpart: the JAX package's ``parallel/sharding.py``: an ordered table
of (regex -> :class:`PartitionSpec`) rules over parameter names, the first
match wins, and a rule whose axes do not divide the shape leaves the array
replicated (``:63-76``). A "sharding" (:class:`NamedSharding`) is the spec
plus the mesh; each rank holds its **block** of a sharded array, the
slice its coordinates pick on every sharded dimension
(:func:`shard_array`, :meth:`NamedSharding.local`), and
:meth:`NamedSharding.gather` puts the global array back together.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple, Union

import numpy as onp
import torch

from .mesh import Mesh

__all__ = ["ShardingRules", "PartitionSpec", "P", "NamedSharding",
           "named_sharding", "shard_array", "replicate", "data_sharding",
           "spec_axes"]


class PartitionSpec(tuple):
    """Per-dimension mesh axes (None: not sharded; a tuple of names: the
    axes in row-major order), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _entry_axes(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for e in tuple(spec) for a in _entry_axes(e))


class ShardingRules:
    """Ordered (regex -> PartitionSpec) table; first match wins, default
    replicated (JAX counterpart: ``sharding.py:27``)."""

    def __init__(self, rules: Sequence[Tuple[str, tuple]] = ()):
        self._rules: List[Tuple[re.Pattern, PartitionSpec]] = [
            (re.compile(pat), P(*spec)) for pat, spec in rules]

    def add(self, pattern: str, spec) -> "ShardingRules":
        self._rules.append((re.compile(pattern), P(*spec)))
        return self

    def spec_for(self, name: str, shape: Optional[Tuple[int, ...]] = None,
                 mesh: Optional[Mesh] = None) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(name):
                if shape is not None and mesh is not None \
                        and not _divisible(shape, spec, mesh):
                    return P()
                return spec
        return P()

    def sharding_for(self, name: str, mesh: Mesh,
                     shape: Optional[Tuple[int, ...]] = None
                     ) -> "NamedSharding":
        return NamedSharding(mesh, self.spec_for(name, shape, mesh))

    def __repr__(self):
        return f"ShardingRules({[(p.pattern, s) for p, s in self._rules]})"


def _divisible(shape, spec, mesh) -> bool:
    if len(tuple(spec)) > len(shape):
        return False  # rank mismatch: rule written for a higher-rank param
    for dim, axes in zip(shape, tuple(spec)):
        size = 1
        for a in _entry_axes(axes):
            size *= mesh.shape.get(a, 1)
        if size and dim % size:
            return False
    return True


class NamedSharding:
    """A spec over a mesh: which block of a global array this rank
    holds."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def _split(self, d: int) -> Tuple[int, int]:
        """(this rank's block index, block count) along dimension ``d``."""
        idx, n = 0, 1
        if d < len(self.spec):
            for a in _entry_axes(self.spec[d]):
                size = self.mesh.axis_size(a)
                idx = idx * size + self.mesh.axis_index(a)
                n *= size
        return idx, n

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(s // self._split(d)[1] for d, s in enumerate(shape))

    def is_replicated(self) -> bool:
        return all(self.mesh.axis_size(a) == 1 for a in spec_axes(self.spec))

    def local(self, x):
        """This rank's block of the global ``x`` (a tensor or array;
        a view where the block is one)."""
        for d in range(len(self.spec)):
            i, n = self._split(d)
            if n > 1:
                size = x.shape[d] // n
                if isinstance(x, torch.Tensor):
                    x = x.narrow(d, i * size, size)
                else:
                    x = onp.take(x, range(i * size, (i + 1) * size), axis=d)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block (a collective over
        the sharded axes)."""
        from .collectives import all_gather
        for d in range(len(self.spec)):
            axes = tuple(a for a in _entry_axes(self.spec[d])
                         if self.mesh.axis_size(a) > 1)
            if axes:
                x = all_gather(x, axes, gather_axis=d, mesh=self.mesh)
        return x

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"


def named_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh, batch_axis: int = 0,
                  seq_axis: Optional[int] = None,
                  ndim: int = 2) -> NamedSharding:
    """Input-batch sharding: batch dim over ``dp``, sequence dim over
    ``sp`` when those mesh axes have size > 1."""
    spec: List = [None] * ndim
    if batch_axis < ndim and mesh.shape.get("dp", 1) > 1:
        spec[batch_axis] = "dp"
    if seq_axis is not None and seq_axis < ndim \
            and mesh.shape.get("sp", 1) > 1:
        spec[seq_axis] = "sp"
    return NamedSharding(mesh, P(*spec))


def shard_array(x, mesh: Mesh, spec: Union[PartitionSpec, Sequence]
                ) -> torch.Tensor:
    """This rank's block of ``x`` (numpy, a tensor or an NDArray) under
    ``spec``, as a contiguous tensor where ``x`` lies (numpy: the CPU)."""
    x = getattr(x, "_data", x)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(onp.ascontiguousarray(x))
    sh = spec if isinstance(spec, NamedSharding) else NamedSharding(mesh, spec)
    return sh.local(x).contiguous()
