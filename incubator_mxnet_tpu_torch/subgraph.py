"""Subgraph backends: a property registry and the graph partitioner.

Counterpart: the JAX package's ``subgraph.py`` (``SubgraphProperty``
``:45``, ``SubgraphBackend`` ``:113``, ``register_backend`` ``:131``,
``register_property`` ``:140``, ``partition`` ``:169``, the ``DENSE_ACT``
backend ``:240``), surfaced as ``sym.optimize_for(backend)`` and
``HybridBlock.optimize_for``. Partitioning is a pure Symbol -> Symbol
rewrite: the graph is rebuilt bottom-up, a region a property matches
replaced by the property's node, by default the opaque
``_subgraph_exec`` holding the region in the ``sub`` attribute's wire
format, so a partitioned graph's JSON is the JAX package's byte for byte.
The nodes run as registered ops (:mod:`.ops.subgraph_ops`), eagerly or
inside a captured graph: the rewrite is the seam for fused or vendor
kernels, not a scheduler.

A third party registers a backend without editing the package::

    @mx.subgraph.register_property("MY_BACKEND")
    class FuseAddRelu(mx.subgraph.SubgraphProperty):
        op_names = ("broadcast_add", "Activation")   # a linear chain

    fused = sym.optimize_for("MY_BACKEND")           # or net.optimize_for
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .base import MXNetError

__all__ = ["SubgraphProperty", "SubgraphBackend", "register_backend",
           "register_property", "get_backend", "list_backends", "partition"]


class SubgraphProperty:
    """One rewrite rule: match a region, produce its replacement.

    Reference: ``SubgraphProperty`` + ``SubgraphSelector``
    (src/operator/subgraph/subgraph_property.h). The common selector shape —
    a linear op chain along the data path — is declarative here: set
    ``op_names = ("FullyConnected", "Activation")`` and the default
    :meth:`match` finds chains whose interior outputs have exactly one
    consumer. Override :meth:`match` for non-chain patterns and
    :meth:`rewrite` for a custom replacement node (the default wraps the
    region in an opaque ``_subgraph_exec`` node, the CreateSubgraphNode
    analogue)."""

    #: linear chain to match, producer -> consumer order
    op_names: Tuple[str, ...] = ()

    # -- selection ----------------------------------------------------------
    def match(self, node, n_consumers) -> Optional[List]:
        """Return the matched region as a deepest-first node list ending at
        ``node``, or None. ``n_consumers`` maps ``id(node)`` to its fan-out
        in the full graph — interior nodes of a fused region must feed the
        region only."""
        if not self.op_names or node._op != self.op_names[-1]:
            return None
        chain = [node]
        cur = node
        for want in reversed(self.op_names[:-1]):
            if not cur._inputs:
                return None
            prev = cur._inputs[0]
            if prev._op != want or prev._base is not None:
                return None
            if n_consumers.get(id(prev), 0) != 1:
                return None  # interior output escapes the region
            chain.append(prev)
            cur = prev
        chain.reverse()
        return chain

    # -- replacement --------------------------------------------------------
    def rewrite(self, region, inputs, externs):
        """Build the replacement Symbol for ``region`` (deepest-first node
        list). ``externs`` are the region's external input nodes in
        first-use order; ``inputs`` are their already-rebuilt counterparts
        to wire into the replacement. Return None to veto the match."""
        from . import symbol as S
        phs = [S.Variable(f"sg_in{i}") for i in range(len(externs))]
        cloned = _clone_region(region, dict(zip(map(id, externs), phs)))
        sub = {"roots": [cloned[id(region[-1])]],
               "arg_names": [p.name for p in phs]}
        return S.Symbol("_subgraph_exec", list(inputs),
                        attrs={"sub": sub, "n_outs": 1,
                               "prop": type(self).__name__},
                        name=region[-1]._name + "_sg")


def _clone_region(region, extern_map):
    """Clone the region's nodes over placeholder inputs (the subgraph cut:
    reference build_subgraph.cc CutGraphInputs)."""
    from . import symbol as S
    out: Dict[int, "S.Symbol"] = {}
    for n in region:
        ins = [out.get(id(i)) or extern_map[id(i)] for i in n._inputs]
        out[id(n)] = S.Symbol(n._op, ins, attrs=n._attrs, name=n._name,
                              num_outputs=n._num_outputs)
    return out


class SubgraphBackend:
    """A named, ordered collection of properties
    (reference: SubgraphBackend in subgraph_property.h)."""

    def __init__(self, name: str):
        self.name = name
        self.properties: List[SubgraphProperty] = []

    def add_property(self, prop) -> SubgraphProperty:
        if isinstance(prop, type):
            prop = prop()
        self.properties.append(prop)
        return prop


_BACKENDS: Dict[str, SubgraphBackend] = {}


def register_backend(name: str) -> SubgraphBackend:
    """Create (or fetch) a named backend — the
    MXNET_REGISTER_SUBGRAPH_BACKEND analogue. Idempotent so separate
    modules can attach properties to one backend."""
    if name not in _BACKENDS:
        _BACKENDS[name] = SubgraphBackend(name)
    return _BACKENDS[name]


def register_property(backend_name: str, prop=None):
    """Attach a property (class or instance) to a backend; usable as a
    decorator — the MXNET_REGISTER_SUBGRAPH_PROPERTY analogue."""
    backend = register_backend(backend_name)

    def _do(p):
        backend.add_property(p)
        return p

    return _do(prop) if prop is not None else _do


def get_backend(name: str) -> SubgraphBackend:
    if name not in _BACKENDS:
        raise MXNetError(
            f"unknown subgraph backend {name!r}; registered: "
            f"{list_backends()} (register with "
            "mx.subgraph.register_backend)")
    return _BACKENDS[name]


def list_backends() -> List[str]:
    return sorted(_BACKENDS)


# ---------------------------------------------------------------------------
# the partitioning pass (reference: build_subgraph.cc BuildSubgraph)
# ---------------------------------------------------------------------------

def partition(symbol, backend):
    """Rewrite ``symbol``, replacing every region matched by one of
    ``backend``'s properties. Pure function: returns a new Symbol, the
    input graph is untouched. Properties are tried in registration order;
    matching consults the ORIGINAL graph (consumer counts included), so one
    pass cannot cascade onto its own replacements — run partition again to
    fix-point if a backend wants that."""
    from . import symbol as S
    if isinstance(backend, str):
        backend = get_backend(backend)
    elif not isinstance(backend, SubgraphBackend):
        raise MXNetError(
            f"partition expects a backend name or SubgraphBackend, got "
            f"{type(backend).__name__}; registered: {list_backends()}")

    nodes = S._topo(symbol)
    n_consumers: Dict[int, int] = {}
    for n in nodes:
        for i in n._inputs:
            n_consumers[id(i)] = n_consumers.get(id(i), 0) + 1
        if n._base is not None:
            n_consumers[id(n._base)] = n_consumers.get(id(n._base), 0) + 1

    memo: Dict[int, "S.Symbol"] = {}

    def plain(node):
        ins = [rebuild(i) for i in node._inputs]
        if all(a is b for a, b in zip(ins, node._inputs)):
            return node  # untouched subtree: keep identity (and sharing)
        return S.Symbol(node._op, ins, attrs=node._attrs, name=node._name,
                        num_outputs=node._num_outputs)

    def rebuild(node):
        if id(node) in memo:
            return memo[id(node)]
        if node._base is not None:
            new = rebuild(node._base)[node._output_index]
        elif node._op is None:
            new = node
        else:
            new = None
            for prop in backend.properties:
                region = prop.match(node, n_consumers)
                if not region:
                    continue
                in_region = set(map(id, region))
                externs, seen = [], set()
                for r in region:
                    for i in r._inputs:
                        if id(i) not in in_region and id(i) not in seen:
                            seen.add(id(i))
                            externs.append(i)
                repl = prop.rewrite(region, [rebuild(e) for e in externs],
                                    externs)
                if repl is not None:
                    new = repl
                    break
            if new is None:
                new = plain(node)
        memo[id(node)] = new
        return new

    return rebuild(symbol)


# ---------------------------------------------------------------------------
# the in-tree backend DENSE_ACT: FullyConnected then Activation as one node
# (the op is in ops/subgraph_ops.py, registered with every other op)
# ---------------------------------------------------------------------------

class DenseActivationProperty(SubgraphProperty):
    """Fuse ``FullyConnected -> Activation`` into ``_sg_dense_act``."""

    op_names = ("FullyConnected", "Activation")

    def rewrite(self, region, inputs, externs):
        from . import symbol as S
        fc, act = region
        attrs = {k: v for k, v in fc._attrs.items()}
        attrs["act_type"] = act.attr("act_type") or "relu"
        return S.Symbol("_sg_dense_act", list(inputs), attrs=attrs,
                        name=fc._name + "_" + attrs["act_type"])


register_property("DENSE_ACT", DenseActivationProperty)
