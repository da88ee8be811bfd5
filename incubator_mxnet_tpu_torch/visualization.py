"""Network visualization: ``print_summary`` and ``plot_network``.

Counterpart: the JAX package's ``visualization.py``: ``print_summary``
prints a layer table of a symbol (output shapes from the shape inference
walk, parameter counts) in the Executor's topological order;
``plot_network`` builds a ``graphviz`` digraph and raises ``ImportError``
without the ``graphviz`` package, as the JAX one does.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as onp

__all__ = ["print_summary", "plot_network"]


def _node_params(node, shapes: Dict[str, tuple], data_names) -> int:
    """Learnable parameters of an op node: its variable inputs whose
    shapes were resolved, but the data and label inputs."""
    total = 0
    for inp in node._inputs:
        if inp._op is None and inp._name in shapes \
                and inp._name not in data_names:
            total += int(onp.prod(shapes[inp._name]))
    return total


def print_summary(symbol, shape: Optional[Dict[str, tuple]] = None,
                  line_length: int = 98, positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a layer table for ``symbol`` and return the parameter count.
    ``shape`` maps data variable names to input shapes, needed for output
    shapes and parameter counts."""
    from .symbol import _infer_graph_shapes, _topo

    shapes: Dict[str, tuple] = {}
    specs_by_node: Dict[int, object] = {}
    if shape:
        shapes, _ = _infer_graph_shapes(symbol, shape, sink=specs_by_node)
    data_names = set(shape or ())

    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def row(vals):
        line = ""
        for v, pos in zip(vals, positions):
            line = (line + str(v))[: pos - 1]
            line += " " * (pos - len(line))
        print(line)

    print("_" * line_length)
    row(fields)
    print("=" * line_length)

    total = 0
    for node in _topo(symbol):
        if node._op is None:
            if node._name in data_names:
                row([f"{node._name} (input)", shapes.get(node._name, ""), 0,
                     ""])
            continue
        if node._base is not None:
            continue
        out_shape = ""
        if shape:
            spec = specs_by_node.get(id(node))
            out_shape = tuple(spec.shape) if spec is not None else "?"
        n_params = _node_params(node, shapes, data_names) if shape else 0
        total += n_params
        prev = ",".join(i._name for i in node._inputs if i._op is not None
                        or i._name in data_names)
        row([f"{node._name} ({node._op})", out_shape, n_params, prev])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("_" * line_length)
    return total


def plot_network(symbol, title: str = "plot", shape=None,
                 node_attrs: Optional[dict] = None):
    """A ``graphviz.Digraph`` of the symbol graph; ``ImportError`` without
    the ``graphviz`` package (use :func:`print_summary` then)."""
    try:
        import graphviz
    except ImportError as e:
        raise ImportError(
            "plot_network requires the 'graphviz' python package; it is not "
            "installed in this environment — use print_summary for a "
            "text rendering") from e
    from .symbol import _topo

    dot = graphviz.Digraph(name=title)
    attrs = {"shape": "box", "fixedsize": "false"}
    attrs.update(node_attrs or {})
    for node in _topo(symbol):
        if node._base is not None:
            continue
        label = node._name if node._op is None \
            else f"{node._name}\n{node._op}"
        dot.node(node._name, label=label, **attrs)
        for inp in node._inputs:
            tgt = inp if inp._base is None else inp._base
            dot.edge(tgt._name, node._name)
    return dot
