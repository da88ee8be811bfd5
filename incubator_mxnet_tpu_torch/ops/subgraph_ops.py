"""Ops made by the subgraph partitioner (:mod:`...subgraph`).

Counterpart: the JAX package's ``ops/subgraph_ops.py``. They are in the
one registry with every other op, registered when ``mx.nd`` is, so a saved
partitioned graph loads and evaluates in a process that never imported
``mx.subgraph``.
"""
from __future__ import annotations

from . import nn as _nn
from .registry import register_op

__all__ = ["_subgraph_exec_op", "_sg_dense_act_op"]


@register_op("_subgraph_exec")
def _subgraph_exec_op(*arrays, sub=None, n_outs=1, prop=None, **_):
    """Evaluate an embedded subgraph (the ``sub`` attribute: ``roots`` and
    ``arg_names``, in the wire format of the JAX package) over
    ``arrays``; differentiable through torch autograd."""
    from .. import symbol as S
    res = S._eval_graph(S.Group(list(sub["roots"])),
                        list(sub["arg_names"]), list(arrays))
    res = [S._primary(r) for r in res] if isinstance(res, list) else [res]
    return tuple(res) if int(n_outs) > 1 else res[0]


@register_op("_sg_dense_act")
def _sg_dense_act_op(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True, act_type="relu", **_):
    """``FullyConnected`` then ``Activation`` as one node (the
    ``DENSE_ACT`` backend)."""
    y = _nn.fully_connected(data, weight, None if no_bias else bias,
                            flatten=flatten)
    return _nn.activation(y, act_type=act_type)
