"""``mx.contrib``: the contrib op namespaces ``contrib.nd`` and
``contrib.sym``.

Counterpart: the JAX package's ``contrib/__init__.py`` (``:20-34``), whose
``contrib.nd.<op>`` is every ``_contrib_<op>`` of the registry under its
short name. The port's ``contrib.nd`` holds the ``_contrib_*`` ops the
port has: the detection ops (``box_nms``, ``MultiBoxPrior``, ``ROIAlign``,
``MultiProposal``, ``rpn_target`` ...), the int8 ops (``quantize``,
``quantized_fully_connected`` ...), ``boolean_mask``, ``index_copy``,
``index_array`` and the update ops ``adamw_update`` and
``multi_sum_sq``, the ``interleaved_matmul_*`` ops, and the control flow
of ``ops/control_flow.py`` (``foreach``, ``while_loop``, ``cond``; JAX
``:31-34``). ``contrib.sym`` (JAX ``:38-53``) composes every
``_contrib_*`` op of the registry symbolically under its short name, and
its ``foreach``/``while_loop``/``cond`` build the subgraph nodes of
``ops/control_flow.py``.
"""
from __future__ import annotations

import sys
import types

from ..ndarray import op as _op
from ..ops import control_flow as _cf
from ..ops.registry import OPS

__all__ = ["nd", "sym"]

nd = types.ModuleType(__name__ + ".nd")
for _name in _op.__all__:
    if _name.startswith("_contrib_"):
        setattr(nd, _name[len("_contrib_"):], getattr(_op, _name))
for _name in ("adamw_update", "multi_sum_sq"):
    setattr(nd, _name, getattr(_op, _name))
del _name
nd.foreach = _cf.foreach
nd.while_loop = _cf.while_loop
nd.cond = _cf.cond
sys.modules[nd.__name__] = nd


def _make_sym(opname: str):
    def sym_op(*args, name=None, **kwargs):
        from .. import symbol as S
        ins = [a for a in args if isinstance(a, S.Symbol)]
        return S.Symbol(opname, ins, attrs=kwargs, name=name)
    sym_op.__name__ = opname
    return sym_op


sym = types.ModuleType(__name__ + ".sym")
for _name, _opdef in list(OPS.items()):
    if _name.startswith("_contrib_"):
        setattr(sym, _name[len("_contrib_"):], _make_sym(_opdef.name))
del _name, _opdef
sym.foreach = _cf.sym_foreach
sym.while_loop = _cf.sym_while_loop
sym.cond = _cf.sym_cond
sys.modules[sym.__name__] = sym
