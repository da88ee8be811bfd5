"""``mx.contrib``: the contrib op namespaces ``contrib.nd`` and
``contrib.sym``.

Counterpart: the JAX package's ``contrib/__init__.py`` (``:20-34``), whose
``contrib.nd.<op>`` is every ``_contrib_<op>`` of the registry under its
short name. The port's ``contrib.nd`` holds the ``_contrib_*`` ops the
port has: the detection ops (``box_nms``, ``MultiBoxPrior``, ``ROIAlign``,
``MultiProposal``, ``rpn_target`` ...), the int8 ops (``quantize``,
``quantized_fully_connected`` ...), ``boolean_mask``, ``index_copy``,
``index_array`` and the update ops ``adamw_update`` and
``multi_sum_sq``. ``contrib.sym`` (JAX ``:38-50``) composes every
``_contrib_*`` op of the registry symbolically under its short name; its
control-flow entries (``foreach``, ``while_loop``, ``cond``) raise until
``ops/control_flow.py`` is ported (ROADMAP queue A, item 7c), as do the
``interleaved_matmul_*`` ops.
"""
from __future__ import annotations

import sys
import types

from ..base import MXNetError
from ..ndarray import op as _op
from ..ops.registry import OPS

__all__ = ["nd", "sym"]

nd = types.ModuleType(__name__ + ".nd")
for _name in _op.__all__:
    if _name.startswith("_contrib_"):
        setattr(nd, _name[len("_contrib_"):], getattr(_op, _name))
for _name in ("adamw_update", "multi_sum_sq"):
    setattr(nd, _name, getattr(_op, _name))
del _name
sys.modules[nd.__name__] = nd


def _make_sym(opname: str):
    def sym_op(*args, name=None, **kwargs):
        from .. import symbol as S
        ins = [a for a in args if isinstance(a, S.Symbol)]
        return S.Symbol(opname, ins, attrs=kwargs, name=name)
    sym_op.__name__ = opname
    return sym_op


def _control_flow(fname: str):
    def op(*args, **kwargs):
        raise MXNetError(f"contrib.sym.{fname} needs ops/control_flow.py, "
                         "which comes with ROADMAP queue A, item 7c")
    op.__name__ = fname
    return op


sym = types.ModuleType(__name__ + ".sym")
for _name, _opdef in list(OPS.items()):
    if _name.startswith("_contrib_"):
        setattr(sym, _name[len("_contrib_"):], _make_sym(_opdef.name))
for _name in ("foreach", "while_loop", "cond"):
    setattr(sym, _name, _control_flow(_name))
del _name, _opdef
sys.modules[sym.__name__] = sym
