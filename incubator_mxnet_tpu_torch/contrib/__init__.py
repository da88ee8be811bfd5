"""``mx.contrib``: the contrib op namespace ``contrib.nd``.

Counterpart: the JAX package's ``contrib/__init__.py`` (``:20-34``), whose
``contrib.nd.<op>`` is every ``_contrib_<op>`` of the registry under its
short name. The port's ``contrib.nd`` holds the ``_contrib_*`` ops the
port has: the detection ops (``box_nms``, ``MultiBoxPrior``, ``ROIAlign``,
``MultiProposal``, ``rpn_target`` ...), the int8 ops (``quantize``,
``quantized_fully_connected`` ...), ``boolean_mask``, ``index_copy``,
``index_array`` and the update ops ``adamw_update`` and
``multi_sum_sq``. ``contrib.sym``, the control-flow ops and the
``interleaved_matmul_*`` ops come with the modules that define them.
"""
from __future__ import annotations

import sys
import types

from ..ndarray import op as _op

__all__ = ["nd"]

nd = types.ModuleType(__name__ + ".nd")
for _name in _op.__all__:
    if _name.startswith("_contrib_"):
        setattr(nd, _name[len("_contrib_"):], getattr(_op, _name))
for _name in ("adamw_update", "multi_sum_sq"):
    setattr(nd, _name, getattr(_op, _name))
del _name
sys.modules[nd.__name__] = nd
