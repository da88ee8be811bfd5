"""The op namespace: ``mx.nd.<op>`` and the ``F`` of ``hybrid_forward``.

Counterpart: the JAX package's ``ndarray/op.py`` (``make_nd_op`` at
``:58-112``) and the reflection of the registry into ``mx.nd``
(``ndarray/__init__.py:50-52``). Every op of the port's registry
(:mod:`..ops.registry`: the ops of ``ops/tensor.py``, ``ops/nn.py``,
``ops/vision.py``, ``ops/detection.py``, ``ops/quantization.py``,
``ops/optimizer_ops.py``, ``dot_product_attention`` and ``Dropout``) is
reflected here under each of its names by :func:`make_nd_op`. Each op is a
function on tensors. Given NDArrays it unwraps them, runs under
``torch.set_grad_enabled(autograd.is_recording())`` and wraps the result;
given tensors (inside ``hybrid_forward``, which the Gluon blocks run on
tensors) it is the plain function. Either way it drops ``name=`` and
``ctx=``, and ``out=`` (an array or a list, one per result) receives the
results in place, as the JAX ``make_nd_op`` does. Given no array at all
(the source ops ``_sym_zeros``/``_sym_ones``), it runs on the device of
``ctx=``, or else of the current context, and returns an NDArray; the JAX
namespace raises ``TypeError`` there. ``amp.init()`` casts the inputs of the
ops of its list in this namespace.
"""
from __future__ import annotations

import functools

import torch

from .. import autograd
from .. import random as _random
from ..context import Context, as_context
from .. import operator as _operator  # noqa: F401  (registers Custom)
from ..ops import attention as _attn
from ..ops import control_flow as _cf  # noqa: F401  (_foreach, _cond ...)
from ..ops import detection as _det
from ..ops import nn as _nn  # noqa: F401  (registers the nn ops)
from ..ops import optimizer_ops as _opt_ops
from ..ops import quantization as _quant
from ..ops import subgraph_ops as _sg_ops  # noqa: F401  (the partitioner's)
from ..ops import tensor as _tensor  # noqa: F401  (registers the tensor ops)
from ..ops import vision as _vision  # noqa: F401  (registers MakeLoss last)
from ..ops.registry import OPS, register_op
from .ndarray import NDArray, _recorded

__all__ = ["make_nd_op"]


def _has_nd(values, kinds=NDArray) -> bool:
    for v in values:
        if isinstance(v, kinds) or (isinstance(v, (list, tuple))
                                    and _has_nd(v, kinds)):
            return True
    return False


def _unwrap(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap(x) for x in v)
    return v


def _wrap(v):
    if isinstance(v, torch.Tensor):
        return _recorded(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def _nd_op(fn):
    """``fn`` on tensors -> an op that also takes NDArrays (see the module
    docstring)."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        if not (_has_nd(args) or _has_nd(kwargs.values())):
            return fn(*args, **kwargs)
        args = _unwrap(args)
        kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            return _wrap(fn(*args, **kwargs))
    return op


def _write_out(out, result):
    """``result`` copied into ``out`` in place (JAX counterpart:
    ``out._set_data``)."""
    outs = [out] if isinstance(out, (NDArray, torch.Tensor)) else list(out)
    results = [result] if isinstance(result, (NDArray, torch.Tensor)) \
        else list(result)
    for o, r in zip(outs, results):
        if isinstance(o, NDArray):
            o._check_inplace_ok()
        with torch.no_grad():
            _unwrap(o).copy_(_unwrap(r))
    return out


def make_nd_op(opdef):
    """The ``mx.nd`` op of a registry entry (JAX counterpart:
    ``make_nd_op``): :func:`_nd_op` of its function, taking and dropping
    ``name=``, with ``out=``; ``ctx=`` places a source op's result."""
    op = _nd_op(opdef.fn)

    @functools.wraps(opdef.fn)
    def nd_op(*args, out=None, **kwargs):
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        if _has_nd((*args, *kwargs.values()), (NDArray, torch.Tensor)):
            result = op(*args, **kwargs)
        else:
            with torch.device(as_context(ctx).torch_device):
                result = _wrap(opdef.fn(*args, **kwargs))
        return result if out is None else _write_out(out, result)
    nd_op.__name__ = nd_op.__qualname__ = opdef.name
    return nd_op


# -- ops defined with the namespace's state ---------------------------------
@register_op("Dropout", aliases=("dropout",))
def _dropout(data, p=0.5, mode="training", axes=(), training=None,
             generator=None, **_):
    """Inverted dropout, active under ``autograd.is_training()`` unless
    ``training`` says otherwise (or always, ``mode="always"``): the mask
    shared along ``axes``, drawn from ``generator`` or else the device's
    stream of :mod:`..random` (the reference's ``key`` is not taken)."""
    if training is None:
        training = autograd.is_training()
    if p <= 0.0 or not (training or mode == "always"):
        return data
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    if generator is None:
        generator = _random.generator(Context.from_device(data.device))
    u = torch.rand(shape, generator=generator, device=data.device)
    return data * (u < keep).to(data.dtype) / keep


register_op("dot_product_attention")(_attn.dot_product_attention)
for _name in _attn.INTERLEAVED:
    register_op(_name, aliases=("_contrib_" + _name,))(getattr(_attn, _name))

#: op -> its aliases in the JAX registry (``ops/detection.py:53-719``)
DETECTION_ALIASES = {
    "box_iou": ("_contrib_box_iou",),
    "box_nms": ("_contrib_box_nms",),
    "bipartite_matching": ("_contrib_bipartite_matching",),
    "multibox_prior": ("_contrib_MultiBoxPrior", "MultiBoxPrior"),
    "multibox_target": ("_contrib_MultiBoxTarget", "MultiBoxTarget"),
    "multibox_detection": ("_contrib_MultiBoxDetection",
                           "MultiBoxDetection"),
    "roi_align": ("_contrib_ROIAlign", "ROIAlign"),
    "roi_pooling": ("ROIPooling",),
    "multi_proposal": ("_contrib_MultiProposal", "MultiProposal"),
    "proposal": ("_contrib_Proposal", "Proposal"),
    "deformable_convolution": ("_contrib_DeformableConvolution",
                               "DeformableConvolution"),
    "psroi_pooling": ("_contrib_PSROIPooling", "PSROIPooling"),
    "rpn_target": ("_contrib_rpn_target", "AnchorTarget"),
    "proposal_target": ("_contrib_proposal_target", "ProposalTarget"),
}
for _name, _aliases in DETECTION_ALIASES.items():
    register_op(_name, aliases=_aliases)(getattr(_det, _name))
for _name in _quant.OPS:
    register_op(_name, aliases=("_contrib_" + _name,))(
        getattr(_quant, _name))
for _name in _opt_ops.__all__:
    _aliases = (("_contrib_" + _name,)
                if _name in ("adamw_update", "multi_sum_sq") else ())
    register_op(_name, aliases=_aliases)(getattr(_opt_ops, _name))
del _name, _aliases


_ND_OPS = {}


def nd_op_of(opdef):
    """The one ``mx.nd`` op of a registry entry: its name and every alias
    are the same function."""
    op = _ND_OPS.get(id(opdef))
    if op is None or op._opdef is not opdef:
        op = _ND_OPS[id(opdef)] = make_nd_op(opdef)
        op._opdef = opdef
    return op


def refresh_ops(namespace) -> list:
    """Reflect every registry name ``namespace`` lacks into it; returns
    the names set."""
    added = []
    for name, opdef in list(OPS.items()):
        if name not in namespace:
            namespace[name] = nd_op_of(opdef)
            added.append(name)
    return added


__all__ += refresh_ops(globals())
