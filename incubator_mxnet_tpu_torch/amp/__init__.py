"""AMP: automatic mixed precision.

Counterpart: the JAX package's ``amp/__init__.py`` (reference:
``python/mxnet/amp/amp.py``): the op lists (:mod:`.lists`), ``init()``
patching the op namespace with casts, ``reset()``, the dynamic
:class:`LossScaler` with ``init_trainer``/``scale_loss``/``unscale``, and
``convert_hybrid_block``/``convert_model``.

``init("bfloat16")`` wraps the ops of :data:`.lists.FP16_FP32_FUNCS` in
``mx.nd``, which is also the ``F`` of every ``hybrid_forward``, so that
their float32 inputs are cast to the target dtype: ``FullyConnected``,
``Convolution``, ``dot``, ``dot_product_attention`` ... then run on the
bf16 (or fp16) tensor cores, and the flash-attention kernels take bf16 Q,
K and V. Reductions, norms, softmax and the losses stay float32
(:data:`.lists.FP32_FUNCS`), and the weights stay float32: the casts are
in the forward, so gradients reach them in float32. The JAX wrapper only
ever sees ``NDArray``\\ s; the port's ``hybrid_forward`` runs on tensors, so
the wrapper casts float32 ``NDArray`` and ``torch.Tensor`` arguments alike.

bfloat16 has float32's exponent range and needs no loss scaling;
:class:`LossScaler` is attached only under ``init("float16")``. Its
``guard=`` (``fault.StepGuard``) and the ``amp.loss_scale`` telemetry
events are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import ndarray as nd_mod
from ..base import MXNetError, torch_dtype
from ..ndarray import NDArray
from . import lists

__all__ = ["init", "reset", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "convert_model", "LossScaler", "lists"]

_STATE = {"initialized": False, "dtype": None, "patched": {}}


def _cast_wrapper(fn, target_dtype: torch.dtype):
    """``fn`` with its float32 positional arguments (``NDArray`` or
    tensor, or lists and tuples of them, as ``RNN``'s per-layer weights)
    cast to ``target_dtype`` first."""
    name = "bfloat16" if target_dtype == torch.bfloat16 else "float16"

    def cast(a):
        if isinstance(a, NDArray) and a._data.dtype == torch.float32:
            return a.astype(name)
        if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
            return a.to(target_dtype)
        if isinstance(a, (list, tuple)):
            return type(a)(cast(x) for x in a)
        return a

    def wrapped(*args, **kwargs):
        return fn(*[cast(a) for a in args], **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", "amp_op")
    wrapped._amp_wrapped = fn
    return wrapped


def init(target_dtype: str = "bfloat16",
         target_precision_ops: Optional[List[str]] = None,
         conditional_fp32_ops=None,
         fp32_ops: Optional[List[str]] = None) -> None:
    """Patch ``mx.nd`` for mixed precision (JAX counterpart:
    ``amp/__init__.py:47``): each op of ``target_precision_ops`` (default
    :data:`.lists.FP16_FP32_FUNCS`) not in ``fp32_ops`` (default
    :data:`.lists.FP32_FUNCS`) casts its float32 inputs to
    ``target_dtype``, ``"bfloat16"`` or ``"float16"``. A second call does
    nothing until :func:`reset`.

    Call it before the first captured step: a CUDA graph captured earlier
    (``parallel.ShardedTrainer``'s fused step, a ``hybridize()``-d block's
    cached op) replays the float32 work it recorded, as a JAX program
    traced before ``init()`` stays float."""
    if _STATE["initialized"]:
        return
    dtype = torch_dtype(target_dtype)
    if dtype not in (torch.bfloat16, torch.float16):
        raise MXNetError("AMP target must be bfloat16 or float16")
    ops = list(target_precision_ops or lists.FP16_FP32_FUNCS)
    skip = set(fp32_ops or lists.FP32_FUNCS)
    for name in ops:
        if name in skip:
            continue
        fn = getattr(nd_mod, name, None)
        if fn is None:
            continue
        _STATE["patched"][name] = fn
        setattr(nd_mod, name, _cast_wrapper(fn, dtype))
    _STATE["initialized"] = True
    _STATE["dtype"] = dtype


def reset() -> None:
    """Undo :func:`init` (JAX counterpart: ``amp/__init__.py:74``; the
    reference has no unpatch)."""
    for name, fn in _STATE["patched"].items():
        setattr(nd_mod, name, fn)
    _STATE.update(initialized=False, dtype=None, patched={})


class LossScaler:
    """Dynamic loss scaling (JAX counterpart: ``amp/__init__.py:81``;
    reference ``amp/loss_scaler.py``), for float16: the scale halves on an
    overflow step (not below 1) and doubles after ``scale_window`` clean
    steps. The overflow check is ``fault.all_finite`` over every gradient:
    one fused check and one host read. An optional ``fault.StepGuard``
    escalates: an overflow step goes to ``guard.decide``, a clean one to
    ``guard.good_step``, so ``halt`` (or the guard's ``max_consecutive``)
    turns a diverging float16 run into an error instead of a silent
    collapse of the scale."""

    def __init__(self, init_scale: float = 2 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000, guard=None):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._guard = guard
        #: total overflow (skipped-update) steps
        self.overflows = 0
        #: steps observed (one update_scale per training step)
        self.steps = 0

    def has_overflow(self, params) -> bool:
        """Does any gradient of ``params`` (Gluon Parameters) hold a NaN or
        an infinity?"""
        from ..fault.guards import all_finite
        grads = [p._var.grad for p in params
                 if p._initialized and p._var.grad is not None]
        if not grads:
            return False
        return not all_finite(grads)

    def update_scale(self, overflow: bool) -> None:
        self.steps += 1
        if overflow:
            self.overflows += 1
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
            if self._guard is not None:
                # halt, or max_consecutive, raise NonFiniteError; skipping
                # the update is the scaler's own behaviour
                self._guard.decide(
                    self.steps, "loss-scale overflow",
                    detail=f"overflow #{self.overflows}, scale now "
                           f"{self.loss_scale:g}")
        else:
            self._unskipped += 1
            if self._guard is not None:
                self._guard.good_step()
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0


def init_trainer(trainer) -> None:
    """Attach dynamic loss scaling to a ``gluon.Trainer`` under
    ``init("float16")``; under bfloat16 none (JAX counterpart:
    ``amp/__init__.py:145``)."""
    trainer._amp_loss_scaler = (LossScaler()
                                if _STATE["dtype"] == torch.float16 else None)


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``
    (JAX counterpart: ``amp/__init__.py:153``): the loss times the loss
    scale; on exit the trainer's gradient scale becomes one over the scale
    used, or 0 on an overflow step (the update then changes nothing), and
    the scaler moves on."""

    def __init__(self, loss, trainer):
        self._loss = loss
        self._trainer = trainer
        self._scaler = getattr(trainer, "_amp_loss_scaler", None)
        self._used_scale = None

    def __enter__(self):
        if self._scaler is None:
            return self._loss
        s = self._used_scale = self._scaler.loss_scale
        if isinstance(self._loss, (list, tuple)):
            return [loss * s for loss in self._loss]
        return self._loss * s

    def __exit__(self, *exc):
        if self._scaler is not None:
            overflow = self._scaler.has_overflow(self._trainer._params)
            # unscale by the scale the loss was multiplied by: update_scale
            # may change loss_scale for the next step
            self._trainer._scale = 0.0 if overflow \
                else 1.0 / self._used_scale
            self._scaler.update_scale(overflow)


def unscale(trainer) -> None:
    """Divide every gradient by the current loss scale, in place (JAX
    counterpart: ``amp/__init__.py:181``)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    grads = [p._var.grad for p in trainer._params
             if p._initialized and p._var.grad is not None]
    if grads:
        with torch.no_grad():
            torch._foreach_mul_(grads, 1.0 / scaler.loss_scale)


def convert_hybrid_block(block, target_dtype: str = "bfloat16", ctx=None):
    """Cast a HybridBlock's parameters (JAX counterpart:
    ``amp/__init__.py:192``); BatchNorm keeps float32 ones."""
    block.cast(target_dtype)
    return block


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  **_):
    """Symbol-API model conversion: the argument parameters cast, the aux
    ones as they are (JAX counterpart: ``amp/__init__.py:198``)."""
    cast = {k: v.astype(target_dtype) for k, v in arg_params.items()}
    return sym, cast, dict(aux_params)
