"""Losses as Gluon ``HybridBlock``\\ s.

Counterpart: the JAX package's ``gluon/loss.py`` (``:17-128``): ``Loss``
with ``weight`` and ``batch_axis``, ``_apply_weighting``,
``_mean_all_but_batch``, ``L2Loss``, ``L1Loss`` and
``SoftmaxCrossEntropyLoss``, the loss of the BERT pretraining step. A loss
given NDArrays returns an NDArray (recorded under ``autograd.record()``),
given tensors a tensor. The rest of that file comes with a later slice.
"""
from __future__ import annotations

import torch

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """Scale by ``sample_weight`` (broadcast) and the scalar ``weight``
    (JAX counterpart: ``gluon/loss.py:17``)."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _mean_all_but_batch(loss, batch_axis):
    """Mean over every axis but ``batch_axis`` (JAX counterpart:
    ``gluon/loss.py:41``)."""
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    if not axes:
        return loss
    return loss.mean(dim=axes)


class Loss(HybridBlock):
    """Base: a weighted, per-sample-mean loss (JAX counterpart:
    ``gluon/loss.py:29``)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    """``weight / 2 * (label - pred)²`` (JAX counterpart:
    ``gluon/loss.py:48``)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class L1Loss(Loss):
    """``weight * |label - pred|`` (JAX counterpart: ``gluon/loss.py:59``).
    """

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax and cross-entropy in one (JAX counterpart:
    ``gluon/loss.py:99``). Sparse labels (class indices, given as float and
    clipped into range as ``pick`` does) by default, dense ones with
    ``sparse_label=False``. bfloat16/float16 logits are cast to float32
    before the log-softmax."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if pred.dtype in (torch.bfloat16, torch.float16):
            pred = pred.float()
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
