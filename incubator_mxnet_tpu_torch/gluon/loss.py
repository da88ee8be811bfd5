"""Losses as ``torch.nn.Module``s.

Counterpart: the JAX package's ``gluon/loss.py`` (``:17-123``): ``Loss``,
``_apply_weighting``, ``_mean_all_but_batch`` and
``SoftmaxCrossEntropyLoss``, the loss the BERT pretraining step uses. The
rest of that file comes with the Gluon slice.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Loss", "SoftmaxCrossEntropyLoss"]


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


class Loss(nn.Module):
    """Base: a weighted, per-sample-mean loss (JAX counterpart:
    ``gluon/loss.py:29``)."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax and cross-entropy in one (JAX counterpart:
    ``gluon/loss.py:99``). Sparse labels (class indices, given as float and
    clipped into range as ``pick`` does) by default, dense ones with
    ``sparse_label=False``. bfloat16/float16 logits are cast to float32
    before the log-softmax."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if pred.dtype in (torch.bfloat16, torch.float16):
            pred = pred.float()
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            # pick(mode="clip") on an int32 cast of the label
            # (JAX counterpart: ops/tensor.py:441)
            idx = label.to(torch.int32).clamp(0, pred.shape[self._axis] - 1)
            loss = -torch.gather(pred, self._axis,
                                 idx.to(torch.int64).unsqueeze(self._axis))
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)
