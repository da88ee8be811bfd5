"""Losses as Gluon ``HybridBlock``\\ s.

Counterpart: the JAX package's ``gluon/loss.py`` (``:17-296``): ``Loss``
with ``weight`` and ``batch_axis``, ``_apply_weighting``,
``_mean_all_but_batch``, and all sixteen losses with their aliases:
``L2Loss``, ``L1Loss``, ``SigmoidBinaryCrossEntropyLoss``/
``SigmoidBCELoss`` (with ``pos_weight``), ``SoftmaxCrossEntropyLoss``/
``SoftmaxCELoss``, ``KLDivLoss``, ``CTCLoss`` (the ``CTCLoss`` op of
:mod:`..ops.nn`), ``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``,
``LogisticLoss``, ``TripletLoss``, ``PoissonNLLLoss``,
``CosineEmbeddingLoss`` and ``SDMLLoss``, each the JAX formula. A loss
given NDArrays returns an NDArray (recorded under ``autograd.record()``),
given tensors a tensor. As in the JAX package, ``CTCLoss`` passes its
length arguments to the op without turning ``use_*_lengths`` on, so they
do not shorten the sequences.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ..ops.nn import ctc_loss
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


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


def _softrelu_neg_abs(pred):
    """``log(1 + exp(-|pred|))``, the stable tail of the logistic loss."""
    return tF.softplus(-pred.abs())


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (or, ``from_sigmoid``, of
    probabilities), with an optional ``pos_weight`` on the positive term
    (JAX counterpart: ``gluon/loss.py:70``)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label \
                    + _softrelu_neg_abs(pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu_neg_abs(pred) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - log_pred)`` (JAX counterpart:
    ``gluon/loss.py:127``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification over ``layout`` ``"NTC"`` or
    ``"TNC"`` activations (JAX counterpart: ``gluon/loss.py:142``)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"unsupported layout {layout}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = ctc_loss(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smoothed L1: quadratic within ``rho``, linear beyond (JAX
    counterpart: ``gluon/loss.py:164``)."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss.square())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class HingeLoss(Loss):
    """``relu(margin - pred * label)`` (JAX counterpart:
    ``gluon/loss.py:179``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)²`` (JAX counterpart:
    ``gluon/loss.py:191``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.relu(self._margin
                          - pred * label.reshape(pred.shape)).square()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class LogisticLoss(Loss):
    """Logistic loss of ``signed`` (-1/1) or ``binary`` (0/1) labels (JAX
    counterpart: ``gluon/loss.py:203``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError(f"unsupported label_format {label_format}")
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class TripletLoss(Loss):
    """``relu(|positive - pred|² - |negative - pred|² + margin)`` per
    sample (JAX counterpart: ``gluon/loss.py:222``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        axes = tuple(range(1, pred.dim()))
        loss = ((positive - pred).square().sum(dim=axes)
                - (negative - pred).square().sum(dim=axes) + self._margin)
        return _apply_weighting(torch.relu(loss), self._weight,
                                sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, the mean over every element, with
    Stirling's term under ``compute_full`` (JAX counterpart:
    ``gluon/loss.py:237``)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       epsilon=1e-08):
        label = label.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = (label * torch.log(label + epsilon) - label
                        + 0.5 * torch.log(2 * math.pi * (label + epsilon)))
            loss = loss + torch.where(label <= 1, 0.0, stirling)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``relu(cos - margin)`` otherwise (JAX
    counterpart: ``gluon/loss.py:259``)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        cos = ((input1 * input2).sum(dim=-1)
               / (input1.norm(dim=-1) * input2.norm(dim=-1) + 1e-12))
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: a smoothed cross-entropy over the
    squared distances between two batches of embeddings, row ``i``'s
    positive at column ``i`` (JAX counterpart: ``gluon/loss.py:274``)."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._sp = smoothing_parameter

    def hybrid_forward(self, F, x1, x2, sample_weight=None):
        n = x1.shape[0]
        sq1 = x1.square().sum(dim=1, keepdim=True)
        sq2 = x2.square().sum(dim=1, keepdim=True)
        d2 = sq1 + sq2.t() - 2.0 * (x1 @ x2.t())
        logp = torch.log_softmax(-d2, dim=-1)
        eye = torch.eye(n, dtype=x1.dtype, device=x1.device)
        smoothed = ((1.0 - self._sp) * eye
                    + (self._sp / max(n - 1, 1)) * (1.0 - eye))
        loss = -(smoothed * logp).sum(dim=-1)
        return _apply_weighting(loss, self._weight, sample_weight)
