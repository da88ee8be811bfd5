"""Evaluation metrics, ``mx.metric`` (JAX counterpart: ``metric.py``, the
whole file; it imports no JAX, and the port keeps its own copy).

Accumulation runs on the host in numpy: ``update`` takes NDArrays,
tensors or numpy arrays, and reading a device array waits for the card, as
the reference's ``asnumpy`` does. ``create`` takes a registered name (or
alias: ``acc``, ``ce``, ``nll_loss``), a metric, a list of them (a
composite) or a function ``feval(label, pred)``. ``Percentile`` keeps its
samples in the reservoir of :class:`..serve.metrics.Histogram`.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as onp
import torch

from .base import MXNetError, as_list as _as_list
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE",
           "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "Loss", "Percentile",
           "CompositeEvalMetric", "create"]

class _Registry:
    """Metric classes by lower-cased name, with aliases (JAX counterpart:
    ``base.py:84``, ``Registry``)."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, type] = {}

    def register(self, klass: type) -> type:
        self._entries[klass.__name__.lower()] = klass
        return klass

    def alias(self, existing: str, *aliases: str) -> None:
        for a in aliases:
            self._entries[a.lower()] = self._entries[existing.lower()]

    def create(self, name: str, *args, **kwargs):
        entry = self._entries.get(str(name).lower())
        if entry is None:
            raise MXNetError(f"{self.name} registry has no entry '{name}'. "
                             f"Known: {sorted(self._entries)}")
        return entry(*args, **kwargs)


_registry = _Registry("metric")
register = _registry.register


def create(metric, *args, **kwargs):
    """A metric from a name, a metric, a list of them or a function (JAX
    counterpart: ``metric.py:25``)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    return _registry.create(metric, *args, **kwargs)


def _np(x) -> onp.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return onp.asarray(x)


class EvalMetric:
    def __init__(self, name: str, output_names=None, label_names=None):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label: dict, pred: dict):
        """Name-keyed update (reference: EvalMetric.update_dict, used by
        Module.update_metric)."""
        if self.output_names is not None:
            preds = [pred[n] for n in self.output_names if n in pred]
        else:
            preds = list(pred.values())
        if self.label_names is not None:
            labels = [label[n] for n in self.label_names if n in label]
        else:
            labels = list(label.values())
        self.update(labels, preds)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        return list(zip(_as_list(name), _as_list(value)))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kw):
        super().__init__(name, **kw)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _np(pred)
            label = _np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(onp.int64).reshape(-1)
            label = label.astype(onp.int64).reshape(-1)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kw):
        super().__init__(f"{name}_{top_k}", **kw)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _np(pred)
            label = _np(label).astype(onp.int64).reshape(-1)
            topk = onp.argsort(-pred, axis=-1)[:, : self.top_k]
            hit = (topk == label[:, None]).any(axis=1)
            self.sum_metric += float(hit.sum())
            self.num_inst += len(label)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kw):
        super().__init__(name, **kw)
        self.average = average

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _np(pred)
            label = _np(label).reshape(-1).astype(onp.int64)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.reshape(-1).astype(onp.int64)
            self.tp += float(((pred == 1) & (label == 1)).sum())
            self.fp += float(((pred == 1) & (label == 0)).sum())
            self.fn += float(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1e-12)
        rec = self.tp / max(self.tp + self.fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return (self.name, f1 if self.num_inst else float("nan"))


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient for binary classification
    (reference: metric.py MCC)."""

    def __init__(self, name="mcc", **kw):
        super().__init__(name, **kw)

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = self.tn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _np(pred)
            label = _np(label).reshape(-1).astype(onp.int64)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.reshape(-1).astype(onp.int64)
            self.tp += float(((pred == 1) & (label == 1)).sum())
            self.fp += float(((pred == 1) & (label == 0)).sum())
            self.fn += float(((pred == 0) & (label == 1)).sum())
            self.tn += float(((pred == 0) & (label == 0)).sum())
            self.num_inst += len(label)

    def get(self):
        num = self.tp * self.tn - self.fp * self.fn
        den = ((self.tp + self.fp) * (self.tp + self.fn)
               * (self.tn + self.fp) * (self.tn + self.fn)) ** 0.5
        val = num / den if den > 0 else 0.0
        return (self.name, val if self.num_inst else float("nan"))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            l, p = _np(label), _np(pred)
            self.sum_metric += float(onp.abs(l - p.reshape(l.shape)).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            l, p = _np(label), _np(pred)
            self.sum_metric += float(((l - p.reshape(l.shape)) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kw):
        super().__init__(name=name, **kw)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(onp.sqrt(self.sum_metric / self.num_inst)))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kw):
        super().__init__(name, **kw)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _np(label).astype(onp.int64).reshape(-1)
            pred = _np(pred).reshape(len(label), -1)
            prob = pred[onp.arange(len(label)), label]
            self.sum_metric += float(-onp.log(prob + self.eps).sum())
            self.num_inst += len(label)


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kw):
        super().__init__(eps=eps, name=name, **kw)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kw):
        super().__init__(name=name, **kw)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _np(label).astype(onp.int64).reshape(-1)
            pred = _np(pred).reshape(len(label), -1)
            prob = pred[onp.arange(len(label)), label]
            if self.ignore_label is not None:
                keep = label != self.ignore_label
                prob = prob[keep]
            self.sum_metric += float(-onp.log(prob + self.eps).sum())
            self.num_inst += len(prob)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(onp.exp(self.sum_metric / self.num_inst)))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kw):
        super().__init__(name, **kw)

    def reset(self):
        super().reset()
        self._labels: List[onp.ndarray] = []
        self._preds: List[onp.ndarray] = []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_np(label).reshape(-1))
            self._preds.append(_np(pred).reshape(-1))
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return (self.name, float("nan"))
        l = onp.concatenate(self._labels)
        p = onp.concatenate(self._preds)
        return (self.name, float(onp.corrcoef(l, p)[0, 1]))


@register
class Percentile(EvalMetric):
    """Streaming percentile summary over scalar samples (latency metrics).

    ``update(None, values)`` accumulates samples (NDArray / numpy / floats);
    ``get`` returns ``([name_p50, name_p95, ...], [values...])`` using
    nearest-rank percentiles over a bounded uniform reservoir.
    Deterministically seeded; mean/count are exact regardless of the cap.

    The reservoir and percentile math is :class:`..serve.metrics.Histogram`,
    the one the serving counters use.
    """

    def __init__(self, q=(50, 95, 99), name="latency", reservoir=8192, **kw):
        self.q = tuple(q)
        self.reservoir = int(reservoir)
        super().__init__(name, **kw)

    def reset(self):
        super().reset()
        from .serve.metrics import Histogram
        self._hist = Histogram(name=self.name, q=self.q,
                               reservoir=self.reservoir, seed=0)

    def update(self, labels, preds):
        for pred in _as_list(preds):
            vals = _np(pred).reshape(-1)
            self.sum_metric += float(vals.sum())
            self.num_inst += vals.size
            for v in vals:
                self._hist.observe(float(v))

    def percentile(self, q: float) -> float:
        return self._hist.percentile(q)

    def get(self):
        names = [f"{self.name}_p{q:g}" for q in self.q] + [f"{self.name}_mean"]
        if self.num_inst == 0:
            return (names, [float("nan")] * len(names))
        vals = [self.percentile(q) for q in self.q]
        vals.append(self.sum_metric / self.num_inst)
        return (names, vals)


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kw):
        super().__init__(name, **kw)

    def update(self, _, preds):
        for pred in _as_list(preds):
            p = _np(pred)
            self.sum_metric += float(p.sum())
            self.num_inst += p.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kw):
        super().__init__(f"custom({name})", **kw)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            out = self._feval(_np(label), _np(pred))
            if isinstance(out, tuple):
                s, n = out
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += out
                self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kw):
        super().__init__(name, **kw)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(_as_list(n))
            values.extend(_as_list(v))
        return (names, values)


_registry.alias("accuracy", "acc")
_registry.alias("crossentropy", "ce")
_registry.alias("negativeloglikelihood", "nll_loss")
