"""``Estimator``: the packaged Gluon fit loop, and its event handlers.

Counterpart: the JAX package's ``gluon/contrib/estimator.py``:
``Estimator(net, loss, train_metrics, trainer).fit(train_data, val_data,
epochs, event_handlers, batches)`` and ``evaluate``, with the handler
interfaces (``TrainBegin`` ... ``BatchEnd``), ``CheckpointHandler``
(``.params`` and ``.states`` files each epoch, or the best by a monitored
training metric), ``EarlyStoppingHandler`` and ``LoggingHandler``. It
runs on ``autograd``, ``metric`` and ``gluon.Trainer``.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

from ... import autograd
from ... import metric as metric_mod
from ..trainer import Trainer

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "CheckpointHandler",
           "EarlyStoppingHandler", "LoggingHandler"]


class TrainBegin:
    def train_begin(self, estimator):
        pass


class TrainEnd:
    def train_end(self, estimator):
        pass


class EpochBegin:
    def epoch_begin(self, estimator):
        pass


class EpochEnd:
    def epoch_end(self, estimator):
        pass


class BatchBegin:
    def batch_begin(self, estimator, batch):
        pass


class BatchEnd:
    def batch_end(self, estimator, batch, loss):
        pass


def _resolve_monitor(handler, estimator, monitor):
    """Shared monitor→train-metric lookup with a one-shot warning when
    nothing matches (used by Checkpoint/EarlyStopping handlers)."""
    for m in estimator.train_metrics:
        if monitor in (None, m.name):
            return m.get()[1]
    if not getattr(handler, "_warned", False):
        handler._warned = True
        estimator.logger.warning(
            "%s: monitor %r matches no train metric (available: %s) — the "
            "handler is inactive", type(handler).__name__, monitor,
            [m.name for m in estimator.train_metrics])
    return None


class CheckpointHandler(TrainBegin, EpochEnd):
    """Save parameters (+ trainer states) each epoch; with ``save_best`` keep
    only the best by a monitored metric (reference:
    estimator/event_handler.py CheckpointHandler)."""

    def __init__(self, model_dir: str, model_prefix: str = "model",
                 monitor: Optional[str] = None, mode: str = "min",
                 save_best: bool = False):
        import os
        os.makedirs(model_dir, exist_ok=True)
        if monitor is not None and not save_best:
            raise ValueError(
                "CheckpointHandler: monitor= only takes effect with "
                "save_best=True (every epoch is saved otherwise)")
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self._mode = mode
        self._better = (lambda a, b: a < b) if mode == "min" \
            else (lambda a, b: a > b)
        self.best = float("inf") if mode == "min" else -float("inf")
        self.saved: List[str] = []

    def train_begin(self, estimator):
        # handlers are reusable across fit() calls: monitoring state resets,
        # and `saved` reflects THIS run's checkpoints only
        self.best = float("inf") if self._mode == "min" else -float("inf")
        self._warned = False
        self.saved = []

    def epoch_end(self, estimator):
        import os
        stem = os.path.join(
            self.model_dir, f"{self.model_prefix}-{estimator.epoch:04d}")
        if self.save_best:
            cur = _resolve_monitor(self, estimator, self.monitor)
            if cur is None or not self._better(cur, self.best):
                return
            self.best = cur
            stem = os.path.join(self.model_dir, f"{self.model_prefix}-best")
        estimator.net.save_parameters(stem + ".params")
        estimator.trainer.save_states(stem + ".states")
        self.saved.append(stem + ".params")


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stop training when the monitored metric stops improving
    (reference: EarlyStoppingHandler — sets estimator.stop_training, which
    the fit loop checks at both batch and epoch boundaries)."""

    def __init__(self, monitor: Optional[str] = None, mode: str = "min",
                 patience: int = 0, min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self._mode = mode
        self._better = (lambda a, b: a < b - min_delta) if mode == "min" \
            else (lambda a, b: a > b + min_delta)
        self.best = float("inf") if mode == "min" else -float("inf")
        self.wait = 0
        self.stopped_epoch: Optional[int] = None

    def train_begin(self, estimator):
        self.best = float("inf") if self._mode == "min" else -float("inf")
        self.wait = 0
        self.stopped_epoch = None
        self._warned = False

    def epoch_end(self, estimator):
        cur = _resolve_monitor(self, estimator, self.monitor)
        if cur is None:
            return
        if self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait > self.patience:
            estimator.stop_training = True
            self.stopped_epoch = estimator.epoch


class LoggingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Per-interval batch/epoch logging (reference: LoggingHandler)."""

    def __init__(self, log_interval: int = 50):
        self.log_interval = log_interval
        self._batch = 0

    def train_begin(self, estimator):
        # an aborted fit() (stop_training mid-epoch) never reaches epoch_end,
        # so the counter must also reset here for handler reuse across fits
        self._batch = 0

    def batch_end(self, estimator, batch, loss):
        self._batch += 1
        if self._batch % self.log_interval == 0:
            estimator.logger.info(
                "Epoch[%d] Batch[%d] loss=%.4f %s", estimator.epoch,
                self._batch, float(loss.asnumpy()),
                " ".join(f"{m.name}={m.get()[1]:.4f}"
                         for m in estimator.train_metrics))

    def epoch_end(self, estimator):
        self._batch = 0


class Estimator:
    def __init__(self, net, loss, train_metrics=None,
                 trainer: Optional[Trainer] = None, context=None,
                 logger=None):
        self.net = net
        self.loss = loss
        import copy
        mets = train_metrics or [metric_mod.Accuracy()]
        self.train_metrics = mets if isinstance(mets, (list, tuple)) \
            else [mets]
        # validation gets its OWN metric instances (reference keeps
        # val_metrics separate) so evaluate() never clobbers the training
        # values the epoch_end handlers monitor
        self.val_metrics = [copy.deepcopy(m) for m in self.train_metrics]
        self.trainer = trainer or Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        self.logger = logger or logging.getLogger("estimator")
        self.epoch = 0
        self.stop_training = False  # handlers may set (EarlyStoppingHandler)

    def _batch_fn(self, batch):
        data = batch.data[0] if hasattr(batch, "data") else batch[0]
        label = batch.label[0] if hasattr(batch, "label") else batch[1]
        return data, label

    def evaluate(self, val_data, metrics=None):
        metrics = metrics or self.val_metrics
        for m in metrics:
            m.reset()
        val_data.reset()
        for batch in val_data:
            data, label = self._batch_fn(batch)
            with autograd.predict_mode():
                out = self.net(data)
            for m in metrics:
                m.update(label, out)
        return [(m.name, m.get()[1]) for m in metrics]

    def fit(self, train_data, val_data=None, epochs: int = 1,
            event_handlers: Sequence = (), batches: Optional[int] = None):
        handlers = list(event_handlers)
        self.stop_training = False
        for h in handlers:
            if isinstance(h, TrainBegin):
                h.train_begin(self)
        for epoch in range(epochs):
            if self.stop_training:
                break
            self.epoch = epoch
            for m in self.train_metrics:
                m.reset()
            for h in handlers:
                if isinstance(h, EpochBegin):
                    h.epoch_begin(self)
            train_data.reset()
            t0 = time.time()
            n = 0
            for batch in train_data:
                if batches is not None and n >= batches:
                    break
                if self.stop_training:   # a BatchEnd guard (e.g. NaN stop)
                    break
                for h in handlers:
                    if isinstance(h, BatchBegin):
                        h.batch_begin(self, batch)
                data, label = self._batch_fn(batch)
                bs = data.shape[0]
                with autograd.record():
                    out = self.net(data)
                    loss = self.loss(out, label).mean()
                loss.backward()
                self.trainer.step(bs)
                for m in self.train_metrics:
                    m.update(label, out)
                for h in handlers:
                    if isinstance(h, BatchEnd):
                        h.batch_end(self, batch, loss)
                n += 1
            if self.stop_training:
                # set by a batch handler this epoch (the top-of-epoch check
                # broke out otherwise), even on the final/capped batch,
                # where the in-loop check is never re-reached. Partial-epoch
                # metrics must not reach epoch_end handlers: a
                # CheckpointHandler would save the diverged weights as a
                # healthy per-epoch checkpoint
                break
            msg = f"Epoch[{epoch}] {time.time() - t0:.1f}s " + " ".join(
                f"train-{m.name}={m.get()[1]:.4f}" for m in self.train_metrics)
            if val_data is not None:
                msg += " " + " ".join(
                    f"val-{name}={v:.4f}"
                    for name, v in self.evaluate(val_data))
            self.logger.info(msg)
            for h in handlers:
                if isinstance(h, EpochEnd):
                    h.epoch_end(self)
        for h in handlers:
            if isinstance(h, TrainEnd):
                h.train_end(self)
        return self
