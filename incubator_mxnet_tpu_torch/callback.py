"""Training callbacks of ``Module.fit``.

Counterpart: the JAX package's ``callback.py`` (a copy): ``Speedometer``
logs samples/s every ``frequent`` batches, ``do_checkpoint`` saves the
symbol and parameters at epoch ends, ``log_train_metric`` and
``LogValidationMetricsCallback`` log metrics. Each fits ``Module.fit``'s
batch or epoch callback slot.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "LogValidationMetricsCallback", "module_checkpoint"]


class Speedometer:
    """Log throughput (and the metric, reset when ``auto_reset``) every
    ``frequent`` batches."""

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param) -> None:
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (
                    time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = ("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                           "\t%s" % (param.epoch, count, speed, "\t".join(
                               f"{n}={v:.6f}" for n, v in name_value)))
                else:
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" % (
                        param.epoch, count, speed)
                logging.info(msg)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix: str, period: int = 1):
    """An epoch-end callback saving the symbol and parameters every
    ``period`` epochs (``prefix-symbol.json``, ``prefix-%04d.params``)."""
    period = int(period) if int(period) > 1 else 1

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            from . import model
            model.save_checkpoint(prefix, iter_no + 1, sym, arg or {},
                                  aux or {})
    return _callback


module_checkpoint = do_checkpoint


def log_train_metric(period: int, auto_reset: bool = False):
    """A batch-end callback logging the training metric every ``period``
    batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class LogValidationMetricsCallback:
    """An eval-end callback logging each validation metric."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
