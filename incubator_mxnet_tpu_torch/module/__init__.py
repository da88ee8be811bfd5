"""Module API: the MXNet 1.x symbolic training loop.

Counterpart: the JAX package's ``module/__init__.py`` (``BaseModule`` at
``:30``, ``Module`` at ``:131``), the loop of
``example/image-classification/train_mnist.py``: ``bind`` (one
:class:`~..symbol.Executor` by ``simple_bind``), ``init_params``,
``init_optimizer``, ``fit`` (``forward_backward``, ``update``,
``update_metric``, callbacks, ``score`` on ``eval_data``), ``predict``,
``get_params``/``set_params``, ``save_checkpoint``/``load`` and
``install_monitor``. ``update`` steps every parameter at once through
``Optimizer.update_multi``, as ``gluon.Trainer`` does, with the numbers of
the JAX Module's per-parameter ``update`` loop. One context: a list of
contexts takes its first, and the kvstore may be ``local`` or ``device``
(the others come with ROADMAP queue A, item 6). On the card the Executor
replays one CUDA graph for the training forward and backward and one for
the scoring forward (``Executor.captures``).
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as onp

from .. import initializer as init_mod
from .. import metric as metric_mod
from .. import model as model_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import Context, as_context, current_context
from ..ndarray import NDArray, array

__all__ = ["BaseModule", "Module"]


class BaseModule:
    """The training loop (JAX counterpart: ``module/__init__.py:30``)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore: str = "local", optimizer: str = "sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, initializer=None,
            arg_params=None, aux_params=None, allow_missing: bool = False,
            force_init: bool = False, begin_epoch: int = 0,
            num_epoch: Optional[int] = None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        if num_epoch is None:
            raise MXNetError("fit requires num_epoch")
        if not self.binded:
            self.bind(data_shapes=train_data.provide_data,
                      label_shapes=train_data.provide_label,
                      for_training=True)
        if not self.params_initialized or force_init:
            self.init_params(initializer or init_mod.Xavier(magnitude=2.0),
                             arg_params, aux_params, allow_missing,
                             force_init)
        if not self.optimizer_initialized:
            self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                optimizer_params=optimizer_params)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        if monitor is not None:
            self.install_monitor(monitor)

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for batch in train_data:
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(batch)
                if monitor is not None:
                    # before update(): the statistics of the weights the
                    # monitored forward used
                    monitor.toc_print()
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback is not None:
                    param = model_mod.BatchEndParam(
                        epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                        locals=None)
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    def forward_backward(self, data_batch) -> None:
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, reset=True):
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        if reset:
            eval_data.reset()
            eval_metric.reset()
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, reset=True) -> NDArray:
        """The first output of every batch, concatenated (padded rows
        included, as in the JAX package), on the module's context."""
        if reset:
            eval_data.reset()
        outs = []
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            self.forward(batch, is_train=False)
            outs.append(self.get_outputs()[0].asnumpy())
        return array(onp.concatenate(outs, axis=0),
                     ctx=getattr(self, "_ctx", None))


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class Module(BaseModule):
    """A single-executor Module (JAX counterpart:
    ``module/__init__.py:131``) on ``context`` (default: the current
    context, ``gpu(0)`` unless a ``with ctx:`` says otherwise)."""

    def __init__(self, symbol, data_names: Sequence[str] = ("data",),
                 label_names: Sequence[str] = ("softmax_label",),
                 logger=logging,
                 context: Union[Context, Sequence[Context], None] = None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        self.symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        ctx = context if context is not None else current_context()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]  # one card: a list of contexts takes its first
        self._ctx = as_context(ctx)
        self._exec = None
        self._optimizer = None
        self._opt_states: Dict[int, tuple] = {}
        self._arg_names: List[str] = []
        self._preloaded = None

    # -- bind / init -------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training: bool = True,
             inputs_need_grad: bool = False, force_rebind: bool = False,
             shared_module=None, grad_req: str = "write"):
        if self.binded and not force_rebind:
            return
        shapes = {}
        for desc in list(data_shapes) + list(label_shapes or []):
            name, shape = (desc.name, desc.shape) if hasattr(desc, "name") \
                else desc
            shapes[name] = tuple(shape)
        self._exec = self.symbol.simple_bind(
            ctx=self._ctx, grad_req=grad_req if for_training else "null",
            **shapes)
        self._arg_names = self.symbol.list_arguments()
        self._input_names = list(shapes)
        self._param_names = [n for n in self._arg_names
                             if n not in self._input_names]
        self.binded = True

    def install_monitor(self, mon) -> None:
        """Attach a :class:`~..monitor.Monitor` to the bound executor."""
        if not self.binded:
            raise MXNetError("call bind before install_monitor")
        mon.install(self._exec)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing: bool = False, force_init: bool = False,
                    allow_extra: bool = False):
        """Each parameter from ``arg_params`` (copied in place) or drawn by
        ``initializer`` (default ``Uniform(0.01)``) by its name."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if arg_params is None and self._preloaded:
            # Module.load: the checkpoint's parameters take the slot
            arg_params, aux_params = self._preloaded
        initializer = initializer or init_mod.Uniform(0.01)
        for name in self._param_names:
            if arg_params and name in arg_params:
                self._exec._write(name, arg_params[name])
            else:
                initializer(init_mod.InitDesc(name),
                            self._exec.arg_dict[name])
        self.params_initialized = True

    def get_params(self) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
        args = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        return args, dict(self._exec.aux_dict)

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    def init_optimizer(self, kvstore: str = "local", optimizer: str = "sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init: bool = False):
        """An optimizer from the registry (or the one given). The
        executor's backward yields batch-summed gradients, so
        ``rescale_grad`` is ``1 / batch_size`` unless given."""
        if kvstore not in (None, "local", "device"):
            raise MXNetError(f"kvstore {kvstore!r} needs the kvstore port "
                             "(ROADMAP queue A, item 6); one card takes "
                             "'local' or 'device'")
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            if "rescale_grad" not in params:
                batch_size = 0
                if self.binded and self._input_names:
                    first = self._exec.arg_dict.get(self._input_names[0])
                    if first is not None and first.ndim > 0:
                        batch_size = int(first.shape[0])
                if batch_size:
                    params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt_mod.create(optimizer, **params)
        self._optimizer = optimizer
        self._opt_states = {}
        self.optimizer_initialized = True

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train: Optional[bool] = None):
        feeds = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            feeds.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=bool(is_train), **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        """One optimizer step of every parameter with a gradient, as one
        ``update_multi`` call."""
        opt, exe = self._optimizer, self._exec
        idx, weights, grads = [], [], []
        for i, name in enumerate(self._param_names):
            g = exe.grad_dict.get(name)
            if g is None:
                continue
            w = exe.arg_dict[name]._data
            if i not in self._opt_states:
                self._opt_states[i] = opt.create_state_multi_precision(i, w)
            idx.append(i)
            weights.append(w)
            grads.append(g._data)
        if idx:
            opt.update_multi(idx, weights, grads,
                             [self._opt_states[i] for i in idx])

    def get_outputs(self, merge_multi_context: bool = True) -> List[NDArray]:
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context: bool = True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced: bool = False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self.symbol.list_outputs(), self._exec.outputs)))

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, prefix: str, epoch: int,
                        save_optimizer_states: bool = False):
        arg_params, aux_params = self.get_params()
        model_mod.save_checkpoint(prefix, epoch, self.symbol, arg_params,
                                  aux_params)

    @staticmethod
    def load(prefix: str, epoch: int, load_optimizer_states: bool = False,
             **kwargs) -> "Module":
        sym, arg_params, aux_params = model_mod.load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg_params, aux_params)
        return mod

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self.symbol.list_outputs()
