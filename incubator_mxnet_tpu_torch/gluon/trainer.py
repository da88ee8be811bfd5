"""Trainer: the optimizer driver of the Gluon loop, on one device.

Counterpart: the JAX package's ``gluon/trainer.py`` (``:24-255``): the
parameters sorted by name (``:29-30``), ``step(batch_size)`` and
``update(batch_size)`` with ``rescale_grad = scale / batch_size``, the
stale-gradient protocol (``:184-217``: a gradient no backward has written
since the last update raises ``UserWarning``, or is skipped under
``ignore_stale_grad``), ``learning_rate``/``set_learning_rate`` and
``save_states``/``load_states``. Each parameter is updated once, even when
several blocks hold it (a tied weight). The kvstore seam is the JAX
package's (``_init_kvstore``, ``:27-90``), resolved at the first step:
``None``/``"local"``/``"device"``/``"nccl"`` exchange nothing (one device
holds one replica of each parameter); ``compression_params`` with one of
them, any other type name (``"dist_sync"``: sums across the ranks of the
process group) or a ``KVStore`` object route every gradient through the
store, the key batch in one ``push``/``pull``. ``update_on_kvstore`` is
kept as the JAX Trainer keeps it: the update runs here either way.

The update is multi-tensor: the parameters with a fresh gradient are
grouped by (device, dtype, fp32 master or not) and each group is one
``Optimizer.update_multi`` call on ``torch._foreach_*``, which writes
weights and states in place. Its numbers are those of the JAX package's
per-parameter ``Optimizer.update`` loop (``:184-217``), hyperparameters
and update counts resolved in index order as that loop resolves them.
``.states`` files are the JAX package's format (``:219-249``): a pickle of
``{"num_update": n, "states": {index: (numpy arrays)}}``, bfloat16 states
as :data:`~..ndarray.serialization.BFLOAT16`, as ``.params`` files carry
them; loading restores ``num_update`` and the states, and the update
counts of each index start again from ``begin_num_update``, as they do in
the JAX package. ``save_checkpoint``/``restore_checkpoint`` write and read
``mx.fault`` checkpoint directories in the JAX package's layout
(``:256-310``): parameters, states and the update count; a restore writes
each parameter in place, because a hybridized block's graphs read its
storage.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..ndarray.serialization import from_host, to_host
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies ``optimizer`` to ``params`` (a ``ParameterDict``, a dict or a
    list of Parameters) from their gradients (JAX counterpart:
    ``gluon/trainer.py:24``)."""

    def __init__(self, params, optimizer,
                 optimizer_params: Optional[dict] = None,
                 kvstore: Optional[str] = "device", compression_params=None,
                 update_on_kvstore: Optional[bool] = None):
        self._compression_params = compression_params
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        self._params: List[Parameter] = []
        seen = set()
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(param)}.")
            if id(param) not in seen:
                seen.add(id(param))
                self._params.append(param)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt_mod.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states: Dict[int, tuple] = {}

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self) -> opt_mod.Optimizer:
        return self._optimizer

    def set_learning_rate(self, lr: float) -> None:
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self) -> None:
        """Resolve the exchange at the first step (module docstring; JAX
        counterpart: ``gluon/trainer.py:67-90``)."""
        from .. import kvstore as kv
        kt = self._kvstore_type
        if kt and not isinstance(kt, str):
            self._kvstore = kt              # a store object
        elif kt in (None, "local", "device", "nccl"):
            # the inline exchange has no compression stage: a request for
            # one takes a real store rather than being dropped
            self._kvstore = (kv.create(kt or "device")
                             if self._compression_params else None)
        else:
            self._kvstore = kv.create(kt)
        if self._kvstore is not None:
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            for i, param in enumerate(self._params):
                if param._initialized:
                    self._kvstore.init(i, param.data())
        self._kv_initialized = True

    def allreduce_grads(self) -> None:
        """Exchange the gradients through the kvstore: every key with a
        gradient in one ``push`` and one ``pull`` (the store sums them in
        one collective); without a store one device holds one replica and
        there is nothing to do."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None:
            return
        items = [(i, p.grad()) for i, p in enumerate(self._params)
                 if p.grad_req != "null" and p._initialized]
        if items:
            keys = [i for i, _ in items]
            grads = [g for _, g in items]
            self._kvstore.push(keys, grads)
            self._kvstore.pull(keys, out=grads)

    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Reduce the gradients and update every parameter, the gradients
        scaled by ``1 / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size: int, ignore_stale_grad: bool = False
               ) -> None:
        """The update alone, for gradients already reduced."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad: bool = False) -> None:
        opt = self._optimizer
        fresh = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or not param._initialized:
                continue
            if not param._fresh_grad:
                if not ignore_stale_grad:
                    raise UserWarning(
                        f"Gradient of Parameter `{param.name}` on context "
                        f"{param.list_ctx()} has not been updated by "
                        "backward since last `step`. This could mean a bug "
                        "in your model that made it only use a subset of "
                        "the Parameters (Blocks) for this iteration. If you "
                        "are intentionally only using a subset, call step "
                        "with ignore_stale_grad=True to suppress this "
                        "warning")
                continue
            if i not in self._states:
                self._states[i] = opt.create_state_multi_precision(
                    i, param._var.detach())
            fresh.append(i)
        if not fresh:
            return
        lrs, wds, ts = opt._hparams(fresh)
        weights = [self._params[i]._var for i in fresh]
        states = [self._states[i] for i in fresh]
        for group in opt_mod.update_groups(opt, weights, states):
            opt.update_multi([fresh[k] for k in group],
                             [weights[k] for k in group],
                             [weights[k].grad for k in group],
                             [states[k] for k in group],
                             lr=[lrs[k] for k in group],
                             wd=[wds[k] for k in group],
                             t=[ts[k] for k in group])
        for i in fresh:
            self._params[i]._fresh_grad = False

    def save_states(self, fname: str) -> None:
        """Write the update count and the optimizer states in the JAX
        package's format (atomic: a crash mid-write never clobbers an
        existing file)."""
        blob = {"num_update": self._optimizer.num_update,
                "states": {i: tuple(to_host(s) for s in st)
                           for i, st in self._states.items()}}
        tmp = f"{fname}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(blob, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, fname)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load_states(self, fname: str) -> None:
        """Read a ``.states`` file of either package; each state lands on
        its parameter's device. Restores ``num_update``, not the update
        counts of each index (JAX counterpart: ``gluon/trainer.py:243``).
        """
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        self._optimizer.num_update = blob["num_update"]
        self._states = {
            i: tuple(from_host(s, self._params[i]._var.device) for s in st)
            for i, st in blob["states"].items()}


    def save_checkpoint(self, root: str, keep: Optional[int] = 3) -> str:
        """One atomic checkpoint directory under ``root``: parameters,
        optimizer states and the update count, under the update count;
        prunes to the newest ``keep`` (JAX counterpart:
        ``gluon/trainer.py:256``)."""
        from ..fault import checkpoint as ckpt
        arrays = {}
        for i, p in enumerate(self._params):
            if not p._initialized:
                raise MXNetError(
                    f"parameter {p.name!r} is uninitialized; initialize "
                    "before save_checkpoint")
            arrays[f"param:{i:04d}"] = to_host(p._var)
            for j, s in enumerate(self._states.get(i, ())):
                arrays[f"opt:{i:04d}:{j}"] = to_host(s)
        meta = {
            "trainer": "Trainer", "format": 1,
            "num_update": self._optimizer.num_update,
            "param_names": [p.name for p in self._params],
            "opt_state_sizes": [len(self._states.get(i, ()))
                                for i in range(len(self._params))],
        }
        return ckpt.save_checkpoint(root, arrays, meta,
                                    step=self._optimizer.num_update,
                                    keep=keep)

    def restore_checkpoint(self, root: str, step: Optional[int] = None
                           ) -> int:
        """Restore parameters (in place), optimizer states and the update
        count from the newest verified checkpoint under ``root`` (or
        ``step``), written by either package (JAX counterpart:
        ``gluon/trainer.py:282``). As there, each index's own update count
        is left as it is."""
        from ..fault import checkpoint as ckpt
        if step is None:
            arrays, meta, step = ckpt.load_latest(root)
        else:
            arrays, meta, step = ckpt.load_checkpoint(root, step)
        if meta.get("trainer") != "Trainer" or meta.get("format") != 1:
            raise MXNetError(
                f"checkpoint step {step} was not written by "
                "gluon.Trainer.save_checkpoint")
        if len(meta.get("param_names", [])) != len(self._params):
            raise MXNetError(
                "checkpoint parameter count does not match this Trainer: "
                f"saved {len(meta.get('param_names', []))}, "
                f"live {len(self._params)}")
        sizes = meta["opt_state_sizes"]
        for i, p in enumerate(self._params):
            v = arrays[f"param:{i:04d}"]
            if tuple(v.shape) != tuple(p.shape):
                raise MXNetError(
                    f"checkpoint array for parameter {p.name!r} is shape "
                    f"{tuple(v.shape)}, live parameter is {tuple(p.shape)}")
            dev = p._var.device
            p.set_data(from_host(v, dev))
            if sizes[i]:
                self._states[i] = tuple(
                    from_host(arrays[f"opt:{i:04d}:{j}"], dev)
                    for j in range(sizes[i]))
            else:
                self._states.pop(i, None)
        self._optimizer.num_update = int(meta["num_update"])
        return step
