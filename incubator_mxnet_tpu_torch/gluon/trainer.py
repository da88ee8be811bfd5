"""Trainer: the optimizer driver of the Gluon loop, on one device.

Counterpart: the JAX package's ``gluon/trainer.py`` (``:24-255``): the
parameters sorted by name (``:29-30``), ``step(batch_size)`` and
``update(batch_size)`` with ``rescale_grad = scale / batch_size``, the
stale-gradient protocol (``:184-217``: a gradient no backward has written
since the last update raises ``UserWarning``, or is skipped under
``ignore_stale_grad``), ``learning_rate``/``set_learning_rate`` and
``save_states``/``load_states``. Each parameter is updated once, even when
several blocks hold it (a tied weight). ``allreduce_grads`` has nothing to
reduce on one device; the kvstore seam comes with the multi-GPU slice.
Each parameter is updated on its own, eagerly, as
``parallel.ShardedTrainer`` does.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies ``optimizer`` to ``params`` (a ``ParameterDict``, a dict or a
    list of Parameters) from their gradients (JAX counterpart:
    ``gluon/trainer.py:24``)."""

    def __init__(self, params, optimizer,
                 optimizer_params: Optional[dict] = None,
                 kvstore: Optional[str] = "device"):
        if kvstore not in (None, "local", "device"):
            raise MXNetError(f"kvstore {kvstore!r} is not ported yet: one "
                             "device, nothing to reduce")
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

    def allreduce_grads(self) -> None:
        """Sum gradients across replicas: one device holds one replica, so
        there is nothing to do."""

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
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad: bool = False) -> None:
        opt = self._optimizer
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
            weight = param._var
            if i not in self._states:
                self._states[i] = opt.create_state_multi_precision(
                    i, weight.detach())
            self._states[i] = opt.update(i, weight, param.grad(),
                                         self._states[i])
            param._fresh_grad = False

    def save_states(self, fname: str) -> None:
        """Write the update count and the optimizer states (atomic: a crash
        mid-write never clobbers an existing file)."""
        blob = {"num_update": self._optimizer.num_update,
                "index_update_count":
                    dict(self._optimizer._index_update_count),
                "states": {i: tuple(s.detach().cpu() for s in st)
                           for i, st in self._states.items()}}
        tmp = f"{fname}.tmp-{os.getpid()}"
        try:
            torch.save(blob, tmp)
            os.replace(tmp, fname)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load_states(self, fname: str) -> None:
        """Read what :meth:`save_states` wrote; each state lands on its
        parameter's device."""
        blob = torch.load(fname, map_location="cpu")
        self._optimizer.num_update = blob["num_update"]
        self._optimizer._index_update_count = dict(
            blob["index_update_count"])
        self._states = {
            i: tuple(s.to(self._params[i]._var.device) for s in st)
            for i, st in blob["states"].items()}
