"""Autograd: MXNet's recording scopes and backward over ``torch.autograd``.

Counterpart: the JAX package's ``autograd.py`` (``:46-360``). The JAX
package keeps its own tape of ``jax.vjp`` pullbacks; here the tape is
torch's graph. :func:`record` sets the flags that every ``NDArray`` op and
every Gluon forward on ``NDArray`` inputs read: under it they build the
graph (``torch.set_grad_enabled(True)``), outside it they build none.
Plain tensors stay on torch's own rules. :func:`is_training` is the one
training flag: ``Dropout`` is active only under it (``record()`` turns it
on, ``predict_mode()`` off; the default is off).

Gradients land where MXNet puts them, by ``grad_req``: ``'write'``
overwrites a variable's gradient with this backward's, ``'add'`` adds it.
``torch.Tensor.grad`` always accumulates, so :func:`backward` asks
``torch.autograd.grad`` for the gradients of every live variable (NDArrays
after ``attach_grad``, Gluon ``Parameter``\\ s) and deposits each one itself
into the variable's leaf ``.grad``, in place once that buffer exists (so an
array read from it stays current); a variable the heads do not reach keeps
its gradient. Only a backward marks a gradient fresh (the ``Trainer``'s
stale-gradient check reads the mark), as in the JAX ``_deposit``
(``:235-251``). ``grad(create_graph=True)`` waits for a later slice.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from .base import MXNetError, as_list

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()

#: every variable a backward may deposit into: an object with
#: ``_autograd_leaf`` (its leaf tensor, or None while it has none),
#: ``_autograd_req`` ('write' or 'add') and ``_fresh_grad``
_VARIABLES = weakref.WeakSet()
_VARIABLES_LOCK = threading.Lock()


def _register(var) -> None:
    with _VARIABLES_LOCK:
        _VARIABLES.add(var)


class _RecordingScope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec = recording
        self._train = training
        self._prev: Optional[tuple] = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev


def record(train_mode: bool = True) -> _RecordingScope:
    """Scope in which ``NDArray`` ops and Gluon forwards are recorded for
    :func:`backward`."""
    return _RecordingScope(True, train_mode)


def pause(train_mode: bool = False) -> _RecordingScope:
    """Scope in which recording is suspended."""
    return _RecordingScope(False, train_mode)


def train_mode() -> _RecordingScope:
    return _RecordingScope(None, True)


def predict_mode() -> _RecordingScope:
    return _RecordingScope(None, False)


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


def _tensor(x) -> torch.Tensor:
    return x._data if hasattr(x, "_data") else x


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make each array a variable whose gradient lands in the matching
    ``gradients`` array (MXAutogradMarkVariables parity)."""
    variables, gradients = as_list(variables), as_list(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var.attach_grad(req)
        var._data.grad = _tensor(g).detach()


def _heads(heads, head_grads):
    heads = as_list(heads)
    head_grads = as_list(head_grads) if head_grads is not None \
        else [None] * len(heads)
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        t = _tensor(h)
        if not t.requires_grad:
            raise MXNetError(
                "cannot differentiate: the head was not computed under "
                "autograd.record() from a variable (attach_grad or a "
                "Parameter)")
        outs.append(t)
        seeds.append(torch.ones_like(t) if hg is None
                     else _tensor(hg).to(t.dtype).expand_as(t))
    return outs, seeds


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Gradients of ``heads`` into every variable they reach, by its
    ``grad_req`` (JAX counterpart: ``autograd.py:169``). ``head_grads``
    default to ones."""
    outs, seeds = _heads(heads, head_grads)
    with _VARIABLES_LOCK:
        live = list(_VARIABLES)
    variables, leaves, seen = [], [], set()
    for var in live:
        leaf = var._autograd_leaf
        if leaf is not None and leaf.requires_grad and id(leaf) not in seen:
            seen.add(id(leaf))
            variables.append(var)
            leaves.append(leaf)
    if not leaves:
        return
    grads = torch.autograd.grad(outs, leaves, seeds,
                                retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for var, leaf, g in zip(variables, leaves, grads):
            if g is None:
                continue
            if leaf.grad is None:
                leaf.grad = g
            elif var._autograd_req == "add":
                leaf.grad.add_(g)
            else:
                leaf.grad.copy_(g)
            var._fresh_grad = True


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """The gradients of ``heads`` with respect to ``variables``, as new
    arrays; the variables' own gradients are left alone (JAX counterpart:
    ``autograd.py:319``). A variable the heads do not reach gets zeros."""
    from .ndarray import NDArray
    if create_graph:
        raise MXNetError("grad(create_graph=True) is not ported yet")
    outs, seeds = _heads(heads, head_grads)
    leaves = [_tensor(v) for v in as_list(variables)]
    grads = torch.autograd.grad(outs, leaves, seeds,
                                retain_graph=bool(retain_graph),
                                allow_unused=True)
    return [NDArray(g if g is not None else torch.zeros_like(leaf))
            for g, leaf in zip(grads, leaves)]
