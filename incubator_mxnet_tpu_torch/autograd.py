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
(``:235-251``). The first deposit copies the gradient into a buffer of
the variable's own, so that a gradient a captured CUDA graph returns (a
hybridized block, :mod:`..gluon.block`) is never aliased by ``.grad``.
``grad(create_graph=True)`` records the backward, for higher orders.

The tape. The JAX package keeps one tape per thread: every op recorded
under :func:`record` puts its outputs on it (``_record_node``, ``:138``),
and a backward without ``retain_graph`` clears it (``clear_tape``,
``:147``). Here the tape is a generation number: an ``NDArray`` made by a
recorded op carries the generation it was made in, and a backward that
does not retain the graph starts a new one. So, as in the JAX package, an
array on the current tape refuses in-place mutation while recording
(``ndarray.py:184-189``, :meth:`~.ndarray.NDArray._check_inplace_ok`),
and a second ``backward()`` from heads whose tape was cleared deposits
nothing: each variable keeps the gradient it has, under ``grad_req``
``'write'`` and ``'add'`` alike (``autograd.py:224-225``).
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from .base import MXNetError, as_list

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.tape = 0               # generation of this thread's tape


_STATE = _State()

#: every variable a backward may deposit into, by ``id``: an object with
#: ``_autograd_leaf`` (its leaf tensor, or None while it has none),
#: ``_autograd_req`` ('write' or 'add') and ``_fresh_grad``. Keyed by id,
#: not a ``WeakSet``: a set compares an NDArray with ``==``, elementwise,
#: when the same array is registered again (a second ``attach_grad``)
_VARIABLES = weakref.WeakValueDictionary()
_VARIABLES_LOCK = threading.Lock()


def _register(var) -> None:
    with _VARIABLES_LOCK:
        _VARIABLES[id(var)] = var


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


def _tape_mark() -> Optional[int]:
    """The tape generation an op's output is made in: the current one
    while recording, else None (not on the tape)."""
    return _STATE.tape if _STATE.recording else None


def _on_tape(arr) -> bool:
    """Is ``arr`` an output of a recorded op whose tape no backward has
    cleared yet?"""
    mark = getattr(arr, "_tape", None)
    return mark is not None and mark == _STATE.tape


def _consumed(head) -> bool:
    """Was ``head`` recorded on a tape that a backward has cleared since?"""
    mark = getattr(head, "_tape", None)
    return mark is not None and mark != _STATE.tape


def _clear_tape() -> None:
    _STATE.tape += 1


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


def _live_heads(heads, head_grads):
    """``(head, head_grad)`` pairs of the heads still on the tape."""
    heads = as_list(heads)
    head_grads = as_list(head_grads) if head_grads is not None \
        else [None] * len(heads)
    return [(h, hg) for h, hg in zip(heads, head_grads) if not _consumed(h)]


def _heads(heads, head_grads):
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
    default to ones. Heads whose tape an earlier backward cleared reach
    nothing, as in the JAX package; without ``retain_graph`` this backward
    clears the tape."""
    live = _live_heads(heads, head_grads)
    if live:
        _deposit_grads(*zip(*live), retain_graph=retain_graph)
    if not retain_graph:
        _clear_tape()


def _deposit_grads(heads, head_grads, retain_graph: bool) -> None:
    outs, seeds = _heads(heads, head_grads)
    with _VARIABLES_LOCK:
        live = list(_VARIABLES.values())
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
                leaf.grad = torch.empty_like(leaf).copy_(g)
            elif var._autograd_req == "add":
                leaf.grad.add_(g)
            else:
                leaf.grad.copy_(g)
            var._fresh_grad = True


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """The gradients of ``heads`` with respect to ``variables``, as new
    arrays; the variables' own gradients are left alone (JAX counterpart:
    ``autograd.py:319``). A variable the heads do not reach gets zeros.
    With ``create_graph`` the backward is itself recorded (torch's
    ``create_graph=True``; ``retain_graph`` defaults to it), so the
    gradients can be differentiated again (JAX counterpart:
    ``_grad_create_graph``, ``:253``)."""
    from .ndarray.ndarray import NDArray, _recorded
    if retain_graph is None:
        # as in the reference, retain_graph defaults to create_graph
        retain_graph = create_graph
    leaves = [_tensor(v) for v in as_list(variables)]
    live = _live_heads(heads, head_grads)
    grads = [None] * len(leaves)
    if live:
        outs, seeds = _heads(*zip(*live))
        with torch.set_grad_enabled(create_graph or torch.is_grad_enabled()):
            grads = torch.autograd.grad(outs, leaves, seeds,
                                        retain_graph=bool(retain_graph),
                                        create_graph=create_graph,
                                        allow_unused=True)
    if not retain_graph:
        _clear_tape()
    # with create_graph the gradients are recorded heads: a later
    # backward() or grad() differentiates them again
    return [(_recorded if create_graph else NDArray)(
        g if g is not None else torch.zeros_like(leaf))
        for g, leaf in zip(grads, leaves)]


def get_symbol(x):
    """The symbol that computed ``x``: the eager tape records no graph of
    symbols, so this raises, as in the JAX package (``autograd.py:361``);
    ``hybridize()`` captures graphs."""
    raise MXNetError("get_symbol is not supported; hybridize() captures "
                     "graphs")
