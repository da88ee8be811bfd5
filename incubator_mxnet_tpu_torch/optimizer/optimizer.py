"""Optimizers over tensors.

Counterpart: the JAX package's ``optimizer/optimizer.py``: the registry
(``create`` ``:34``), the ``Optimizer`` base (``:40-146``: learning rate,
its ``lr_scheduler`` and per-parameter multipliers (``param_dict``,
``set_lr_mult``/``set_wd_mult``, ``idx2name``), weight decay,
``rescale_grad`` (which ``gluon.Trainer.step`` sets to ``scale /
batch_size``), ``clip_gradient``, ``multi_precision``, the update counts
from ``begin_num_update``, ``create_state_multi_precision``, the pure
``step`` and the in-place ``update``), ``SGD`` with momentum (``:150``),
``Adam`` (``:184``), ``AdamW`` (``:203-212``), the thirteen others
(``NAG``, ``RMSProp``, ``AdaGrad``, ``AdaDelta``, ``FTRL``/``Ftrl``,
``Signum``, ``LAMB``, ``LARS``, ``DCASGD``, ``SGLD``, ``Adamax``,
``Nadam``, ``FTML``, ``:169-516``) and ``Updater`` / ``get_updater``
(``:517-546``). ``step(w, g, state, lr, wd, t)`` is pure:
it returns the new weight and state and changes nothing; ``update`` writes
the new weight into the parameter.

Every optimizer here writes its rule once (``_rule``), over :class:`_L`:
the tensors of several parameters, with arithmetic on
``torch._foreach_*``, writing the new weights and states in place.
``update_multi(indices, weights, grads, states)`` runs it on a group's
own tensors (weights or fp32 masters, and states), so each is written
once a step and stays where a CUDA graph captured it; ``step`` runs it on
copies of one parameter's, so it stays pure, and the two give the same
bits. Its ``lr`` and ``t`` may be device tensors: then the bias
corrections ``1 - beta ** t`` are computed on the device in float32, as
the JAX package's compiled step computes them from its float32 ``t``
(``parallel/trainer.py:441-481``), and the update reads no host value,
so the fused ``parallel.ShardedTrainer`` step captures it. For an
integer ``t`` the scalars are the JAX package's ``Optimizer.update``'s,
in Python floats.
``update_multi`` turns each per-parameter scalar (``lr``, ``wd``, ``t``)
into one value, a host number or a device scalar, or else a list of them
(:func:`_collapse`), and the rules map over that form (:func:`_sc`).
LAMB and LARS take their per-tensor norms from one ``torch._foreach_norm``
each. SGLD draws its noise from a ``torch.Generator`` of its own per
device (:meth:`Optimizer.generators`; ``ShardedTrainer`` registers them
with its graph); its stream is not the JAX package's threefry stream.

One difference in form: with ``multi_precision`` the JAX
package creates the states in the weight's dtype (bfloat16) and its first
step promotes them to float32 (``0.9 * m_bf16 + 0.1 * g_f32``,
``parallel/trainer.py:473``); here they are float32 from the start, like
the master weight. They start at zero (or at the weight), so both give the
same values, but where the JAX package rounds a first-step value to
bfloat16 before the promotion (AdaDelta's ``sqrt(0 + eps)``, 1.2e-5 off
after one step).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "RMSProp",
           "AdaGrad", "AdaDelta", "FTRL", "Ftrl", "Signum", "LAMB", "LARS",
           "DCASGD", "SGLD", "Adamax", "Nadam", "FTML", "Updater",
           "register", "create", "get_updater", "update_groups"]

_HALF = (torch.float16, torch.bfloat16)

_registry: Dict[str, type] = {}


def register(klass: type) -> type:
    """Register an optimizer class under its lower-cased name."""
    _registry[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    """An optimizer by registered name (case-insensitive), or ``name``
    itself when it is one already (JAX counterpart: ``optimizer.py:34``)."""
    if isinstance(name, Optimizer):
        return name
    klass = _registry.get(str(name).lower())
    if klass is None:
        raise MXNetError(f"optimizer registry has no entry '{name}'. "
                         f"Known: {sorted(_registry)}")
    return klass(**kwargs)


def _uses_master(multi_precision: bool, weight: torch.Tensor, state) -> bool:
    """Does ``weight`` update through the fp32 master ``state[0]``?"""
    return bool(multi_precision and weight.dtype in _HALF and state
                and state[0].dtype == torch.float32
                and state[0].shape == weight.shape)


def update_groups(optimizer: "Optimizer", weights: Sequence[torch.Tensor],
                  states: Sequence[tuple]) -> List[List[int]]:
    """Positions of ``weights`` grouped by (device, dtype, fp32 master or
    not), in order of first appearance: the groups whose update one
    ``update_multi`` call runs on the fast multi-tensor path."""
    groups: Dict[tuple, List[int]] = {}
    for pos, (w, s) in enumerate(zip(weights, states)):
        key = (w.device, w.dtype,
               _uses_master(optimizer.multi_precision, w, s))
        groups.setdefault(key, []).append(pos)
    return list(groups.values())


class Optimizer:
    """Base optimizer; state is a tuple of tensors per parameter (JAX
    counterpart: ``optimizer.py:40``)."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, lr_scheduler=None, multi_precision=False,
                 param_dict=None, begin_num_update=0, **kwargs):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision
        #: index -> Parameter (its lr_mult / wd_mult), set by the Trainer
        self.param_dict = param_dict or {}
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.idx2name: Dict[int, str] = {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr) -> None:
        if self.lr_scheduler is not None:
            raise MXNetError("learning rate is managed by the LRScheduler")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]) -> None:
        """Learning-rate multipliers by parameter index or name."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]) -> None:
        """Weight-decay multipliers by parameter index or name."""
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index) -> None:
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr: str, table: Dict[Any, float]) -> float:
        """A parameter's ``lr_mult``/``wd_mult``: from its Parameter, else
        by index, else by name (JAX counterpart: ``optimizer.py:88-105``)."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def create_state(self, index, weight: torch.Tensor) -> Tuple:
        return ()

    def create_state_multi_precision(self, index, weight: torch.Tensor
                                     ) -> Tuple:
        """``(fp32 master,) + state`` for a float16/bfloat16 weight under
        ``multi_precision``, the state built on the master (so float32),
        else the weight's own state."""
        if self.multi_precision and weight.dtype in (torch.float16,
                                                     torch.bfloat16):
            master = weight.detach().float()
            return (master,) + self.create_state(index, master)
        return self.create_state(index, weight)

    def generators(self) -> List[torch.Generator]:
        """The generators the update draws from (none but SGLD's)."""
        return []

    def step(self, w, g, state, lr, wd, t):
        """Pure update rule ``-> (new_weight, new_state)``; subclasses
        implement it."""
        raise NotImplementedError

    def update(self, index, weight, grad, state) -> Tuple:
        """One update of ``weight`` (an NDArray or tensor, written in
        place) from ``grad``; returns the new state (JAX counterpart:
        ``optimizer.py:126``). A float16/bfloat16 weight whose state starts
        with a float32 master is updated through the master."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w, g = getattr(weight, "_data", weight), getattr(grad, "_data", grad)
        with torch.no_grad():
            if _uses_master(self.multi_precision, w, state):
                master, rest = self.step(state[0], g.float(), state[1:], lr,
                                         wd, t)
                w.copy_(master)
                return (master,) + tuple(rest)
            new_w, new_state = self.step(w, g.to(w.dtype), state, lr, wd, t)
            w.copy_(new_w)
            return tuple(new_state)

    update_multi_precision = update

    # -- multi-tensor update ---------------------------------------------
    def _hparams(self, indices) -> Tuple[list, list, list]:
        """``(lrs, wds, ts)`` of one update of each index, counted in
        order, as a loop of :meth:`update` would count them."""
        lrs, wds, ts = [], [], []
        for i in indices:
            self._update_count(i)
            lrs.append(self._get_lr(i))
            wds.append(self._get_wd(i))
            ts.append(self._index_update_count[i])
        return lrs, wds, ts

    def update_multi(self, indices, weights, grads, states, lr=None,
                     wd=None, t=None) -> None:
        """One update of every ``weights[k]`` (tensors, NDArrays or
        Parameters' tensors) from ``grads[k]``, writing weights and
        ``states[k]`` in place.

        Without ``lr``/``wd``/``t`` the update counts and hyperparameters
        are those of a loop of :meth:`update` over ``indices`` in order.
        Given, ``lr`` and ``t`` are each a list (one per index) or a
        device scalar tensor; a tensor ``lr`` is the base rate, multiplied
        by each parameter's ``lr_mult``. The optimizers of this module run
        their rule on ``torch._foreach_*``; a subclass that defines only
        :meth:`step` runs it per parameter on host scalars."""
        if lr is None:
            lr, wd_c, t = self._hparams(indices)
            wd = wd_c if wd is None else wd
        elif wd is None:
            wd = [self._get_wd(i) for i in indices]
        if isinstance(lr, torch.Tensor) or isinstance(t, torch.Tensor):
            if type(self)._multi is Optimizer._multi:
                raise MXNetError(f"{type(self).__name__}.update_multi takes "
                                 "no device lr or t")
            if not isinstance(t, torch.Tensor):
                raise MXNetError("update_multi: a device lr needs a device "
                                 "t")
            t = [t] * len(indices)
        if isinstance(lr, torch.Tensor):
            lr = [lr if m == 1.0 else lr * m for m in
                  (self._mult(i, "lr_mult", self.lr_mult) for i in indices)]
        ws = [getattr(w, "_data", w) for w in weights]
        gs = [getattr(g, "_data", g) for g in grads]
        with torch.no_grad():
            for group in update_groups(self, ws, states):
                self._run_group(*([v[k] for k in group] for v in (
                    indices, ws, gs, states, lr, wd, t)))

    def _run_group(self, indices, ws, gs, states, lr, wds, t) -> None:
        """One group of :func:`update_groups`: the math on the fp32
        masters when the group has them, then the weights rounded from
        them."""
        master = _uses_master(self.multi_precision, ws[0], states[0])
        if master:
            mws = [s[0] for s in states]
            mgs = [g.float() for g in gs]
            rest = [tuple(s[1:]) for s in states]
        else:
            mws = ws
            mgs = [g if g.dtype == w.dtype else g.to(w.dtype)
                   for g, w in zip(gs, ws)]
            rest = [tuple(s) for s in states]
        self._multi(indices, mws, mgs, rest, lr, wds, t)
        if master:
            torch._foreach_copy_(ws, mws)

    def _multi(self, indices, ws, gs, states, lr, wds, t) -> None:
        """The update of one group on host scalars: :meth:`step` per
        parameter, its new weight and state copied into the old ones."""
        for w, g, s, lr_k, wd_k, t_k in zip(ws, gs, states, lr, wds, t):
            new_w, new_s = self.step(w, g, s, lr_k, wd_k, t_k)
            w.copy_(new_w)
            for a, b in zip(s, new_s):
                a.copy_(b)

    def _prep_grads(self, gs) -> List[torch.Tensor]:
        """Every gradient times ``rescale_grad``, clipped to
        ``clip_gradient``, as new tensors."""
        gs = torch._foreach_mul(gs, self.rescale_grad)
        if self.clip_gradient is not None:
            gs = torch._foreach_clamp_min(gs, -self.clip_gradient)
            gs = torch._foreach_clamp_max(gs, self.clip_gradient)
        return gs

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _pow(beta: float, t):
    """``beta ** t`` as the JAX package computes it: for an integer ``t``
    (``Optimizer.update``'s count) in Python floats, for a tensor ``t``
    (the step count of ``ShardedTrainer``'s compiled step) on the device
    in float32 (JAX counterpart: ``optimizer.py:189, :209``)."""
    if isinstance(t, torch.Tensor):
        return torch.pow(beta, t.to(torch.float32))
    return beta ** t


def _adam_lr(lr, beta1: float, beta2: float, t):
    """Adam's ``lr * sqrt(1 - beta2**t) / (1 - beta1**t)``: in float32 from
    the Python-float corrections for an integer ``t``, as ``jnp.sqrt`` of a
    Python float rounds to float32 in the JAX step (``optimizer.py:189``);
    on the device for a tensor ``t``."""
    bc1, bc2 = 1.0 - _pow(beta1, t), 1.0 - _pow(beta2, t)
    if isinstance(t, torch.Tensor):
        return lr * bc2 ** 0.5 / bc1
    return float(onp.float32(lr) * onp.sqrt(onp.float32(bc2))
                 / onp.float32(bc1))


def _sqrt(x):
    return x.sqrt() if isinstance(x, torch.Tensor) else math.sqrt(x)


# -- every optimizer's rule, written once over lists of tensors -------------
def _collapse(v: list):
    """A per-parameter list as its one value when every item is the same
    host number or the same device scalar; else the list."""
    first = v[0]
    if all(x is first for x in v) or (
            not any(isinstance(x, torch.Tensor) for x in v)
            and all(x == first for x in v)):
        return first
    return v


def _sc(fn, *args):
    """``fn`` over per-parameter scalars: each argument is one value (a
    host number or a device scalar) or a list of them, one per parameter;
    lists map item by item, and the result is a value or a list."""
    n = max((len(a) for a in args if isinstance(a, list)), default=0)
    if not n:
        return fn(*args)
    cols = [a if isinstance(a, list) else [a] * n for a in args]
    return [fn(*xs) for xs in zip(*cols)]


class _L:
    """The tensors of several parameters under one name, with elementwise
    arithmetic on ``torch._foreach_*``. The other operand is an
    :class:`_L` of the same length or a per-parameter scalar of
    :func:`_sc`. The operators return new tensors; the methods ending in
    ``_`` write into these tensors and return ``self``."""

    __slots__ = ("ts",)

    def __init__(self, ts):
        self.ts = list(ts)

    def _arg(self, o, sub: bool = False):
        """``o`` as the second argument of a ``torch._foreach_*`` op: an
        :class:`_L`'s tensors, a list, a number, or a device scalar (as a
        list for ``_foreach_sub``, which has no tensor form)."""
        if isinstance(o, _L):
            return o.ts
        if sub and isinstance(o, torch.Tensor):
            return [o] * len(self.ts)
        return o

    def __add__(self, o):
        return _L(torch._foreach_add(self.ts, self._arg(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return _L(torch._foreach_sub(self.ts, self._arg(o, sub=True)))

    def __rsub__(self, o):
        return -self + o

    def __mul__(self, o):
        return _L(torch._foreach_mul(self.ts, self._arg(o)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _L(torch._foreach_div(self.ts, self._arg(o)))

    def __neg__(self):
        return _L(torch._foreach_neg(self.ts))

    def _inplace(self, name: str, o) -> "_L":
        """``self op= o``. ``torch._foreach_mul_`` and its kin round a
        scalar to a float16/bfloat16 tensor's own type first on the CPU,
        where the out-of-place op (and ``tensor * scalar``) computes in
        float32; so for those types the op runs out of place and its
        result is copied back."""
        other = self._arg(o, sub=name == "sub")
        if self.ts and self.ts[0].dtype in _HALF:
            torch._foreach_copy_(self.ts, getattr(
                torch, f"_foreach_{name}")(self.ts, other))
        else:
            getattr(torch, f"_foreach_{name}_")(self.ts, other)
        return self

    def add_(self, o):
        return self._inplace("add", o)

    def sub_(self, o):
        return self._inplace("sub", o)

    def mul_(self, o):
        return self._inplace("mul", o)

    def maximum_(self, o: "_L"):
        return self._inplace("maximum", o)

    def set_(self, o: "_L"):
        """Copy ``o``'s tensors in, converting to these tensors' dtypes."""
        torch._foreach_copy_(self.ts, o.ts)
        return self

    def sq(self):
        return self * self

    def sqrt(self):
        return _L(torch._foreach_sqrt(self.ts))

    def abs(self):
        return _L(torch._foreach_abs(self.ts))

    def sign(self):
        return _L(torch._foreach_sign(self.ts))

    def float(self):
        return _L([t.float() for t in self.ts])

    def to_like(self, like: "_L"):
        return _L([t.to(w.dtype) for t, w in zip(self.ts, like.ts)])

    def norms(self) -> torch.Tensor:
        """Each tensor's L2 norm in float32, stacked: one
        ``torch._foreach_norm``."""
        return torch.stack(torch._foreach_norm(self.ts, 2,
                                               dtype=torch.float32))

    def map(self, fn, *others):
        """``fn`` per tensor (with the matching tensors of ``others``), for
        the few ops without a multi-tensor form."""
        cols = [o.ts for o in others]
        return _L(fn(*xs) for xs in zip(self.ts, *cols))


def _per_param(vec: torch.Tensor, s) -> torch.Tensor:
    """``vec * s`` for a stacked per-parameter vector and a scalar of
    :func:`_sc`."""
    if isinstance(s, list):
        s = torch.stack(s) if isinstance(s[0], torch.Tensor) else \
            torch.tensor(s, dtype=torch.float32, device=vec.device)
    return vec * s


def _zeros(weight, n: int) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.zeros_like(weight) for _ in range(n))


class _ListRule(Optimizer):
    """An optimizer whose rule is written once over :class:`_L`:
    ``_rule(w, g, state, lr, wd, t)`` writes the new weights and states
    into ``w`` and ``state``; ``g`` is already rescaled and clipped, new
    tensors the rule may overwrite.
    ``_multi`` runs it on a group's own tensors, so an update writes each
    of them once, where the tensors stay (a CUDA graph's addresses);
    ``step`` runs it on copies of one parameter's, so it stays pure."""

    def _rule(self, w: _L, g: _L, state: Tuple[_L, ...], lr, wd, t):
        raise NotImplementedError

    def step(self, w, g, state, lr, wd, t):
        w, state = w.clone(), tuple(s.clone() for s in state)
        self._rule(_L([w]), _L(self._prep_grads([g])),
                   tuple(_L([s]) for s in state), lr, wd, t)
        return w, state

    def _multi(self, indices, ws, gs, states, lr, wds, t):
        cols = tuple(_L(col) for col in zip(*states)) if states[0] else ()
        self._rule(_L(ws), _L(self._prep_grads(gs)), cols, _collapse(lr),
                   _collapse(wds), _collapse(t))


@register
class SGD(_ListRule):
    """SGD with optional momentum and L2 weight decay folded into the
    gradient (JAX counterpart: ``optimizer.py:150``)."""

    def __init__(self, momentum=0.0, lazy_update=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else _zeros(weight, 1)

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        if self.momentum == 0.0:
            w.sub_(g * lr)
            return
        mom = state[0].mul_(self.momentum).sub_(g * lr)
        w.add_(mom)


@register
class Adam(_ListRule):
    """Adam with L2 weight decay folded into the gradient (JAX counterpart:
    ``optimizer.py:184``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _moments(self, g, state):
        m = state[0].mul_(self.beta1).add_(g * (1 - self.beta1))
        v = state[1].mul_(self.beta2).add_(g.sq() * (1 - self.beta2))
        return m, v

    def _rule(self, w, g, state, lr, wd, t):
        m, v = self._moments(g.add_(w * wd), state)
        lr_t = _sc(lambda x, k: _adam_lr(x, self.beta1, self.beta2, k),
                   lr, t)
        w.sub_(m * lr_t / (v.sqrt() + self.epsilon))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (JAX counterpart:
    ``optimizer.py:203``)."""

    def _rule(self, w, g, state, lr, wd, t):
        m, v = self._moments(g, state)
        mhat = m / _sc(lambda k: 1 - _pow(self.beta1, k), t)
        vhat = v / _sc(lambda k: 1 - _pow(self.beta2, k), t)
        w.sub_((mhat / (vhat.sqrt() + self.epsilon) + w * wd) * lr)


@register
class NAG(_ListRule):
    """Nesterov momentum (JAX counterpart: ``optimizer.py:168``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight, 1)

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        mom = state[0].mul_(self.momentum).add_(g)
        w.sub_((g + mom * self.momentum) * lr)


@register
class RMSProp(_ListRule):
    """RMSProp, plain or centered (JAX counterpart: ``optimizer.py:215``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return _zeros(weight, 3 if self.centered else 1)

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        n = state[0].mul_(self.rho).add_(g.sq() * (1 - self.rho))
        if not self.centered:
            w.sub_(g * lr / (n + self.epsilon).sqrt())
            return
        gbar = state[1].mul_(self.rho).add_(g * (1 - self.rho))
        delta = state[2].mul_(self.momentum).sub_(
            g * lr / (n - gbar.sq() + self.epsilon).sqrt())
        w.add_(delta)
        if self.clip_weights:
            for x in w.ts:
                x.clamp_(-self.clip_weights, self.clip_weights)


@register
class AdaGrad(_ListRule):
    """AdaGrad (JAX counterpart: ``optimizer.py:246``)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight, 1)

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        hist = state[0].add_(g.sq())
        w.sub_(g * lr / (hist.sqrt() + self.float_stable_eps))


@register
class AdaDelta(_ListRule):
    """AdaDelta (JAX counterpart: ``optimizer.py:260``)."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        acc_g, acc_d = state
        acc_g.mul_(self.rho).add_(g.sq() * (1 - self.rho))
        delta = (acc_d + self.epsilon).sqrt() \
            / (acc_g + self.epsilon).sqrt() * g
        acc_d.mul_(self.rho).add_(delta.sq() * (1 - self.rho))
        w.sub_(delta)


@register
class FTRL(_ListRule):
    """Follow the regularised leader (JAX counterpart:
    ``optimizer.py:279``)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)           # (z, n)

    def _rule(self, w, g, state, lr, wd, t):
        zs, n = state
        g2 = g.sq()
        sigma = ((n + g2).sqrt() - n.sqrt()) / lr
        zs.add_(g).sub_(sigma * w)
        n.add_(g2)
        val = -(zs - zs.sign() * self.lamda1) \
            / ((n.sqrt() + self.beta) / lr + wd)
        l1 = self.lamda1
        w.set_(val.map(lambda v, z: torch.where(z.abs() > l1, v, 0.0), zs))


Ftrl = FTRL


@register
class Signum(_ListRule):
    """Sign of the momentum (JAX counterpart: ``optimizer.py:307``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else _zeros(weight, 1)

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        decay = _sc(lambda x: 1 - x * self.wd_lh, lr)
        if self.momentum == 0.0:
            step = g.sign() * lr
            w.mul_(decay).sub_(step)
            return
        mom = state[0].mul_(self.momentum).sub_(g * (1 - self.momentum))
        w.mul_(decay).add_(mom.sign() * lr)


@register
class LAMB(_ListRule):
    """Layer-wise adaptive moments, in float32 whatever the weight's dtype
    (JAX counterpart: ``optimizer.py:325``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight, dtype=torch.float32)
                     for _ in range(2))

    def _rule(self, w, g, state, lr, wd, t):
        g, wf = g.float(), w.float()
        m = state[0].mul_(self.beta1).add_(g * (1 - self.beta1))
        v = state[1].mul_(self.beta2).add_(g.sq() * (1 - self.beta2))
        mhat, vhat = m, v
        if self.bias_correction:
            mhat = m / _sc(lambda x: 1 - _pow(self.beta1, x), t)
            vhat = v / _sc(lambda x: 1 - _pow(self.beta2, x), t)
        r = mhat / (vhat.sqrt() + self.epsilon) + wf * wd
        w_norm, r_norm = wf.norms(), r.norms()
        if self.lower_bound is not None:
            w_norm = w_norm.clamp_min(self.lower_bound)
        if self.upper_bound is not None:
            w_norm = w_norm.clamp_max(self.upper_bound)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        w.set_(wf - r * list(_per_param(trust, lr).unbind(0)))


@register
class LARS(_ListRule):
    """Layer-wise adaptive rate scaling with momentum (JAX counterpart:
    ``optimizer.py:363``)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 1)

    def _rule(self, w, g, state, lr, wd, t):
        w_norm, g_norm = w.norms(), g.norms()
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + _per_param(w_norm, wd)
                                 + self.epsilon), 1.0)
        rate = list(_per_param(trust, lr).unbind(0))
        mom = state[0].mul_(self.momentum).add_((g + w * wd) * rate)
        w.sub_(mom)


@register
class DCASGD(_ListRule):
    """Delay-compensated SGD: ``lamda * g² * (w - previous w)`` added to
    the gradient (JAX counterpart: ``optimizer.py:383``)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        prev = weight.detach().clone()
        if self.momentum == 0.0:
            return (prev,)                 # (previous weight,)
        return (torch.zeros_like(weight), prev)

    def _rule(self, w, g, state, lr, wd, t):
        comp = g + w * wd + g.sq() * self.lamda * (w - state[-1])
        state[-1].set_(w)                  # the weight before this update
        if self.momentum == 0.0:
            w.sub_(comp * lr)
            return
        w.add_(state[0].mul_(self.momentum).sub_(comp * lr))


@register
class SGLD(_ListRule):
    """Stochastic gradient Langevin dynamics: half an SGD step plus
    ``N(0, lr)`` noise (JAX counterpart: ``optimizer.py:412``). The noise
    comes from one ``torch.Generator`` per device, seeded when it is first
    needed with a number drawn from the CPU stream of :mod:`..random` (so
    ``mx.random.seed`` governs it); its stream is not threefry's."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._gens: Dict[torch.device, torch.Generator] = {}

    def generator(self, device) -> torch.Generator:
        """This optimizer's generator on ``device``."""
        device = torch.device(device)
        gen = self._gens.get(device)
        if gen is None:
            from .. import random as _random
            from ..context import cpu
            seed = int(torch.randint(
                2 ** 62, (), generator=_random.generator(cpu())))
            gen = self._gens[device] = torch.Generator(
                device=device).manual_seed(seed)
        return gen

    def generators(self) -> List[torch.Generator]:
        return list(self._gens.values())

    def create_state(self, index, weight):
        self.generator(weight.device)
        return ()

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        noise = _L(torch.randn(x.shape, dtype=torch.float32,
                               device=x.device,
                               generator=self.generator(x.device))
                   for x in w.ts) * _sc(_sqrt, lr)
        w.sub_(g * _sc(lambda x: 0.5 * x, lr)).add_(noise.to_like(w))


@register
class Adamax(_ListRule):
    """Adam with an infinity-norm second moment (JAX counterpart:
    ``optimizer.py:439``)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        m = state[0].mul_(self.beta1).add_(g * (1 - self.beta1))
        u = state[1].mul_(self.beta2).maximum_(g.abs())
        lr_t = _sc(lambda x, k: x / (1.0 - _pow(self.beta1, k)), lr, t)
        w.sub_(m * lr_t / (u + 1e-8))


@register
class Nadam(_ListRule):
    """Adam with Nesterov momentum and a running momentum schedule, kept
    per parameter as a float32 scalar state (JAX counterpart:
    ``optimizer.py:459``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon, self.schedule_decay = epsilon, schedule_decay

    def create_state(self, index, weight):
        return _zeros(weight, 2) + (torch.ones(
            (), dtype=torch.float32, device=weight.device),)

    def _mu(self, t):
        if isinstance(t, torch.Tensor):
            t = t.to(torch.float32)
        return self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        m, v, m_schedule = state
        mu_t = _sc(self._mu, t)
        mu_t1 = _sc(lambda k: self._mu(k + 1), t)
        m_schedule.mul_(mu_t)
        m_schedule_next = m_schedule * mu_t1
        m.mul_(self.beta1).add_(g * (1 - self.beta1))
        v.mul_(self.beta2).add_(g.sq() * (1 - self.beta2))
        g_hat = g / (1 - m_schedule)
        m_hat = m / (1 - m_schedule_next)
        m_bar = g_hat * _sc(lambda x: 1 - x, mu_t) + m_hat * mu_t1
        v_hat = v / _sc(lambda k: 1 - _pow(self.beta2, k), t)
        w.sub_(m_bar * lr / (v_hat.sqrt() + self.epsilon))


@register
class FTML(_ListRule):
    """Follow the moving leader (JAX counterpart: ``optimizer.py:491``)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 3)           # (v, d, z)

    def _rule(self, w, g, state, lr, wd, t):
        g.add_(w * wd)
        v, d, z = state
        v.mul_(self.beta2).add_(g.sq() * (1 - self.beta2))
        scale = _sc(lambda x, k: (1 - _pow(self.beta1, k)) / x, lr, t)
        d_t = ((v / _sc(lambda k: 1 - _pow(self.beta2, k), t)).sqrt()
               + self.epsilon) * scale
        sigma = d_t - d * self.beta1
        z.mul_(self.beta1).add_(g * (1 - self.beta1)).sub_(sigma * w)
        d.set_(d_t)
        w.set_(-z / d)


class Updater:
    """A stateful ``(index, grad, weight)`` applier (JAX counterpart:
    ``optimizer.py:517``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, Tuple] = {}

    def __call__(self, index, grad, weight) -> None:
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, getattr(weight, "_data", weight).detach())
        self.states[index] = self.optimizer.update(index, weight, grad,
                                                   self.states[index])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
