"""Optimizer update ops and the AMP casts: the ``mx.nd`` update surface.

Counterpart: the JAX package's ``ops/optimizer_ops.py`` (``:32-358``): the
single-tensor updates (``sgd_update``, ``sgd_mom_update``,
``mp_sgd_update``, ``mp_sgd_mom_update``, ``adam_update``,
``adamw_update``, ``nag_mom_update``, ``signsgd_update``,
``signum_update``, ``ftrl_update``, ``rmsprop_update`` and the four LAMB
phases), the multi-tensor family (``multi_sgd_update``,
``multi_sgd_mom_update``, ``multi_mp_sgd_update``,
``multi_mp_sgd_mom_update``, ``multi_sum_sq``) and ``amp_cast`` /
``amp_multicast``. The math is the JAX package's, formula for formula.

Every op is a pure function on tensors: it returns the updated tensors
(weight first, then states) and changes none of its inputs. ``mx.nd``
exposes each one on NDArrays (:mod:`..ndarray.op`), where ``out=[weight,
state, ...]`` writes the results into those arrays in place, as the
reference's mutating ops do (JAX docstring ``:17-21``). The multi-tensor
ops run on ``torch._foreach_*``: one multi-tensor kernel per step of the
formula over all the weights, where the JAX package relies on XLA to fuse
per-tensor updates.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "adamw_update",
           "nag_mom_update", "signsgd_update", "signum_update",
           "ftrl_update", "rmsprop_update", "lamb_update_phase1",
           "lamb_update_phase2", "mp_lamb_update_phase1",
           "mp_lamb_update_phase2", "multi_sgd_update",
           "multi_sgd_mom_update", "multi_mp_sgd_update",
           "multi_mp_sgd_mom_update", "multi_sum_sq", "amp_cast",
           "amp_multicast"]


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


# -- single-tensor updates ------------------------------------------------
def sgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=False, **_):
    """``w - lr * (rescale·clip(grad) + wd·w)`` (JAX counterpart:
    ``optimizer_ops.py:44``)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


def sgd_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False,
                   **_):
    """Momentum SGD; returns ``(weight, mom)`` (JAX counterpart:
    ``optimizer_ops.py:53``)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


def mp_sgd_update(weight, grad, weight32, lr=None, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=False, **_):
    """SGD on an fp32 master; returns ``(weight, weight32)`` (JAX
    counterpart: ``optimizer_ops.py:64``)."""
    g = _prep(grad.float(), rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


def mp_sgd_mom_update(weight, grad, mom, weight32, lr=None, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=False, **_):
    """Momentum SGD on an fp32 master; returns ``(weight, mom,
    weight32)`` (JAX counterpart: ``optimizer_ops.py:74``)."""
    g = _prep(grad.float(), rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + new_mom
    return w32.to(weight.dtype), new_mom, w32


def adam_update(weight, grad, mean, var, lr=None, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False, **_):
    """Adam's raw step, no bias correction; the clip applies to
    ``rescale·grad + wd·w``; returns ``(weight, mean, var)`` (JAX
    counterpart: ``optimizer_ops.py:85``)."""
    g = _prep(grad * rescale_grad + wd * weight, 1.0, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * g.square()
    return weight - lr * m / (v.sqrt() + epsilon), m, v


def adamw_update(weight, grad, mean, var, rescale_grad, lr=None, eta=1.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 clip_gradient=-1.0, **_):
    """AdamW, its decay not scaled by ``lr``; ``rescale_grad`` is a tensor,
    as in the reference; returns ``(weight, mean, var)`` (JAX counterpart:
    ``optimizer_ops.py:99``)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * g.square()
    return (weight - eta * (lr * m / (v.sqrt() + epsilon) + wd * weight),
            m, v)


def nag_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **_):
    """Nesterov momentum; returns ``(weight, mom)`` (JAX counterpart:
    ``optimizer_ops.py:112``)."""
    g = _prep(grad * rescale_grad + wd * weight, 1.0, clip_gradient)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


def signsgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **_):
    """signSGD (JAX counterpart: ``optimizer_ops.py:123``)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


def signum_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **_):
    """Signum; returns ``(weight, mom)`` (JAX counterpart:
    ``optimizer_ops.py:131``)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    return weight * (1 - lr * wd_lh) + lr * torch.sign(new_mom), new_mom


def ftrl_update(weight, grad, z, n, lr=None, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, **_):
    """FTRL-proximal; returns ``(weight, z, n)`` (JAX counterpart:
    ``optimizer_ops.py:141``)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    new_n = n + g.square()
    sigma = (new_n.sqrt() - n.sqrt()) / lr
    new_z = z + g - sigma * weight
    w = torch.where(new_z.abs() <= lamda1, torch.zeros_like(weight),
                    -(new_z - torch.sign(new_z) * lamda1)
                    / ((beta + new_n.sqrt()) / lr + wd))
    return w, new_z, new_n


def rmsprop_update(weight, grad, n, lr=None, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0, **_):
    """RMSProp; the clip applies to ``rescale·grad + wd·w``; returns
    ``(weight, n)`` (JAX counterpart: ``optimizer_ops.py:157``)."""
    g = _prep(grad * rescale_grad + wd * weight, 1.0, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * g.square()
    w = weight - lr * g / (new_n + epsilon).sqrt()
    if clip_weights is not None and clip_weights >= 0:
        w = w.clamp(-clip_weights, clip_weights)
    return w, new_n


# -- LAMB phases ------------------------------------------------------------
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0, **_):
    """LAMB's direction; returns ``(g, mean, var)`` (JAX counterpart:
    ``optimizer_ops.py:177``). The bias corrections are float32, from a
    float32 ``t``."""
    g = _prep(grad, rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * g.square()
    tf = torch.as_tensor(t, dtype=torch.float32, device=weight.device)
    if bias_correction:
        mhat = m / (1 - torch.pow(beta1, tf))
        vhat = v / (1 - torch.pow(beta2, tf))
    else:
        mhat, vhat = m, v
    return mhat / (vhat.sqrt() + epsilon) + wd * weight, m, v


def lamb_update_phase2(weight, g, r1, r2, lr=None, lower_bound=-1.0,
                       upper_bound=-1.0, **_):
    """``w - lr · (r1 / r2) · g``, the norms ``r1`` (weight) and ``r2``
    (direction) from the caller (JAX counterpart: ``optimizer_ops.py:194``).
    """
    r1, r2 = r1.reshape(()), r2.reshape(())
    if lower_bound is not None and lower_bound >= 0:
        r1 = r1.clamp_min(lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = r1.clamp_max(upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                        torch.ones_like(r1))
    return weight - lr * ratio * g


def mp_lamb_update_phase1(weight, grad, mean, var, weight32, **kwargs):
    """Phase 1 against the fp32 master (JAX counterpart:
    ``optimizer_ops.py:209``)."""
    return lamb_update_phase1(weight32, grad.float(), mean, var, **kwargs)


def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr=None,
                          lower_bound=-1.0, upper_bound=-1.0, **_):
    """Phase 2 on the fp32 master; returns ``(weight, weight32)`` (JAX
    counterpart: ``optimizer_ops.py:217``)."""
    w32 = lamb_update_phase2(weight32, g, r1, r2, lr=lr,
                             lower_bound=lower_bound,
                             upper_bound=upper_bound)
    return w32.to(weight.dtype), w32


# -- multi-tensor family ---------------------------------------------------
def _csv_floats(name, v, n) -> List[float]:
    """One float per weight from a list, a scalar or a string
    ``"0.1, 0.2"`` (JAX counterpart: ``optimizer_ops.py:232``)."""
    if v is None:
        raise ValueError(f"multi-tensor update: required parameter "
                         f"'{name}' is missing (one value per weight, "
                         f"e.g. {name}='0.1, 0.1')")
    if isinstance(v, str):
        v = [float(p) for p in v.replace(",", " ").split()]
    elif isinstance(v, (int, float)):
        v = [float(v)] * n
    v = list(v)
    if len(v) != n:
        raise ValueError(f"{name}: expected {n} values, got {len(v)}")
    return v


def _multi_sgd(ws, gs, lrs, wds, rescale_grad, clip_gradient,
               moms=None, momentum=0.0):
    """``sgd_update``/``sgd_mom_update`` over lists, as the same formula:
    returns the new weights and the new momenta (or None)."""
    g = torch._foreach_mul(gs, rescale_grad)
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch._foreach_clamp_min(g, -clip_gradient)
        g = torch._foreach_clamp_max(g, clip_gradient)
    step = torch._foreach_mul(torch._foreach_add(
        g, torch._foreach_mul(ws, wds)), lrs)          # lr * (g + wd w)
    if moms is None:
        return torch._foreach_sub(ws, step), None
    new_moms = torch._foreach_sub(torch._foreach_mul(moms, momentum), step)
    return torch._foreach_add(ws, new_moms), new_moms


def _interleaved(arrays, width, n) -> List[list]:
    return [list(arrays[j:width * n:width]) for j in range(width)]


def multi_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1, **_):
    """``(w0, g0, w1, g1, ...)`` -> the updated weights (JAX counterpart:
    ``optimizer_ops.py:248``)."""
    n = int(num_weights)
    ws, gs = _interleaved(arrays, 2, n)
    out, _ = _multi_sgd(ws, gs, _csv_floats("lrs", lrs, n),
                        _csv_floats("wds", wds, n), rescale_grad,
                        clip_gradient)
    return tuple(out) if n > 1 else out[0]


def multi_sgd_mom_update(*arrays, lrs=None, wds=None, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1, **_):
    """``(w0, g0, m0, ...)`` -> ``(w0', m0', w1', m1', ...)`` (JAX
    counterpart: ``optimizer_ops.py:265``)."""
    n = int(num_weights)
    ws, gs, ms = _interleaved(arrays, 3, n)
    out, moms = _multi_sgd(ws, gs, _csv_floats("lrs", lrs, n),
                           _csv_floats("wds", wds, n), rescale_grad,
                           clip_gradient, ms, momentum)
    return tuple(x for pair in zip(out, moms) for x in pair)


def multi_mp_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1, **_):
    """``(w0, g0, w32_0, ...)`` -> ``(w0', w32_0', ...)`` (JAX
    counterpart: ``optimizer_ops.py:283``)."""
    n = int(num_weights)
    ws, gs, w32s = _interleaved(arrays, 3, n)
    out, _ = _multi_sgd(w32s, [g.float() for g in gs],
                        _csv_floats("lrs", lrs, n),
                        _csv_floats("wds", wds, n), rescale_grad,
                        clip_gradient)
    return tuple(x for w, w32 in zip(ws, out)
                 for x in (w32.to(w.dtype), w32))


def multi_mp_sgd_mom_update(*arrays, lrs=None, wds=None, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1, **_):
    """``(w0, g0, m0, w32_0, ...)`` -> ``(w0', m0', w32_0', ...)`` (JAX
    counterpart: ``optimizer_ops.py:300``)."""
    n = int(num_weights)
    ws, gs, ms, w32s = _interleaved(arrays, 4, n)
    out, moms = _multi_sgd(w32s, [g.float() for g in gs],
                           _csv_floats("lrs", lrs, n),
                           _csv_floats("wds", wds, n), rescale_grad,
                           clip_gradient, ms, momentum)
    return tuple(x for w, m, w32 in zip(ws, moms, out)
                 for x in (w32.to(w.dtype), m, w32))


def multi_sum_sq(*arrays, num_arrays=1, **_):
    """Each array's sum of squares in float32, one scalar each (JAX
    counterpart: ``optimizer_ops.py:319``): one ``torch._foreach_norm``
    over all of them, squared."""
    n = int(num_arrays)
    norms = torch._foreach_norm(list(arrays[:n]), 2, dtype=torch.float32)
    outs = tuple(torch._foreach_mul(norms, norms))
    return outs if n > 1 else outs[0]


def sum_sq_total(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 sum of squares over all ``arrays`` together, from one
    ``torch._foreach_norm`` (the global gradient norm is its square
    root)."""
    norms = torch._foreach_norm(list(arrays), 2, dtype=torch.float32)
    return torch.stack(norms).square().sum()


# -- AMP casts --------------------------------------------------------------
_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}
_WIDTHS = {torch.float16: 16, torch.bfloat16: 16, torch.float32: 32,
           torch.float64: 64}


def amp_cast(data, dtype="float32"):
    """``data`` cast to ``dtype`` (JAX counterpart:
    ``optimizer_ops.py:339``)."""
    if dtype not in _DTYPES:
        raise ValueError(f"amp_cast: dtype {dtype!r} not in "
                         f"{sorted(_DTYPES)}")
    return data.to(_DTYPES[dtype])


def amp_multicast(*data, num_outputs=1, cast_narrow=False, **_):
    """Every input cast to their widest float type (the narrowest with
    ``cast_narrow``) (JAX counterpart: ``optimizer_ops.py:347``)."""
    n = int(num_outputs)
    arrs = data[:n]
    key = min if cast_narrow else max
    target = key((a.dtype for a in arrs), key=lambda d: _WIDTHS.get(d, 32))
    outs = tuple(a.to(target) for a in arrs)
    return outs if n > 1 else outs[0]
