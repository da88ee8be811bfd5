"""Test harness library (``mx.test_utils``).

Counterpart: the JAX package's ``test_utils.py`` (``:1-158``):
``assert_almost_equal``, ``almost_equal``, ``same``, ``rand_ndarray``,
the ``rand_shape_*`` helpers, ``check_numeric_gradient`` (autograd against
central finite differences), ``check_consistency`` (one computation over
contexts and dtypes) and ``default_context``: the context set by
:func:`set_default_context`, else the current one (``gpu(0)``, the port's
default device, unless a ``with mx.cpu():`` says otherwise).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as onp

from . import autograd
from .context import Context, cpu, current_context
from .ndarray import NDArray, array

__all__ = [
    "default_context", "set_default_context", "assert_almost_equal",
    "almost_equal", "same", "rand_ndarray", "rand_shape_2d", "rand_shape_3d",
    "rand_shape_nd", "check_numeric_gradient", "check_consistency",
    "default_dtype", "effective_dtype_tol", "numeric_grad",
]

_default_ctx: Optional[Context] = None


def default_context() -> Context:
    if _default_ctx is not None:
        return _default_ctx
    return current_context()


def set_default_context(ctx: Optional[Context]) -> None:
    global _default_ctx
    _default_ctx = ctx


def default_dtype():
    return onp.float32


def effective_dtype_tol(dtype) -> float:
    """The default tolerance of a dtype (bfloat16 by its name)."""
    name = dtype if isinstance(dtype, str) else onp.dtype(dtype).name
    return {"float16": 1e-2, "bfloat16": 2e-2, "float32": 1e-4,
            "float64": 1e-6}.get(name, 1e-4)


def _to_numpy(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return onp.asarray(a)


def same(a, b) -> bool:
    return onp.array_equal(_to_numpy(a), _to_numpy(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20) -> bool:
    return onp.allclose(_to_numpy(a), _to_numpy(b), rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")) -> None:
    a_, b_ = _to_numpy(a), _to_numpy(b)
    if rtol is None:
        rtol = max(effective_dtype_tol(a_.dtype),
                   effective_dtype_tol(b_.dtype)) \
            if a_.dtype.kind == "f" else 1e-5
    if atol is None:
        atol = rtol
    onp.testing.assert_allclose(a_.astype(onp.float64),
                                b_.astype(onp.float64), rtol=rtol, atol=atol,
                                err_msg=f"{names[0]} vs {names[1]} mismatch")


def rand_shape_2d(dim0=10, dim1=10):
    return tuple(onp.random.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(onp.random.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_shape_nd(num_dim, dim=10):
    return tuple(onp.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None,
                 scale=1.0) -> NDArray:
    """Uniform values in ``[-scale, scale)`` from numpy's global stream, in
    storage ``stype``."""
    ctx = ctx or default_context()
    dtype = dtype or onp.float32
    data = onp.random.uniform(-scale, scale, size=shape).astype(dtype)
    arr = array(data, ctx=ctx)
    if stype == "default":
        return arr
    from .ndarray import sparse
    return sparse.cast_storage(arr, stype)


def numeric_grad(executor_fn: Callable, inputs: List[onp.ndarray],
                 eps=1e-4) -> List[onp.ndarray]:
    """Central finite differences of a scalar-output function."""
    grads = []
    for x in inputs:
        g = onp.zeros_like(x, dtype=onp.float64)
        flat = x.reshape(-1)
        gf = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = float(executor_fn(*inputs))
            flat[j] = orig - eps
            fm = float(executor_fn(*inputs))
            flat[j] = orig
            gf[j] = (fp - fm) / (2 * eps)
        grads.append(g.astype(x.dtype))
    return grads


def check_numeric_gradient(fn: Callable, inputs: Sequence, rtol=1e-2,
                           atol=1e-3, eps=1e-3, ctx=None) -> None:
    """Autograd gradients of ``sum(fn(*inputs))`` against central finite
    differences."""
    ctx = ctx or default_context()
    arrs = [x if isinstance(x, NDArray)
            else array(onp.asarray(x, onp.float32), ctx=ctx) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = fn(*arrs)
        loss = out.sum() if out.ndim > 0 else out
    loss.backward()
    analytic = [a.grad.asnumpy().astype(onp.float64) for a in arrs]

    def host_fn(*np_inputs):
        outs = fn(*[array(x.astype(onp.float32), ctx=ctx)
                    for x in np_inputs])
        return outs.sum().asnumpy()

    numeric = numeric_grad(host_fn, [a.asnumpy().astype(onp.float64)
                                     for a in arrs], eps=eps)
    for an, nu in zip(analytic, numeric):
        onp.testing.assert_allclose(
            an, nu, rtol=rtol, atol=atol,
            err_msg="autograd vs finite-difference mismatch")


def check_consistency(fn: Callable, inputs_np: Sequence[onp.ndarray],
                      ctx_list: Optional[Sequence[Context]] = None,
                      dtypes=("float32",), rtol=None, atol=None) -> None:
    """The same computation over contexts and dtypes, each held against
    the first."""
    ctx_list = list(ctx_list) if ctx_list else [cpu(0), default_context()]
    ref = None
    for ctx in ctx_list:
        for dt in dtypes:
            ins = [array(x.astype(dt), ctx=ctx) for x in inputs_np]
            out = fn(*ins).asnumpy().astype(onp.float64)
            if ref is None:
                ref = out
            else:
                tol = rtol if rtol is not None else effective_dtype_tol(dt)
                onp.testing.assert_allclose(
                    out, ref, rtol=tol, atol=atol or tol,
                    err_msg=f"inconsistent result on {ctx} {dt}")
