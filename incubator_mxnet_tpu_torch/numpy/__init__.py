"""``mx.np``: the NumPy-compatible array namespace.

Counterpart: the JAX package's ``numpy/__init__.py``, which wraps
``jax.numpy`` and falls through ``__getattr__`` (``:68``) to any
``jnp`` function. Here the arrays are the port's :class:`~..ndarray.NDArray`
(recorded by autograd under ``record()``), and the module has:

- the JAX module's explicit functions: ``array``, ``zeros``, ``ones``,
  ``empty``, ``full``, ``arange``, ``trapz``, ``ascontiguousarray``,
  ``shares_memory``, ``may_share_memory``, the constants and dtypes, and
  ``random`` (``uniform``, ``normal``, ``randint``, ``choice``,
  ``shuffle``, ``seed``, drawing from the current context's generator);
- through ``__getattr__``, the torch function of the same name for the
  names in :data:`NUMPY_SAME`, each one whose torch function takes NumPy's
  arguments (``axis=`` included) and gives NumPy's result. Any other name
  raises ``AttributeError`` naming it: nothing is guessed.

The default float dtype is float32, as in the JAX package and in MXNet: a
Python float or a float64 host array becomes float32, a Python int or an
int64 host array int32.
"""
from __future__ import annotations

from typing import Any

import numpy as onp
import torch

from .. import autograd
from ..base import torch_dtype
from ..context import as_context
from ..ndarray import NDArray
from ..ndarray import array as _nd_array
from ..ndarray.ndarray import _recorded

__all__ = ["ndarray", "array", "zeros", "ones", "empty", "full", "arange",
           "trapz", "ascontiguousarray", "shares_memory", "may_share_memory",
           "pi", "e", "inf", "nan", "newaxis", "random", "NUMPY_SAME"]

#: name -> its wrapper, made at first use
_WRAPPED: dict = {}

ndarray = NDArray
newaxis = None
pi = onp.pi
e = onp.e
inf = onp.inf
nan = onp.nan
float32 = onp.float32
float64 = onp.float64
float16 = onp.float16
int32 = onp.int32
int64 = onp.int64
uint8 = onp.uint8
bool_ = onp.bool_
#: bfloat16 has no numpy dtype: the port names it by its string
bfloat16 = "bfloat16"

#: names whose torch function has NumPy's semantics (arguments, ``axis=``,
#: broadcasting and result), reached through ``__getattr__``
NUMPY_SAME = (
    "abs", "absolute", "add", "subtract", "multiply", "divide",
    "true_divide", "power", "negative", "positive", "sqrt", "square", "exp",
    "expm1", "log", "log2", "log10", "log1p", "sin", "cos", "tan", "arcsin",
    "arccos", "arctan", "arctan2", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "floor", "ceil", "trunc", "sign", "maximum",
    "minimum", "fmax", "fmin", "hypot", "isnan", "isinf", "isfinite",
    "logical_and", "logical_or", "logical_not", "logical_xor", "greater",
    "greater_equal", "less", "less_equal", "not_equal", "where", "clip",
    "matmul", "outer", "inner", "kron", "sum", "prod", "amax", "amin",
    "argmax", "argmin", "any", "all", "nansum", "count_nonzero", "diff",
    "concatenate", "stack", "reshape", "ravel", "tril", "triu", "allclose",
    "isclose", "flipud", "fliplr", "deg2rad", "rad2deg", "exp2",
    "logaddexp", "logaddexp2", "reciprocal", "heaviside",
)


def _default(dtype, like):
    """The dtype of a new array: ``dtype``, else float32 for floats and
    int32 for integers (``like``: a Python or numpy value)."""
    if dtype is not None:
        return torch_dtype(dtype)
    kind = onp.asarray(like).dtype.kind
    return {"f": torch.float32, "i": torch.int32, "u": torch.int32,
            "b": torch.bool}.get(kind, torch.float32)


def _device(ctx):
    return as_context(ctx).torch_device


def array(obj, dtype=None, ctx=None) -> NDArray:
    """An array of ``obj`` on ``ctx`` (default: the current context)."""
    return _nd_array(obj, ctx=ctx, dtype=dtype)


def zeros(shape, dtype=None, ctx=None, order="C") -> NDArray:
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype or "float32"),
                               device=_device(ctx)))


def ones(shape, dtype=None, ctx=None, order="C") -> NDArray:
    return NDArray(torch.ones(shape, dtype=torch_dtype(dtype or "float32"),
                              device=_device(ctx)))


empty = zeros


def full(shape, fill_value, dtype=None, ctx=None) -> NDArray:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.full(shape, fill_value,
                              dtype=_default(dtype, fill_value),
                              device=_device(ctx)))


def arange(start, stop=None, step=1, dtype=None, ctx=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    return NDArray(torch.arange(start, stop, step,
                                dtype=_default(dtype, [start, stop, step]),
                                device=_device(ctx)))


def _operand(v, dev):
    """An NDArray's tensor; a host array as a tensor on ``dev`` (float64
    and int64 narrowed, as ``nd.array``); a list holding NDArrays opened;
    anything else (scalars, shapes, axes) as it is."""
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, onp.ndarray):
        from ..context import Context
        return _nd_array(v, ctx=Context.from_device(dev))._data
    if isinstance(v, (list, tuple)) and any(isinstance(x, NDArray)
                                            for x in v):
        return type(v)(_operand(x, dev) for x in v)
    return v


def _first_device(values):
    for v in values:
        if isinstance(v, NDArray):
            return v._data.device
        if isinstance(v, (list, tuple)):
            d = _first_device(v)
            if d is not None:
                return d
    return None


def _wrap_torch(name: str):
    tfn = getattr(torch, name)

    def fn(*args, **kwargs):
        dev = _first_device(list(args) + list(kwargs.values()))
        if dev is None:
            dev = _device(None)
        args = [_operand(a, dev) for a in args]
        kwargs = {k: _operand(v, dev) for k, v in kwargs.items()}
        with torch.set_grad_enabled(autograd.is_recording()):
            out = tfn(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return _recorded(out)
        return out

    fn.__name__ = name
    fn.__qualname__ = f"np.{name}"
    fn.__doc__ = f"``numpy.{name}`` over NDArrays (``torch.{name}``)."
    return fn


def trapz(y, x=None, dx=1.0, axis=-1):
    """The trapezoid rule along ``axis`` (numpy < 2's spelling of
    ``trapezoid``), recorded by autograd."""
    f = _wrap_torch("trapezoid")
    return f(y, x, dim=axis) if x is not None else f(y, dx=dx, dim=axis)


def ascontiguousarray(a, dtype=None):
    """``a`` as a contiguous array (a copy where its layout is not), in
    ``dtype``; recorded by autograd."""
    t = a._data if isinstance(a, NDArray) else torch.as_tensor(
        onp.asarray(a))
    with torch.set_grad_enabled(autograd.is_recording()):
        out = t.contiguous() if dtype is None else t.to(
            torch_dtype(dtype)).contiguous()
        return _recorded(out)


def _overlap(a, b, fn):
    """Host arrays by numpy's ``fn``; NDArrays and tensors by the byte
    ranges they span in one storage (the port's basic indexing returns
    views); anything else shares nothing."""
    av = a._data if isinstance(a, NDArray) else a
    bv = b._data if isinstance(b, NDArray) else b
    if isinstance(av, onp.ndarray) and isinstance(bv, onp.ndarray):
        return bool(fn(av, bv))
    if isinstance(av, torch.Tensor) and isinstance(bv, torch.Tensor):
        return _storage_overlap(av, bv)
    return False


def _storage_overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Do the byte ranges two tensors span in their storage overlap?"""
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    sa, sb = a.element_size(), b.element_size()
    a0 = a.storage_offset() * sa
    b0 = b.storage_offset() * sb
    a1 = a0 + sa * (1 + sum((n - 1) * s for n, s in zip(a.shape,
                                                         a.stride())))
    b1 = b0 + sb * (1 + sum((n - 1) * s for n, s in zip(b.shape,
                                                         b.stride())))
    return a0 < b1 and b0 < a1 and a.numel() > 0 and b.numel() > 0


def shares_memory(a, b, max_work=None) -> bool:
    """Whether ``a`` and ``b`` share memory (:func:`_overlap`)."""
    return _overlap(a, b, onp.shares_memory)


def may_share_memory(a, b, max_work=None) -> bool:
    return _overlap(a, b, onp.may_share_memory)


def __getattr__(name: str) -> Any:
    if name in NUMPY_SAME:
        # cached apart from the module's globals, which would shadow the
        # builtins (sum, abs, any ...) for this module's own code
        fn = _WRAPPED.get(name)
        if fn is None:
            fn = _WRAPPED[name] = _wrap_torch(name)
        return fn
    raise AttributeError(
        f"module 'mx.np' has no attribute {name!r}: the port maps only the "
        "torch functions with NumPy's semantics (NUMPY_SAME)")


def __dir__():
    return sorted(set(list(globals()) + list(NUMPY_SAME)))


class _NPRandom:
    """``mx.np.random``: draws from the current context's generator
    (``mx.random``)."""

    @staticmethod
    def _gen(ctx):
        from .. import random as random_mod
        return random_mod.generator(as_context(ctx))

    @staticmethod
    def _shape(size):
        if size is None:
            return ()
        return (size,) if isinstance(size, int) else tuple(size)

    def uniform(self, low=0.0, high=1.0, size=None, dtype=None, ctx=None):
        out = torch.rand(self._shape(size), generator=self._gen(ctx),
                         dtype=torch_dtype(dtype or "float32"),
                         device=_device(ctx))
        return NDArray(out * (high - low) + low)

    def normal(self, loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
        out = torch.randn(self._shape(size), generator=self._gen(ctx),
                          dtype=torch_dtype(dtype or "float32"),
                          device=_device(ctx))
        return NDArray(out * scale + loc)

    def randint(self, low, high=None, size=None, dtype=None, ctx=None):
        if high is None:
            low, high = 0, low
        return NDArray(torch.randint(low, high, self._shape(size),
                                     generator=self._gen(ctx),
                                     dtype=torch_dtype(dtype or "int32"),
                                     device=_device(ctx)))

    def choice(self, a, size=None, replace=True, p=None, ctx=None):
        arr = a._data if isinstance(a, NDArray) else torch.as_tensor(
            onp.arange(a) if isinstance(a, int) else onp.asarray(a),
            device=_device(ctx))
        n = int(arr.shape[0])
        shape = self._shape(size)
        k = int(onp.prod(shape)) if shape else 1
        w = (p._data if isinstance(p, NDArray) else torch.as_tensor(
            onp.asarray(p, "float32"), device=arr.device)) if p is not None \
            else torch.ones(n, device=arr.device)
        idx = torch.multinomial(w.float(), k, replacement=replace,
                                generator=self._gen(ctx))
        return NDArray(arr[idx].reshape(shape))

    def shuffle(self, x: NDArray) -> None:
        perm = torch.randperm(x.shape[0], generator=self._gen(x.context),
                              device=x._data.device)
        with torch.no_grad():
            x._data.copy_(x._data[perm])

    def seed(self, s):
        from .. import random as random_mod
        random_mod.seed(int(s))


random = _NPRandom()
