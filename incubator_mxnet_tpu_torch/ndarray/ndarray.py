"""NDArray: MXNet's array surface over one ``torch.Tensor``.

Counterpart: the JAX package's ``ndarray/ndarray.py`` (``NDArray`` at
``:44-542``, ``array`` at ``:545``). An ``NDArray`` holds one tensor
(``_data``) on its context's device; operators dispatch to torch in
PyTorch's idiom. Every operator builds the autograd graph only under
``autograd.record()`` (see :mod:`..autograd`). Differences in form from the
JAX package:

- Basic indexing returns a view of the same storage, as upstream MXNet does
  for slices (the JAX package returns copies).
- ``dtype`` is a numpy dtype, except for bfloat16, which numpy lacks: there
  it is the string ``"bfloat16"`` (``str(x.dtype)`` is the name either
  way), and ``asnumpy()`` gives float32 values.
- Comparisons return 0/1 in the operands' dtype, as in MXNet.

As in the JAX package, an array that a recorded op made refuses in-place
mutation (``x[...] = v``, ``x += v`` ..., ``copyto`` into it, an update
op's ``out=``) while recording, until a backward clears the tape
(:meth:`NDArray._check_inplace_ok`). Any other array may be mutated under
``record()``, and the mutation is not recorded: its new value is a
constant to later ops, as the JAX package's buffer swap is.
"""
from __future__ import annotations

import operator
from typing import Optional, Tuple

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError, dtype_name, torch_dtype
from ..context import Context, as_context
from ..ops.tensor import cast_saturating
from .serialization import BFLOAT16

__all__ = ["NDArray", "array", "DLPackCarrier"]


def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _recorded(t: torch.Tensor) -> "NDArray":
    """An op's output: on the tape when the op ran under ``record()``."""
    out = NDArray(t)
    out._tape = autograd._tape_mark()
    return out


def _operand(x, like: torch.Tensor):
    """The other operand of an operator with ``like``: an NDArray's
    tensor, a host array as a tensor on ``like``'s device, a scalar as
    is."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (onp.ndarray, list, tuple)):
        return array(x, ctx=Context.from_device(like.device))._data
    return x


def _index(key):
    """An NDArray index (float indices are cast, as ``take`` does) as a
    tensor index."""
    if isinstance(key, NDArray):
        k = key._data
        return k if not k.is_floating_point() else k.long()
    if isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    return key


class NDArray:
    """An n-dimensional array on a device :class:`~..context.Context`."""

    __slots__ = ("_data", "_grad_req", "_fresh_grad", "_tape",
                 "__weakref__")

    # numpy interop priority (so ndarray.__add__ defers to us)
    __array_priority__ = 1000.0

    def __init__(self, data: torch.Tensor):
        if not isinstance(data, torch.Tensor):
            raise TypeError(f"NDArray holds a torch.Tensor, got "
                            f"{type(data).__name__}; use nd.array()")
        self._data = data
        self._grad_req = "null"
        # set by a backward that deposits into this array's gradient,
        # cleared by an optimizer update
        self._fresh_grad = False
        # tape generation of the recorded op that made it, else None
        self._tape = None

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        name = dtype_name(self._data.dtype)
        return name if name == "bfloat16" else onp.dtype(name)

    @property
    def context(self) -> Context:
        return Context.from_device(self._data.device)

    ctx = context

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def grad(self) -> Optional["NDArray"]:
        """The gradient buffer after :meth:`attach_grad` (zeros until a
        backward writes it), else None."""
        if self._grad_req == "null":
            return None
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(self._data)
        return NDArray(self._data.grad)

    @property
    def _autograd_leaf(self):
        return self._data if self._grad_req != "null" else None

    @property
    def _autograd_req(self) -> str:
        return self._grad_req

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.item())

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        return int(self.item())

    def item(self):
        return self._data.item()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # ------------------------------------------------------------------
    # sync / host transfer
    # ------------------------------------------------------------------
    def wait_to_read(self) -> None:
        """Wait for the work that writes this array (a sync of the
        device's current stream; NDArray::WaitToRead)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def asnumpy(self) -> onp.ndarray:
        """A host copy (bfloat16 as float32 values)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.cpu().numpy()
        return a.copy() if self._data.device.type == "cpu" else a

    def _raw_numpy(self) -> onp.ndarray:
        """A host copy with the exact bits; bfloat16 as
        :data:`~.serialization.BFLOAT16` (for ``.params`` files)."""
        t = self._data.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BFLOAT16).copy()
        return t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def __getitem__(self, key) -> "NDArray":
        with torch.set_grad_enabled(autograd.is_recording()):
            return _recorded(self._data[_index(key)])

    def __setitem__(self, key, value) -> None:
        self._check_inplace_ok()
        v = _operand(value, self._data)
        with torch.no_grad():
            self._data[_index(key)] = v

    def _check_inplace_ok(self) -> None:
        """Refuse in-place mutation of an array on the tape while recording
        (JAX counterpart: ``ndarray.py:184``)."""
        if autograd.is_recording() and autograd._on_tape(self):
            raise MXNetError(
                "In-place mutation of an array recorded on the autograd tape "
                "is not allowed (reference parity: inplace on recorded "
                "arrays)")

    # ------------------------------------------------------------------
    # context / dtype moves
    # ------------------------------------------------------------------
    def as_in_context(self, context) -> "NDArray":
        if as_context(context) == self.context:
            return self
        return self.copyto(context)

    def copyto(self, other) -> "NDArray":
        """A copy on a context, or the values written into ``other``."""
        if isinstance(other, NDArray):
            if other is self:
                raise MXNetError("cannot copy an array onto itself")
            other._check_inplace_ok()
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        dev = as_context(other).torch_device
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data.to(dev, copy=True))

    def copy(self) -> "NDArray":
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data.clone())

    as_in_ctx = as_in_context

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        """A copy as ``dtype``; a float going to an integer type saturates
        at the type's range and NaN gives 0, as in the JAX package."""
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        with torch.set_grad_enabled(autograd.is_recording()):
            out = cast_saturating(self._data, dt)
            return _recorded(out if out is not self._data else out.clone())

    @property
    def stype(self) -> str:
        """The storage type: ``"default"`` (dense)."""
        return "default"

    def tostype(self, stype: str) -> "NDArray":
        """This array in storage ``stype``: only ``"default"`` until the
        sparse types are ported."""
        if stype == "default":
            return self
        raise MXNetError(f"storage type {stype!r} needs ndarray.sparse, "
                         "which is not ported yet")

    @property
    def version(self) -> int:
        """How many times the array was written in place."""
        return self._data._version

    def to_dlpack_for_read(self) -> "DLPackCarrier":
        """A DLPack-protocol view of the tensor (no copy)."""
        return DLPackCarrier(self._data.detach())

    to_dlpack_for_write = to_dlpack_for_read

    def as_nd_ndarray(self) -> "NDArray":
        return self

    def asnumpy_or_none(self):
        return self.asnumpy()

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    # ------------------------------------------------------------------
    # autograd
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req: str = "write") -> None:
        """Make this array a variable: later backwards deposit its
        gradient by ``grad_req`` ('write' or 'add')."""
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write/add/null, got "
                             f"{grad_req}")
        self._data = self._data.detach().requires_grad_(grad_req != "null")
        self._grad_req = grad_req
        self._fresh_grad = False
        autograd._register(self)

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True) -> None:
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # ------------------------------------------------------------------
    # methods over the op namespace
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        """The array in ``shape``, with MXNet's codes (``nd.reshape``)."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return _op.reshape(self, kwargs.get("shape", shape),
                           reverse=kwargs.get("reverse", False))

    def reshape_like(self, other) -> "NDArray":
        return self.reshape(other.shape)

    def broadcast_like(self, other) -> "NDArray":
        return self.broadcast_to(other.shape)

    def slice(self, begin, end, step=None) -> "NDArray":
        return _op.slice(self, begin=begin, end=end, step=step)

    def take(self, indices, axis=0, mode="clip") -> "NDArray":
        return _op.take(self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False) -> "NDArray":
        return _op.pick(self, index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, on_value=1.0, off_value=0.0,
                dtype="float32") -> "NDArray":
        return _op.one_hot(self, depth=depth, on_value=on_value,
                           off_value=off_value, dtype=dtype)

    def norm(self, ord=2, axis=None, keepdims=False) -> "NDArray":
        return _op.norm(self, ord=ord, axis=axis, keepdims=keepdims)

    def dot(self, other) -> "NDArray":
        return _op.dot(self, other)

    def transpose(self, axes=None) -> "NDArray":
        return _op.transpose(self, axes=axes)

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def flatten(self) -> "NDArray":
        return _op.flatten(self)

    def expand_dims(self, axis: int) -> "NDArray":
        return _op.expand_dims(self, axis=axis)

    def squeeze(self, axis=None) -> "NDArray":
        return _op.squeeze(self, axis=axis)

    def broadcast_to(self, shape) -> "NDArray":
        return _op.broadcast_to(self, shape=shape)

    def slice_axis(self, axis, begin, end) -> "NDArray":
        return _op.slice_axis(self, axis=axis, begin=begin, end=end)

    def clip(self, a_min=None, a_max=None) -> "NDArray":
        return _op.clip(self, a_min=a_min, a_max=a_max)

    def softmax(self, *args, **kwargs) -> "NDArray":
        return _op.softmax(self, *args, **kwargs)

    def log_softmax(self, *args, **kwargs) -> "NDArray":
        return _op.log_softmax(self, *args, **kwargs)

    # ------------------------------------------------------------------
    # operators
    # ------------------------------------------------------------------
    def _binary(self, other, fn, reverse=False):
        a, b = self._data, _operand(other, self._data)
        if reverse:
            a, b = b, a
        with torch.set_grad_enabled(autograd.is_recording()):
            return _recorded(fn(a, b))

    def _compare(self, other, fn):
        b = _operand(other, self._data)
        out = fn(self._data, b)
        return _recorded(out.to(torch.result_type(self._data, b)))

    def _inplace(self, other, fn):
        self._check_inplace_ok()
        with torch.no_grad():
            fn(self._data, _operand(other, self._data))
        return self

    def __add__(self, other):
        return self._binary(other, operator.add)

    def __radd__(self, other):
        return self._binary(other, operator.add, True)

    def __sub__(self, other):
        return self._binary(other, operator.sub)

    def __rsub__(self, other):
        return self._binary(other, operator.sub, True)

    def __mul__(self, other):
        return self._binary(other, operator.mul)

    def __rmul__(self, other):
        return self._binary(other, operator.mul, True)

    def __truediv__(self, other):
        return self._binary(other, operator.truediv)

    def __rtruediv__(self, other):
        return self._binary(other, operator.truediv, True)

    def __floordiv__(self, other):
        return self._binary(other, operator.floordiv)

    def __rfloordiv__(self, other):
        return self._binary(other, operator.floordiv, True)

    def __mod__(self, other):
        return self._binary(other, operator.mod)

    def __rmod__(self, other):
        return self._binary(other, operator.mod, True)

    def __pow__(self, other):
        return self._binary(other, operator.pow)

    def __rpow__(self, other):
        return self._binary(other, operator.pow, True)

    def __neg__(self):
        with torch.set_grad_enabled(autograd.is_recording()):
            return _recorded(-self._data)

    def __abs__(self):
        return self.abs()

    def __eq__(self, other):
        if other is None:
            return False
        return self._compare(other, torch.eq)

    def __ne__(self, other):
        if other is None:
            return True
        return self._compare(other, torch.ne)

    def __lt__(self, other):
        return self._compare(other, torch.lt)

    def __le__(self, other):
        return self._compare(other, torch.le)

    def __gt__(self, other):
        return self._compare(other, torch.gt)

    def __ge__(self, other):
        return self._compare(other, torch.ge)

    __hash__ = object.__hash__

    def __iadd__(self, other):
        return self._inplace(other, torch.Tensor.add_)

    def __isub__(self, other):
        return self._inplace(other, torch.Tensor.sub_)

    def __imul__(self, other):
        return self._inplace(other, torch.Tensor.mul_)

    def __itruediv__(self, other):
        return self._inplace(other, torch.Tensor.div_)


def _unary_method(name):
    def method(self, *args, **kwargs):
        return getattr(_op, name)(self, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = f"``nd.{name}`` of this array."
    return method


for _name in ("abs", "sign", "sqrt", "square", "exp", "log", "relu",
              "sigmoid", "tanh", "sum", "mean", "max", "min", "prod",
              "argmax", "argmin"):
    setattr(NDArray, _name, _unary_method(_name))


class DLPackCarrier:
    """A DLPack-protocol view of a tensor: consumers (``np.from_dlpack``,
    ``torch.from_dlpack`` ...) take the buffer without a copy (JAX
    counterpart: ``ndarray/__init__.py:DLPackCarrier``)."""

    def __init__(self, tensor: torch.Tensor):
        self._tensor = tensor

    def __dlpack__(self, **kwargs):
        return self._tensor.__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._tensor.__dlpack_device__()


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An NDArray copied from any array-like onto ``ctx`` (default: the
    current context, ``gpu(0)`` unless a ``with ctx:`` says otherwise).
    As ``mx.nd.array``: Python lists default to float32; numpy arrays keep
    their dtype, with float64 and int64 narrowed to float32 and int32
    (JAX counterpart: ``ndarray.py:545``); tensors and NDArrays keep
    theirs."""
    dev = as_context(ctx).torch_device
    if isinstance(source_array, (NDArray, torch.Tensor)):
        t = _unwrap(source_array).detach()
        dt = torch_dtype(dtype) if dtype is not None else t.dtype
        return NDArray(t.to(dev, dt, copy=True))
    a = onp.asarray(source_array)
    if a.dtype == BFLOAT16:
        t = torch.from_numpy(a.view("<i2").copy()).view(torch.bfloat16)
        return NDArray(t.to(dev, torch_dtype(dtype or "bfloat16")))
    if dtype is None:
        if isinstance(source_array, onp.ndarray):
            dtype = {"float64": "float32", "int64": "int32"}.get(
                a.dtype.name, a.dtype)
        else:
            dtype = "float32"
    dt = torch_dtype(dtype)
    if dt == torch.bfloat16:
        t = torch.from_numpy(onp.array(a, dtype="float32")).to(dt)
    else:
        t = torch.from_numpy(onp.array(a, dtype=dtype_name(dt), order="C"))
    return NDArray(t.to(dev))


from . import op as _op  # noqa: E402  (the op namespace uses NDArray)
