"""Python-defined custom operators (``mx.operator``) and the ``Custom`` op.

Counterpart: the JAX package's ``operator.py`` (``CustomOp`` ``:30``,
``CustomOpProp`` ``:55``, ``register``/``get_prop_cls`` ``:92-115``, the
``Custom`` registry op ``:210-226``). The JAX package runs the user's op as
a ``jax.pure_callback`` under a ``jax.custom_vjp``; here it is one
``torch.autograd.Function`` (:class:`_CustomFunction`) whose forward calls
the user's :meth:`CustomOp.forward` and whose backward calls
:meth:`CustomOp.backward`, both on NDArrays over the op's own tensors, on
the device the inputs are on (the JAX package hands the callback host
arrays). One op instance serves a call's forward and its backward, so
state a forward keeps on ``self`` is there for its backward (the JAX
package keeps one instance per keyword signature for the process).

- ``req``: the forward writes each output (``"write"``); the backward's
  request is ``"write"`` for an input that takes a gradient and
  ``"null"`` for one that does not, and :meth:`CustomOp.assign` honours
  it.
- ``need_top_grad`` and :meth:`CustomOpProp.declare_backward_dependency`
  (MXNet's default: the output gradients when ``need_top_grad``, then the
  inputs and the outputs) say what the backward reads: only those arrays
  are kept for it, and the backward is given ``None`` in place of each
  array it did not declare.
- Shapes and dtypes come from :meth:`CustomOpProp.infer_shape` and
  :meth:`CustomOpProp.infer_type`, which is also how ``mx.sym.Custom``
  infers its output (the symbol walk's meta tensors cannot run a Python op).
- A user op may read the host (``asnumpy``), which no CUDA graph capture
  can hold: a hybridized block that runs a ``Custom`` op runs eagerly on
  the card and captures nothing (``HybridBlock.cache_info()`` counts its
  calls as ``host_op_calls``), an ``mx.sym`` Executor over a graph with a
  ``Custom`` node runs eagerly, and a ``Custom`` op met inside a capture
  raises.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Type

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls"]


class CustomOp:
    """Base class of an op's implementation (JAX counterpart: ``:30``).
    Subclasses override :meth:`forward` and :meth:`backward`; arrays
    arrive as NDArrays on the inputs' device."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError(
            "CustomOp.backward not implemented — required once the op is "
            "used under autograd.record")

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by the request: ``"write"`` (or
        ``"inplace"``) overwrites, ``"add"`` adds, ``"null"`` does
        nothing."""
        if req in ("null", 0):
            return
        if req in ("add", 3):
            dst[:] = dst + src
        else:
            dst[:] = src


class CustomOpProp:
    """An op's shape and type contract and its factory (JAX counterpart:
    ``:55``). ``need_top_grad=False`` marks an op whose backward does not
    read the output gradients (a loss)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = bool(need_top_grad)

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, shapes, dtypes) -> CustomOp:
        raise NotImplementedError

    def need_top_grad(self) -> bool:
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """The arrays the backward reads (MXNet's default)."""
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


_PROPS: Dict[str, Type[CustomOpProp]] = {}


def register(op_type: str):
    """Class decorator registering a :class:`CustomOpProp` under
    ``op_type``; the op is then ``mx.nd.Custom(*data, op_type=op_type)``
    or ``mx.sym.Custom(...)``."""

    def _reg(cls: Type[CustomOpProp]):
        if not issubclass(cls, CustomOpProp):
            raise TypeError(f"{cls!r} must subclass CustomOpProp")
        _PROPS[op_type] = cls
        return cls

    return _reg


def get_prop_cls(op_type: str) -> Type[CustomOpProp]:
    try:
        return _PROPS[op_type]
    except KeyError:
        raise KeyError(
            f"no CustomOp registered as '{op_type}'. Registered: "
            f"{sorted(_PROPS)}") from None


class _HostOps(threading.local):
    def __init__(self):
        self.count = 0


#: calls of ``Custom`` on this thread (``HybridBlock`` reads it to find
#: the blocks that run a host op)
HOST_OPS = _HostOps()


def _np_dtype(dt) -> onp.dtype:
    from .base import dtype_name
    return onp.dtype(dtype_name(dt)) if isinstance(dt, torch.dtype) \
        else onp.dtype(dt)


def _contract(prop: CustomOpProp, vals):
    """``(in shapes, in dtypes, [(out shape, out torch dtype), ...])``."""
    from .base import torch_dtype
    in_shapes = [list(v.shape) for v in vals]
    in_types = [_np_dtype(v.dtype) for v in vals]
    oshapes = prop.infer_shape(in_shapes)[1]
    otypes = prop.infer_type(in_types)[1]
    return in_shapes, in_types, [(tuple(s), torch_dtype(_np_dtype(t)))
                                 for s, t in zip(oshapes, otypes)]


def _arrays(tensors) -> list:
    from .ndarray import NDArray
    return [NDArray(t) for t in tensors]


class _CustomFunction(torch.autograd.Function):
    """``apply(prop, is_train, *inputs)``: the user's forward; its
    backward calls the user's backward (module docstring)."""

    @staticmethod
    def forward(ctx, prop, is_train, *vals):
        from . import autograd
        from .context import Context
        in_shapes, in_types, out_specs = _contract(prop, vals)
        dev = vals[0].device
        op = prop.create_operator(Context.from_device(dev), in_shapes,
                                  in_types)
        ins = _arrays([v.detach() for v in vals])
        outs = _arrays([torch.zeros(s, dtype=d, device=dev)
                        for s, d in out_specs])
        with autograd.pause(train_mode=is_train):
            op.forward(is_train=is_train, req=["write"] * len(outs),
                       in_data=ins, out_data=outs, aux=[])
        out_t = tuple(o._data for o in outs)
        ctx.op, ctx.n_in = op, len(vals)
        # keep what the backward declared it reads, and nothing else
        deps = prop.declare_backward_dependency(
            list(range(-len(out_t), 0)), list(range(len(vals))),
            [len(vals) + i for i in range(len(out_t))])
        ctx.deps = set(deps)
        ctx.save_for_backward(*[v if i in ctx.deps else None
                                for i, v in enumerate(vals)],
                              *[o if len(vals) + i in ctx.deps else None
                                for i, o in enumerate(out_t)])
        ctx.in_meta = [(tuple(v.shape), v.dtype, v.device) for v in vals]
        ctx.out_meta = [(tuple(o.shape), o.dtype, o.device) for o in out_t]
        return out_t if len(out_t) > 1 else out_t[0]

    @staticmethod
    def backward(ctx, *gouts):
        from . import autograd
        n_in, deps = ctx.n_in, ctx.deps
        saved = ctx.saved_tensors
        ins = [None if t is None else _arrays([t])[0] for t in saved[:n_in]]
        outs = [None if t is None else _arrays([t])[0] for t in saved[n_in:]]
        n_out = len(outs)
        ograds = []
        for i, (g, (s, d, dev)) in enumerate(zip(gouts, ctx.out_meta)):
            if -n_out + i not in deps:
                ograds.append(None)
                continue
            if g is None:
                g = torch.zeros(s, dtype=d, device=dev)
            ograds.append(_arrays([g.contiguous()])[0])
        need = ctx.needs_input_grad[2:]
        req = ["write" if n else "null" for n in need]
        in_grad = _arrays([torch.zeros(s, dtype=d, device=dev)
                           for s, d, dev in ctx.in_meta])
        with autograd.pause(train_mode=True):
            ctx.op.backward(req=req, out_grad=ograds, in_data=ins,
                            out_data=outs, in_grad=in_grad, aux=[])
        return (None, None) + tuple(g._data if n else None
                                    for g, n in zip(in_grad, need))


def _meta_outputs(prop: CustomOpProp, vals) -> tuple:
    _, _, out_specs = _contract(prop, vals)
    return tuple(torch.empty(s, dtype=d, device="meta") for s, d in out_specs)


def _register_custom_op():
    from .ops.registry import register_op

    @register_op("Custom")
    def custom(*in_vals, op_type=None, **kwargs):
        """Run a registered Python :class:`CustomOp` (reference:
        ``src/operator/custom/custom.cc``; parameters reach the prop as
        strings, as the reference's C interface passes them)."""
        if op_type is None:
            raise TypeError("Custom requires op_type=<registered name>")
        from . import autograd
        prop = get_prop_cls(op_type)(**{k: str(v) for k, v in
                                        kwargs.items()})
        if any(v.is_meta for v in in_vals):
            out = _meta_outputs(prop, in_vals)
            return out if len(out) > 1 else out[0]
        if in_vals[0].is_cuda and torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                f"Custom op {op_type!r} runs Python on the host, which a CUDA "
                "graph capture cannot hold")
        HOST_OPS.count += 1
        return _CustomFunction.apply(prop, autograd.is_training(), *in_vals)

    return custom


_register_custom_op()
