"""``mx.sym``: the symbolic graph API over the port's op registry.

Counterpart: the JAX package's ``symbol/__init__.py`` (``Symbol`` at
``:70``, ``Executor`` at ``:534``). A :class:`Symbol` is a small DAG over
the one op registry (:mod:`..ops.registry`) that ``mx.nd`` and ``F`` read,
so every ``mx.nd`` op name composes symbolically too: ``Variable``,
composition, ``list_arguments``, ``infer_shape``, ``tojson``/``load``,
``bind``/``simple_bind`` producing an :class:`Executor`, and ``Group``.

- Shape inference walks the graph on ``device="meta"`` tensors through
  the same registry functions, with the JAX package's rules for the
  implicit parameter variables (``_fc_shapes`` ...). An op that reads
  values on the host cannot run on meta tensors; it runs on zeros of the
  known shapes on the CPU instead.
- ``tojson``/``load_json`` read and write the JAX package's JSON byte for
  byte: the same node order, attribute ``repr``s and subgraph payloads, so
  a ``-symbol.json`` crosses the packages both ways.
- An :class:`Executor` on the CPU runs forward and backward eagerly through
  torch autograd. On the card it does what the JAX one does with
  ``jax.jit`` and ``jax.vjp``: the forward, and the forward with the
  backward of a training call, are each captured as one CUDA graph per
  argument shapes and dtypes (:mod:`..ops.cuda.graphs`) and replayed;
  argument values are copied into the graph's static inputs when they are
  not already them. As in the JAX package, ``is_train`` says whether
  gradients are taken: ops run with training mode off (Dropout passes
  values through, BatchNorm normalises by its moving statistics) unless a
  node's attributes say otherwise.
"""
from __future__ import annotations

import ast
import json
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError, torch_dtype
from ..context import Context, as_context, current_context
from ..ndarray import NDArray, array
from ..ops.cuda import graphs
from ..ops.registry import OPS

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "Executor", "FullyConnected", "Activation",
           "SoftmaxOutput", "GraphInferenceError"]


class GraphInferenceError(MXNetError):
    """Shape inference failed at a specific graph node: the node's name,
    op and public attrs around the error of the per-node walk (JAX
    counterpart: ``symbol/__init__.py:37``)."""

    def __init__(self, node_name: str, op: Optional[str], attrs: Dict,
                 reason: str):
        self.node_name = node_name
        self.op = op
        self.attrs = attrs
        self.reason = reason
        super().__init__(
            f"shape inference failed at node '{node_name}' "
            f"(op {op!r}, attrs {attrs}): {reason}")


def _node_provenance(node: "Symbol") -> Tuple[str, Optional[str], Dict]:
    """(name, op, public attrs) of one graph node, for error messages."""
    attrs = {k: v for k, v in node._attrs.items() if not k.startswith("_")}
    return node._name, node._op, attrs


_this = sys.modules[__name__]

#: set while load_json rebuilds a graph: suppresses AttrScope injection
_DESERIALIZING = threading.local()


class Symbol:
    """A node of the symbolic DAG: a variable (op None) or an op
    application. Composition builds new nodes."""

    def __init__(self, op: Optional[str], inputs: Sequence["Symbol"],
                 attrs: Optional[Dict[str, Any]] = None,
                 name: Optional[str] = None, num_outputs: int = 1,
                 output_index: int = 0, base: Optional["Symbol"] = None):
        self._op = op
        self._inputs = list(inputs)
        self._attrs = dict(attrs or {})
        # AttrScope attributes ride along under the _attr_ prefix, explicit
        # node attrs win; a graph being loaded carries exactly the attrs it
        # was saved with, whatever scope is active
        if not getattr(_DESERIALIZING, "flag", False):
            from ..attribute import current_attrs
            for k, v in current_attrs().items():
                self._attrs.setdefault(k, v)
        self._name = name or _auto_name(op)
        self._num_outputs = num_outputs
        self._output_index = output_index
        self._base = base  # for multi-output slices: the producing node

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    def attr(self, key: str):
        """Node attribute; AttrScope attributes resolve by their plain
        name (stored under the ``_attr_`` prefix)."""
        if key in self._attrs:
            return self._attrs[key]
        return self._attrs.get("_attr_" + key)

    def list_attr(self) -> Dict[str, Any]:
        """Scope attributes first, then explicit node attributes, so an
        explicit one of the same name wins, as in :meth:`attr`."""
        out = {}
        for k, v in self._attrs.items():
            if k.startswith("_attr_"):
                out[k[len("_attr_"):]] = v
        for k, v in self._attrs.items():
            if not k.startswith("_attr_"):
                out[k] = v
        return out

    def __repr__(self):
        return f"<Symbol {self._name}>"

    # -- composition -------------------------------------------------------
    def __call__(self, *args, **kwargs):
        raise MXNetError("Symbol composition via __call__ is a Module-era "
                         "pattern not needed here; apply ops directly")

    def _binary(self, other, opname):
        if isinstance(other, Symbol):
            return Symbol(opname, [self, other])
        return Symbol(opname, [self],
                      attrs={"scalar": other, "_scalar_rhs": True})

    def __add__(self, other):
        return self._binary(other, "broadcast_add"
                            if isinstance(other, Symbol) else "_plus_scalar")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub"
                            if isinstance(other, Symbol) else "_minus_scalar")

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul"
                            if isinstance(other, Symbol) else "_mul_scalar")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div"
                            if isinstance(other, Symbol) else "_div_scalar")

    def __neg__(self):
        return self.__mul__(-1.0)

    # comparisons: 0/1 in the operand's dtype
    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser"
                            if isinstance(other, Symbol)
                            else "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal"
                            if isinstance(other, Symbol)
                            else "_lesser_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater"
                            if isinstance(other, Symbol)
                            else "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal"
                            if isinstance(other, Symbol)
                            else "_greater_equal_scalar")

    def __getitem__(self, index: int) -> "Symbol":
        if self._num_outputs == 1:
            if index != 0:
                raise MXNetError(f"{self._name} has a single output")
            return self
        return Symbol(None, [], name=f"{self._name}_output{index}",
                      base=self, output_index=index)

    # -- graph queries -----------------------------------------------------
    def get_internals(self) -> "Symbol":
        return Group(_topo(self))

    def list_arguments(self) -> List[str]:
        out, seen = [], set()
        for node in _topo(self):
            if node._op is None and node._base is None \
                    and id(node) not in seen:
                seen.add(id(node))
                out.append(node._name)
        return out

    def list_outputs(self) -> List[str]:
        if self._op == "_group":
            return [s._name + "_output" for s in self._inputs]
        return [self._name + "_output"]

    def list_auxiliary_states(self) -> List[str]:
        out = []
        for node in _topo(self):
            slots = _AUX_SLOTS.get(node._op)
            if not slots:
                continue
            for inp in node._inputs:
                if inp._op is None and inp._base is None and \
                        inp._name.endswith(slots):
                    out.append(inp._name)
        return out

    def infer_shape(self, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)``: the graph walked once
        on meta tensors, parameter shapes resolved from their consumer's
        input shape and attrs (``sym.FullyConnected(data, num_hidden=)``
        grows ``fc_weight``/``fc_bias`` of the right shapes). A failure
        raises :class:`GraphInferenceError` naming the node."""
        args = self.list_arguments()
        shapes, out_specs = _infer_graph_shapes(self, kwargs)
        unknown = [a for a in args if a not in shapes]
        if unknown:
            raise MXNetError(f"infer_shape could not resolve {unknown}")
        out_shapes = [tuple(o.shape) for o in out_specs]
        return [tuple(shapes[a]) for a in args], out_shapes, []

    def infer_type(self, **kwargs):
        """float32 for every argument and output, as the JAX package."""
        args = self.list_arguments()
        return ([onp.float32] * len(args),
                [onp.float32] * len(self.list_outputs()), [])

    # -- serialization -----------------------------------------------------
    def tojson(self) -> str:
        nodes = _topo(self)
        idx = {id(n): i for i, n in enumerate(nodes)}
        payload = {
            "nodes": [{
                "op": n._op or "null",
                "name": n._name,
                "attrs": {k: repr(_wire_attr(v))
                          for k, v in n._attrs.items()},
                "inputs": [[idx[id(i)], 0, 0] for i in n._inputs],
                "output_index": n._output_index,
                "num_outputs": n._num_outputs,
                "base": idx[id(n._base)] if n._base is not None else None,
            } for n in nodes],
            "heads": [[idx[id(self)], 0, 0]],
            "mxtpu_version": 1,
        }
        return json.dumps(payload, indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- execution ---------------------------------------------------------
    def eval(self, ctx: Optional[Context] = None, **kwargs) -> List[NDArray]:
        """The outputs for the arguments in ``kwargs`` (NDArrays or
        array-likes), evaluated eagerly; on ``ctx`` when it is given, else
        on the arguments' device."""
        args = self.list_arguments()
        vals = []
        for a in args:
            if a not in kwargs:
                raise MXNetError(f"eval missing argument {a}")
            vals.append(_value(kwargs[a]))
        if ctx is not None:
            dev = as_context(ctx).torch_device
            vals = [v.to(dev) for v in vals]
        else:
            dev = vals[0].device if vals else \
                current_context().torch_device
        with autograd.predict_mode(), torch.no_grad():
            out = _eval_graph(self, args, vals, device=dev)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [NDArray(o) for o in outs]

    def optimize_for(self, backend) -> "Symbol":
        """This graph partitioned by a registered subgraph backend (JAX
        counterpart: ``symbol/__init__.py:260``); the graph itself is left
        as it was."""
        from .. import subgraph as _subgraph
        return _subgraph.partition(self, backend)

    def bind(self, ctx: Context, args, args_grad=None,
             grad_req: str = "write", aux_states=None,
             **kwargs) -> "Executor":
        return Executor(self, ctx, args, args_grad, grad_req)

    def simple_bind(self, ctx: Optional[Context] = None,
                    grad_req: str = "write", **shapes) -> "Executor":
        """An Executor whose fed arguments (``shapes``' names) are zeros
        and whose parameters are drawn as the JAX package draws them
        (``RandomState(0)``, uniform in +-sqrt(6 / fan)), usually
        overwritten by ``Module.init_params``."""
        ctx = as_context(ctx)
        dev = ctx.torch_device
        arg_names = self.list_arguments()
        arg_shapes, _, _ = self.infer_shape(**shapes)
        rng = onp.random.RandomState(0)
        args = {}
        for name, shape in zip(arg_names, arg_shapes):
            if name in shapes:
                args[name] = NDArray(torch.zeros(shape, device=dev))
            else:
                # the builtin max is shadowed here by the op namespace
                fan = int(onp.prod(shape[1:])) if len(shape) > 1 \
                    else int(shape[0])
                fan = fan if fan > 0 else 1
                scale = (6.0 / fan) ** 0.5
                host = onp.asarray(rng.uniform(-scale, scale, shape),
                                   onp.float32)
                args[name] = NDArray(torch.from_numpy(host).to(dev))
        grads = {name: NDArray(torch.zeros_like(a._data))
                 for name, a in args.items()} if grad_req != "null" \
            else None
        return Executor(self, ctx, args, grads, grad_req)


def _auto_name(op: Optional[str]) -> str:
    if op is None:
        return "variable"
    from ..name import NameManager
    return NameManager.current().get(None, op.lower())


def _topo(root: Symbol) -> List[Symbol]:
    """Post-order over ``_base`` then ``_inputs``, each node once (the JAX
    package's recursive order, walked with a stack)."""
    seen = set()
    order: List[Symbol] = []
    stack = [(root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        kids = ([node._base] if node._base is not None else []) \
            + node._inputs
        for k in reversed(kids):
            if id(k) not in seen:
                stack.append((k, False))
    return order


_SCALAR_OPS = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    # comparisons keep the operand dtype (0/1 values)
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
}


# ---------------------------------------------------------------------------
# implicit parameter variables: weights are inputs named <node>_weight etc.,
# their shapes inferred from the data's (JAX counterpart: :343-387)
# ---------------------------------------------------------------------------

def _fc_shapes(dshape, attrs):
    h = int(attrs["num_hidden"])
    in_units = int(onp.prod(dshape[1:])) if attrs.get("flatten", True) \
        else int(dshape[-1])
    out = {"weight": (h, in_units)}
    if not attrs.get("no_bias", False):
        out["bias"] = (h,)
    return out


def _conv_shapes(dshape, attrs):
    kernel = tuple(attrs["kernel"])
    nf = int(attrs["num_filter"])
    groups = int(attrs.get("num_group", 1))
    out = {"weight": (nf, dshape[1] // groups) + kernel}
    if not attrs.get("no_bias", False):
        out["bias"] = (nf,)
    return out


def _embed_shapes(dshape, attrs):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


def _bn_shapes(dshape, attrs):
    c = int(dshape[1])
    return {"gamma": (c,), "beta": (c,),
            "moving_mean": (c,), "moving_var": (c,)}


#: op -> (ordered param slot names, shape rule)
_PARAM_OPS: Dict[str, tuple] = {
    "FullyConnected": (("weight", "bias"), _fc_shapes),
    "Convolution": (("weight", "bias"), _conv_shapes),
    "Embedding": (("weight",), _embed_shapes),
    "BatchNorm": (("gamma", "beta", "moving_mean", "moving_var"),
                  _bn_shapes),
}

#: param slots that are auxiliary states, not learnable arguments
_AUX_SLOTS = {"BatchNorm": ("moving_mean", "moving_var")}


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _as_meta(v):
    """A result of an op as meta tensors (the same nesting)."""
    if isinstance(v, torch.Tensor):
        return v if v.is_meta else _meta(v.shape, v.dtype)
    if isinstance(v, (list, tuple)):
        return type(v)(_as_meta(x) for x in v)
    return v


def _run_spec(fn, ins: list):
    """``fn`` on meta tensors of ``ins``' shapes and dtypes. An op that
    reads values on the host (``.item()``, a value-dependent shape) cannot
    run on meta tensors: it runs on zeros of the same shapes on the CPU,
    and its result's shapes are kept."""
    with torch.no_grad():
        try:
            with torch.device("meta"):
                return _as_meta(fn(*ins))
        except Exception:
            zeros = [torch.zeros(t.shape, dtype=t.dtype) for t in ins]
            return _as_meta(fn(*zeros))


def _infer_graph_shapes(root: Symbol, known: Dict[str, tuple], sink=None):
    """Walk the DAG once on meta tensors, resolving variable shapes (data
    from ``known``, parameters from their consumer's rule) and each node's
    output. When ``sink`` is a dict it receives every node's primary
    output keyed by ``id(node)`` (``visualization.print_summary``)."""
    shapes: Dict[str, tuple] = {k: tuple(v) for k, v in known.items()}
    env: Dict[int, Any] = {}

    def spec_of(node):
        v = env.get(id(node))
        # a multi-output op consumed as a plain symbol: its first output
        return v[0] if isinstance(v, (tuple, list)) else v

    for node in _topo(root):
        if node._base is not None:
            outs = env[id(node._base)]
            if not isinstance(outs, (tuple, list)) \
                    or node._output_index >= len(outs):
                n_out = len(outs) if isinstance(outs, (tuple, list)) else 1
                raise GraphInferenceError(
                    *_node_provenance(node),
                    f"output index {node._output_index} out of range: base "
                    f"'{node._base._name}' produces {n_out} output(s)")
            env[id(node)] = outs[node._output_index]
            continue
        if node._op is None:
            env[id(node)] = _meta(shapes[node._name]) \
                if node._name in shapes else None
            continue
        if node._op == "_group":
            env[id(node)] = [spec_of(i) for i in node._inputs]
            continue
        attrs = {k: v for k, v in node._attrs.items()
                 if not k.startswith("_")}
        ins = [spec_of(i) for i in node._inputs]
        if node._op in _PARAM_OPS and any(s is None for s in ins[1:]):
            slots, rule = _PARAM_OPS[node._op]
            if ins[0] is None:
                raise MXNetError(
                    f"{node._name}: data input shape unknown; pass it to "
                    "infer_shape/simple_bind")
            slot_shapes = rule(tuple(ins[0].shape), attrs)
            for inp, slot in zip(node._inputs[1:], slots):
                if spec_of(inp) is None and slot in slot_shapes:
                    shapes[inp._name] = slot_shapes[slot]
                    env[id(inp)] = _meta(slot_shapes[slot])
            ins = [spec_of(i) for i in node._inputs]
        if any(s is None for s in ins):
            bad = [i._name for i, s in zip(node._inputs, ins) if s is None]
            raise MXNetError(f"{node._name}: unresolved input shapes {bad}")
        if node._op in _SCALAR_OPS:
            fn = (lambda x, _s=node._attrs["scalar"], _o=node._op:
                  _SCALAR_OPS[_o](x, _s))
        else:
            opdef = OPS.get(node._op)
            if opdef is None:
                raise MXNetError(f"unknown op {node._op!r} in symbol graph")
            fn = (lambda *a, _f=opdef.fn, _at=attrs: _f(*a, **_at))
        try:
            with autograd.predict_mode():
                env[id(node)] = _run_spec(fn, ins)
        except GraphInferenceError:
            raise  # a nested walk already located the failure
        except Exception as e:
            raise GraphInferenceError(
                *_node_provenance(node),
                f"{e} [input shapes: "
                f"{[tuple(i.shape) for i in ins]}]") from e
    if sink is not None:
        for nid, v in env.items():
            sink[nid] = v[0] if isinstance(v, (list, tuple)) else v
    out = env[id(root)]
    out_specs = out if isinstance(out, (list, tuple)) else [out]
    return shapes, out_specs


def _primary(v):
    """A multi-output op consumed as a plain symbol yields its first
    output (BatchNorm's normalised value, its statistics reachable only
    by explicit indexing)."""
    return v[0] if isinstance(v, (tuple, list)) else v


def _eval_graph(root: Symbol, arg_names: List[str], vals, sink=None,
                device=None):
    """Evaluate the DAG in topological order on tensors; source ops (no
    inputs) make theirs on ``device``. When ``sink`` is a dict every op
    node's primary output is also recorded there by name: the Monitor's
    capture runs the same evaluator as the forward."""
    env: Dict[int, Any] = {}
    name2val = dict(zip(arg_names, vals))
    for node in _topo(root):
        if node._base is not None:
            env[id(node)] = env[id(node._base)][node._output_index]
            continue
        if node._op is None:
            if node._name not in name2val:
                raise MXNetError(f"unbound variable {node._name}")
            env[id(node)] = name2val[node._name]
            continue
        if node._op == "_group":
            env[id(node)] = [_primary(env[id(i)]) for i in node._inputs]
            continue
        ins = [_primary(env[id(i)]) for i in node._inputs]
        attrs = {k: v for k, v in node._attrs.items()
                 if not k.startswith("_")}
        if node._op in _SCALAR_OPS:
            out = _SCALAR_OPS[node._op](ins[0], attrs.pop("scalar"))
        else:
            opdef = OPS.get(node._op)
            if opdef is None:
                raise MXNetError(f"unknown op {node._op!r} in symbol graph; "
                                 f"known ops: {len(OPS)} registered")
            if ins or device is None:
                out = opdef.fn(*ins, **attrs)
            else:
                with torch.device(device):
                    out = opdef.fn(**attrs)
        env[id(node)] = out
        if sink is not None:
            # distinct nodes can share an auto-name (separate NameManager
            # scopes or threads): number them instead of overwriting
            key = node._name
            n = 2
            while key in sink:
                key = f"{node._name}#{n}"
                n += 1
            sink[key] = _primary(out)
    return env[id(root)]


def _as_list(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _value(v, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tensor of an argument value: an NDArray's or a tensor as is, an
    array-like as ``nd.array`` makes it on the host (float64 narrowed to
    float32), in ``like``'s dtype when given."""
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    t = array(v, ctx="cpu")._data
    return t.to(like.dtype) if like is not None else t


class _Captured:
    """One argument signature's captured graph: the static inputs it reads,
    the outputs (and, training, the seeds and gradients) it rewrites."""

    __slots__ = ("graph", "inputs", "outputs", "seeds", "grads", "ones")

    def __init__(self):
        self.graph = None
        self.inputs: List[torch.Tensor] = []
        self.outputs: List[torch.Tensor] = []
        self.seeds: Optional[List[torch.Tensor]] = None
        self.grads: Optional[List[torch.Tensor]] = None
        self.ones = True     # the seeds hold ones (the default backward)


class Executor:
    """A bound symbol (JAX counterpart: ``symbol/__init__.py:534``):
    ``forward``, ``backward``, ``arg_dict``/``grad_dict``/``aux_dict``,
    ``outputs``, ``copy_params_from`` and ``capture_internals``. See the
    module docstring for the eager and the captured paths; ``captures``
    counts the graphs captured, one per argument signature and
    ``is_train``."""

    def __init__(self, symbol: Symbol, ctx, args, args_grad,
                 grad_req: str = "write"):
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write/add/null, got "
                             f"{grad_req!r}")
        self._symbol = symbol
        self._ctx = as_context(ctx)
        self._device = self._ctx.torch_device
        self._arg_names = symbol.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(self._arg_names, args))
        self.arg_dict: Dict[str, NDArray] = {
            k: self._on_device(v) for k, v in args.items()}
        self.grad_dict: Dict[str, NDArray] = {
            k: self._on_device(v) for k, v in (args_grad or {}).items()}
        self.aux_dict: Dict[str, NDArray] = {}
        self._grad_req = grad_req
        self.outputs: List[NDArray] = []
        # the card replays captured graphs; tests turn this off to hold
        # the replay against the eager run
        self._graphed = self._device.type == "cuda"
        self._graphs: Dict[tuple, _Captured] = {}
        self.captures = 0
        self._last = None     # what backward reads: ("graph", c) / eager

    def _on_device(self, v) -> NDArray:
        if isinstance(v, NDArray):
            return v.as_in_context(self._ctx)
        return NDArray(_value(v).to(self._device))

    def _write(self, name: str, v) -> None:
        """Argument ``name`` takes ``v``'s values: in place at the same
        shape (the storage a captured graph reads), else new storage."""
        arr = self.arg_dict[name]
        t = _value(v, arr._data)
        with torch.no_grad():
            if tuple(t.shape) == arr.shape:
                arr._data.copy_(t)
            else:
                arr._data = t.to(self._device, arr._data.dtype, copy=True)

    def _values(self) -> List[torch.Tensor]:
        return [self.arg_dict[n]._data for n in self._arg_names]

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """The outputs for the current arguments, ``kwargs`` written into
        them first; ``is_train`` keeps what :meth:`backward` needs."""
        self._last = None     # an eager autograd graph goes before a capture
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self._write(k, v)
        train = bool(is_train) and self._grad_req != "null"
        if self._graphed:
            c = self._replay(train)
            self._last = ("graph", c) if train else None
            outs = c.outputs
        else:
            outs = self._eager(train)
        self.outputs = [NDArray(o.detach().clone()) for o in outs]
        return self.outputs

    # -- eager -------------------------------------------------------------
    def _eager(self, train: bool) -> List[torch.Tensor]:
        vals = self._values()
        if not train:
            self._last = None
            with autograd.predict_mode(), torch.no_grad():
                return _as_list(_eval_graph(self._symbol, self._arg_names,
                                            vals, device=self._device))
        leaves = [v.detach().requires_grad_(v.is_floating_point())
                  for v in vals]
        with autograd.predict_mode(), torch.enable_grad():
            outs = _as_list(_eval_graph(self._symbol, self._arg_names,
                                        leaves, device=self._device))
        self._last = ("eager", outs, leaves)
        return outs

    @staticmethod
    def _grads(outs, leaves, seeds, retain: bool) -> List[torch.Tensor]:
        """d(sum seeds . outs)/d leaves, zeros where a leaf does not
        reach an output (JAX: the vjp's zero cotangents)."""
        diff = [(o, s) for o, s in zip(outs, seeds) if o.requires_grad]
        wrt = [x for x in leaves if x.requires_grad]
        got = torch.autograd.grad(
            [o for o, _ in diff], wrt, [s for _, s in diff],
            retain_graph=retain, allow_unused=True) if diff and wrt else \
            [None] * len(wrt)
        it = iter(got)
        out = []
        for x in leaves:
            g = next(it) if x.requires_grad else None
            out.append(torch.zeros_like(x) if g is None else g)
        return out

    # -- captured ----------------------------------------------------------
    def _replay(self, train: bool) -> _Captured:
        vals = self._values()
        key = (train,) + tuple((tuple(v.shape), v.dtype) for v in vals)
        c = self._graphs.get(key)
        if c is None:
            c = self._graphs[key] = self._capture(train, vals)
            self.captures += 1
            return c
        with torch.no_grad():
            for dst, src in zip(c.inputs, vals):
                if dst is not src:
                    dst.copy_(src)
            if train and not c.ones:
                for s in c.seeds:
                    s.fill_(1)
                c.ones = True
        c.graph.replay()
        return c

    def _capture(self, train: bool, vals) -> _Captured:
        """Capture this signature's forward (with the backward, training)
        after a first run of the same work on the capture stream; the
        capture itself runs nothing, so its first results come from one
        replay. A failed capture raises; nothing falls back to eager."""
        from ..random import generator
        c = _Captured()
        c.inputs = list(vals)
        sym, names, dev = self._symbol, self._arg_names, self._device

        def forward():
            leaves = [v.detach().requires_grad_(train and
                                                v.is_floating_point())
                      for v in c.inputs]
            with autograd.predict_mode(), torch.set_grad_enabled(train):
                outs = _as_list(_eval_graph(sym, names, leaves, device=dev))
            if not train:
                return outs, None
            if c.seeds is None:
                c.seeds = [torch.ones_like(o) for o in outs]
            return ([o.detach() for o in outs],
                    self._grads(outs, leaves, c.seeds, retain=False))

        c.graph = graphs.Graph(dev, [generator(self._ctx)])
        c.outputs, c.grads = c.graph.capture(
            forward, warm=forward,
            what=f"the capture of symbol {sym.name}")
        c.graph.replay()
        return c

    def backward(self, out_grads=None) -> None:
        """Write (``grad_req="write"``) or add (``"add"``) the gradients of
        the last training forward into ``grad_dict``, with ``out_grads``
        (default ones) as the outputs' gradients."""
        if self._last is None:
            raise MXNetError("backward requires forward(is_train=True)")
        if out_grads is not None and not isinstance(out_grads,
                                                    (list, tuple)):
            out_grads = [out_grads]
        if self._last[0] == "graph":
            c = self._last[1]
            if out_grads is not None:
                with torch.no_grad():
                    for s, g in zip(c.seeds, out_grads):
                        s.copy_(_value(g, s))
                c.ones = False
                c.graph.replay()
            grads = c.grads
        else:
            _, outs, leaves = self._last
            seeds = [torch.ones_like(o) for o in outs] if out_grads is None \
                else [_value(g, o).to(o.device) for g, o in
                      zip(out_grads, outs)]
            grads = self._grads(outs, leaves, seeds, retain=True)
        with torch.no_grad():
            for name, g in zip(self._arg_names, grads):
                tgt = self.grad_dict.get(name)
                if tgt is None:
                    continue
                if tgt.shape != tuple(g.shape):
                    tgt._data = g.detach().clone()
                elif self._grad_req == "add":
                    tgt._data.add_(g)
                else:
                    tgt._data.copy_(g)

    def copy_params_from(self, arg_params: Dict,
                         aux_params: Optional[Dict] = None) -> None:
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                self._write(k, v)

    def capture_internals(self) -> Dict[str, onp.ndarray]:
        """Every op node's primary output for the current arguments, keyed
        by node name, on the host: the ``mx.monitor.Monitor`` seam. It runs
        the forward's evaluator eagerly, outside any captured graph."""
        sink: Dict[str, Any] = {}
        with autograd.predict_mode(), torch.no_grad():
            _eval_graph(self._symbol, self._arg_names, self._values(),
                        sink=sink, device=self._device)
        return {k: v.detach().float().cpu().numpy()
                if v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
                for k, v in sink.items()}


# ---------------------------------------------------------------------------
# constructors + generated op namespace
# ---------------------------------------------------------------------------

def Variable(name: str, shape=None, dtype=None, **kwargs) -> Symbol:
    return Symbol(None, [], attrs={"shape": shape, "dtype": dtype},
                  name=name)


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol("_group", list(symbols), name="group",
                  num_outputs=len(list(symbols)))


def _wire_attr(v):
    """Wire-encode one attr value: a Symbol becomes a nested graph payload
    that survives ``repr`` -> ``ast.literal_eval``, a list of Symbols one
    Group payload, tuples stay tuples (JAX counterpart: ``:632``)."""
    if isinstance(v, Symbol):
        return {"__sym__": json.loads(v.tojson())}
    if isinstance(v, (list, tuple)):
        if any(isinstance(x, Symbol) for x in v):
            return {"__symlist__": json.loads(Group(list(v)).tojson()),
                    "n": len(v)}
        if isinstance(v, tuple):
            return tuple(_wire_attr(x) for x in v)
        return [_wire_attr(x) for x in v]
    if isinstance(v, dict):
        return {k: _wire_attr(x) for k, x in v.items()}
    return v


def _unwire_attr(v):
    if isinstance(v, dict):
        if "__sym__" in v and len(v) == 1:
            return _symbol_from_payload(v["__sym__"])
        if "__symlist__" in v:
            group = _symbol_from_payload(v["__symlist__"])
            return list(group._inputs)
        return {k: _unwire_attr(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unwire_attr(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_unwire_attr(x) for x in v)
    return v


def _symbol_from_payload(payload: dict) -> Symbol:
    # Two phases: make every node, then wire inputs by index, so a
    # malformed file (forward reference, a cycle) loads into a graph that
    # can be judged instead of dying here; indices out of range raise.
    nodes: List[Optional[Symbol]] = []
    prev = getattr(_DESERIALIZING, "flag", False)
    _DESERIALIZING.flag = True
    try:
        for nd_ in payload["nodes"]:
            attrs = {}
            for k, v in nd_.get("attrs", {}).items():
                try:
                    # literal_eval only: symbol files are an untrusted
                    # load path, never execute code from them
                    attrs[k] = _unwire_attr(ast.literal_eval(v))
                except (ValueError, SyntaxError):
                    attrs[k] = v
            if nd_.get("base") is not None:
                nodes.append(None)  # multi-output slice: resolved below
            else:
                nodes.append(Symbol(
                    nd_["op"] if nd_["op"] != "null" else None,
                    [], attrs, name=nd_["name"],
                    num_outputs=nd_.get("num_outputs", 1)))

        def _at(idx):
            if not isinstance(idx, int) or idx < 0 or idx >= len(nodes):
                raise MXNetError(
                    f"symbol JSON: node index {idx!r} out of range "
                    f"[0, {len(nodes)})")
            return nodes[idx]

        # slices may reference their base forward (and chain): resolve
        # until a sweep makes no progress
        pending = [i for i, s in enumerate(nodes) if s is None]
        while pending:
            left = [i for i in pending
                    if _at(payload["nodes"][i]["base"]) is None]
            if len(left) == len(pending):
                raise MXNetError(
                    "symbol JSON: unresolvable multi-output 'base' "
                    f"references at node indices {left}")
            for i in pending:
                nd_ = payload["nodes"][i]
                base = _at(nd_["base"])
                if base is not None:
                    nodes[i] = base[nd_["output_index"]]
            pending = left
        for sym_node, nd_ in zip(nodes, payload["nodes"]):
            if nd_.get("base") is None:
                sym_node._inputs = [_at(i[0]) for i in nd_["inputs"]]
    finally:
        _DESERIALIZING.flag = prev
    return _at(payload["heads"][0][0])


def load_json(s: str) -> Symbol:
    return _symbol_from_payload(json.loads(s))


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def zeros(shape, dtype="float32", **kwargs) -> Symbol:
    return Symbol("_sym_zeros", [],
                  attrs={"shape": shape, "dtype": onp.dtype(dtype).name})


def ones(shape, dtype="float32", **kwargs) -> Symbol:
    return Symbol("_sym_ones", [],
                  attrs={"shape": shape, "dtype": onp.dtype(dtype).name})


def _make_sym_op(opname: str):
    def sym_op(*args, name: Optional[str] = None, **kwargs):
        ins = [a for a in args if isinstance(a, Symbol)]
        ins += [v for v in kwargs.values() if isinstance(v, Symbol)]
        kwargs = {k: v for k, v in kwargs.items()
                  if not isinstance(v, Symbol)}
        node = Symbol(opname, ins, attrs=kwargs, name=name)
        if opname in _PARAM_OPS:
            # missing weight/bias inputs become variables named after the
            # node (mx.sym.FullyConnected(data, num_hidden=) grows
            # <name>_weight and <name>_bias)
            slots, _ = _PARAM_OPS[opname]
            needed = [s for s in slots
                      if not (s == "bias" and kwargs.get("no_bias", False))]
            while len(node._inputs) - 1 < len(needed):
                slot = needed[len(node._inputs) - 1]
                node._inputs.append(Variable(f"{node._name}_{slot}"))
        return node
    sym_op.__name__ = opname
    return sym_op


for _name in list(OPS):
    if not hasattr(_this, _name):
        setattr(_this, _name, _make_sym_op(_name))


def __getattr__(name):
    # mx.sym.contrib is mx.contrib.sym; an op registered after this module
    # was imported composes too
    if name == "contrib":
        from ..contrib import sym as _contrib_sym
        return _contrib_sym
    if name in OPS:
        op = _make_sym_op(name)
        setattr(_this, name, op)
        return op
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
