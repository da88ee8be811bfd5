"""Control-flow operators: ``foreach``, ``while_loop`` and ``cond``.

Counterpart: the JAX package's ``ops/control_flow.py``: the registry ops
``_foreach`` (``:106``), ``_while_loop`` (``:144``) and ``_cond``
(``:209``), the NDArray front end ``foreach`` (``:270``), ``while_loop``
(``:332``) and ``cond`` (``:407``) that ``mx.contrib.nd`` exposes, and the
Symbol front end ``sym_foreach``/``sym_while_loop``/``sym_cond``
(``:482-562``) behind ``mx.contrib.sym``, whose ``_foreach``/``_while_loop``/
``_cond`` nodes and subgraph payloads are the JAX JSON byte for byte.

Two forms, as in the JAX package, which picks by whether its inputs are
tracers:

- **Eager** (a call outside a hybridized block, on NDArrays or tensors): a
  true Python loop or branch, the reference's imperative semantics. A body
  may read the host, each step's side effects fire once, ``while_loop``
  returns exactly the steps it ran and ``cond`` runs only the branch its
  predicate (read on the host) takes. Gradients flow through the tape to
  everything the body touches.
- **Graph** (the forward of a hybridized block, whatever it is given, and
  the registry ops, which ``mx.sym`` evaluates): no host read, so a CUDA
  graph can capture it. ``foreach`` is the loop unrolled; ``while_loop``
  runs ``max_iterations`` masked ticks and pads the rows after the last
  executed step with zeros (the JAX traced form, ``:14-17``); ``cond``
  runs both branches and selects one with ``torch.where``. The selection is
  also made on each branch's inputs (:class:`_GateInputs`): a branch that
  is not taken reads a detached copy of every tensor it takes from outside,
  so a NaN or an infinity of its backward (a ``sqrt`` at 0, a ``log`` of a
  negative) never reaches a gradient. ``while_loop``'s masked ticks gate
  their inputs the same way.

A hybridized block's first call gives the graph form too, so its first
and later calls agree; the JAX package's first call (its eager warm-up)
gives the eager form. The per-step dropout keys the JAX traced loops
thread through their carry (``:82-104``) have no counterpart: a port body
draws from its device's generator at each step, so both forms draw fresh
masks a step, and dropout streams do not cross the packages.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from ..base import MXNetError
from .registry import register_op

__all__ = ["foreach", "while_loop", "cond",
           "sym_foreach", "sym_while_loop", "sym_cond", "graph_form",
           "in_graph_form"]


# ---------------------------------------------------------------------------
# which form: a hybridized block's forward marks the graph form
# ---------------------------------------------------------------------------

class _Form(threading.local):
    def __init__(self):
        self.depth = 0


_FORM = _Form()


class graph_form:
    """Scope of a hybridized block's forward: control flow inside takes
    the graph form (module docstring)."""

    def __enter__(self):
        _FORM.depth += 1
        return self

    def __exit__(self, *exc):
        _FORM.depth -= 1


def in_graph_form() -> bool:
    return _FORM.depth > 0


def _no_capture(who: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            f"{who}'s eager form reads the host, which a CUDA graph capture "
            "cannot hold: hybridize() the block that calls it, so that it "
            "takes the graph form")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _as_seq(x) -> Tuple[list, bool]:
    """Normalize an array-or-list to (list, was_single)."""
    if isinstance(x, (list, tuple)):
        return list(x), False
    return [x], True


def _repack(lst, single):
    return lst[0] if single else list(lst)


def _is_nd(values) -> bool:
    from ..ndarray import NDArray
    return any(isinstance(v, NDArray) for v in values)


def _tensor(v) -> torch.Tensor:
    from ..ndarray import NDArray
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v)


def _stack(rows: list):
    """Rows of one output (NDArrays or tensors) stacked on a new axis 0."""
    from ..ndarray import NDArray
    from ..ndarray.op import _nd_op
    if isinstance(rows[0], NDArray):
        return _nd_op(torch.stack)(list(rows))
    return torch.stack(list(rows))


def _host_true(c) -> bool:
    """A scalar predicate (NDArray, tensor or Python value) read on the
    host."""
    if isinstance(c, (bool, int, float)):
        return bool(c)
    return bool(_tensor(c).reshape(()).item())


def _scalar_bool(x) -> torch.Tensor:
    return _tensor(x).reshape(()).to(torch.bool)


def _sub_step(sub: Dict[str, Any]):
    """Step callable of a symbolic subgraph spec: ``vals`` (placeholder
    order = ``sub['arg_names']``) -> the primary outputs of
    ``sub['roots']``."""
    from .. import symbol as S
    roots = S.Group(list(sub["roots"]))
    names = list(sub["arg_names"])

    def run(vals):
        return list(S._eval_graph(roots, names, list(vals)))

    return run


class _GateInputs(TorchFunctionMode):
    """Every tensor that requires grad and that an op inside the scope
    takes from outside it is read as ``where(keep, t, t.detach())``: the
    same values, and no gradient back to ``t`` where ``keep`` is false
    (``keep``: a bool scalar on the device, never read on the host)."""

    def __init__(self, keep: torch.Tensor):
        super().__init__()
        self._keep = keep
        self._inner: Dict[int, torch.Tensor] = {}
        self._gated: Dict[int, tuple] = {}

    def _gate(self, t):
        if not isinstance(t, torch.Tensor) or not t.requires_grad \
                or id(t) in self._inner:
            return t
        hit = self._gated.get(id(t))
        if hit is None:
            g = torch.where(self._keep.to(t.device), t, t.detach())
            hit = self._gated[id(t)] = (t, g)
            self._inner[id(g)] = g
        return hit[1]

    def gate_all(self, values) -> list:
        """Gate explicit inputs (called outside the scope)."""
        return [self._gate(v) for v in values]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map(self._gate, (args, kwargs or {}))
        out = func(*args, **kwargs)
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                # the output is kept alive here, so its id stays its own
                self._inner[id(t)] = t
        return out


def _gated(keep: torch.Tensor, fn, inputs) -> list:
    """``fn(inputs)`` with every input, and every tensor it takes from
    outside, gated by ``keep``."""
    gate = _GateInputs(keep)
    ins = gate.gate_all(inputs)
    with gate:
        return list(fn(ins))


# ---------------------------------------------------------------------------
# registry ops: the graph form on tensors (``mx.sym`` evaluates these)
# ---------------------------------------------------------------------------

@register_op("_foreach")
def _foreach_op(*arrays, body=None, sub=None, n_data=1, n_states=0,
                n_outs=1, **_):
    """``body`` over axis 0 of the data arrays, unrolled (JAX counterpart:
    ``:106``, one ``lax.scan``). Inputs are ``data x n_data, init_states x
    n_states, captured...``; outputs are the per-step outputs stacked on a
    new axis 0, then the final states."""
    n_data, n_states, n_outs = int(n_data), int(n_states), int(n_outs)
    data = list(arrays[:n_data])
    states = list(arrays[n_data:n_data + n_states])
    capt = list(arrays[n_data + n_states:])
    if body is None:
        run = _sub_step(sub)

        def body(xs, st, cp):
            res = run(list(xs) + list(st) + list(cp))
            return res[:n_outs], res[n_outs:]

    T = int(data[0].shape[0])
    if T == 0:
        # no step to stack: one step on zeros (no gradient) learns the
        # outputs' shapes and dtypes
        with torch.no_grad():
            outs, _ = body([d.new_zeros(d.shape[1:]) for d in data],
                           states, capt)
        return tuple(o.new_zeros((0,) + tuple(o.shape)) for o in outs) \
            + tuple(states)
    rows: List[list] = []
    for t in range(T):
        outs, states = body([d[t] for d in data], states, capt)
        states = list(states)
        rows.append(list(outs))
    stacked = [torch.stack([r[i] for r in rows]) for i in range(len(rows[0]))]
    return tuple(stacked) + tuple(states)


@register_op("_while_loop")
def _while_loop_op(*arrays, cond_fn=None, step_fn=None, sub=None,
                   n_states=1, n_outs=1, max_iterations=None, **_):
    """Bounded while loop of ``max_iterations`` masked ticks (JAX
    counterpart: ``:144``, a masked ``lax.scan``). Inputs ``loop_vars x
    n_states, captured...``; outputs are the per-tick outputs stacked over
    ``max_iterations`` (rows after the last executed step are zero), then
    the final loop vars. A tick after the condition failed leaves the vars
    as they were and gates its inputs (:class:`_GateInputs`)."""
    if max_iterations is None:
        raise ValueError("_while_loop requires max_iterations")
    n_states, n_outs = int(n_states), int(n_outs)
    states = list(arrays[:n_states])
    capt = list(arrays[n_states:])
    if step_fn is None:
        run_cond = _sub_step({"roots": sub["cond_roots"],
                              "arg_names": sub["arg_names"]})
        run_step = _sub_step({"roots": sub["roots"],
                              "arg_names": sub["arg_names"]})

        def cond_fn(st, cp):
            return run_cond(list(st) + list(cp))[0]

        def step_fn(st, cp):
            res = run_step(list(st) + list(cp))
            return res[:n_outs], res[n_outs:]

    active = None
    rows: List[list] = []
    for _ in range(int(max_iterations)):
        c = _scalar_bool(cond_fn(states, capt))
        ok = c if active is None else active & c
        gate = _GateInputs(ok)
        ins = gate.gate_all(states)
        with gate:
            outs, new_st = step_fn(ins, capt)
        states = [torch.where(ok, n, o) for n, o in zip(new_st, states)]
        rows.append([torch.where(ok, o, torch.zeros_like(o)) for o in outs])
        active = ok
    stacked = ([torch.stack([r[i] for r in rows]) for i in range(len(rows[0]))]
               if rows and rows[0] else [])
    return tuple(stacked) + tuple(states)


@register_op("_cond")
def _cond_op(pred, *capt, then_branch=None, else_branch=None, sub=None,
             n_outs=1, **_):
    """Two-branch conditional (JAX counterpart: ``:209``, ``lax.cond``):
    both branches run, each on its inputs gated by the predicate
    (:class:`_GateInputs`), and ``torch.where`` picks the taken branch's
    outputs. Branch outputs must agree in count and shape."""
    p = _scalar_bool(pred)
    if then_branch is None:
        run_t = _sub_step({"roots": sub["then"], "arg_names": sub["arg_names"]})
        run_e = _sub_step({"roots": sub["else"], "arg_names": sub["arg_names"]})

        def then_branch(cp):
            return run_t(cp)

        def else_branch(cp):
            return run_e(cp)

    t_out = _gated(p, then_branch, capt)
    e_out = _gated(~p, else_branch, capt)
    if len(t_out) != len(e_out) or any(
            tuple(a.shape) != tuple(b.shape) for a, b in zip(t_out, e_out)):
        raise ValueError(
            "cond: then/else branches must give outputs of the same count "
            f"and shapes, got {[tuple(a.shape) for a in t_out]} and "
            f"{[tuple(b.shape) for b in e_out]}")
    out = tuple(torch.where(p, a, b) for a, b in zip(t_out, e_out))
    return out if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# NDArray front end (mx.nd.contrib / mx.contrib.nd)
# ---------------------------------------------------------------------------

def _wrap_as(values, nd: bool) -> list:
    """Tensors as NDArrays on the tape (``nd``), else as they are."""
    if not nd:
        return list(values)
    from ..ndarray.ndarray import _recorded
    return [_recorded(v) for v in values]


def _graph_call(fn, arrays, nd: bool, **kwargs) -> list:
    """A registry op of the graph form on ``arrays``' tensors; its outputs
    as NDArrays on the tape when the inputs were NDArrays."""
    from .. import autograd
    vals = [_tensor(a) for a in arrays]
    grad = autograd.is_recording() if nd else torch.is_grad_enabled()
    with torch.set_grad_enabled(grad):
        res = fn(*vals, **kwargs)
    res = list(res) if isinstance(res, (list, tuple)) else [res]
    return _wrap_as(res, nd)


def _step_adapter(call_body, n_states: int, fmt: dict, nd: bool, who: str):
    """A user body on NDArrays or tensors -> the registry op's step over
    tensors (``call_body(xs, st) -> (out, new_states)``)."""
    def step(xs_vals, st_vals, _capt):
        xs, st = _wrap_as(xs_vals, nd), _wrap_as(st_vals, nd)
        out, new_st = call_body(xs, st)
        out_l, o_single = _as_seq(out if out is not None else [])
        new_l, _ = _as_seq(new_st)
        if len(new_l) != n_states:
            raise ValueError(f"{who}: body must preserve the number of "
                             f"states ({n_states}), got {len(new_l)}")
        fmt["o_single"] = o_single
        fmt["n_outs"] = len(out_l)
        return [_tensor(a) for a in out_l], [_tensor(a) for a in new_l]

    return step


def foreach(body, data, init_states, name: str = "foreach"):
    """``mx.nd.contrib.foreach`` (JAX counterpart: ``:270``): run
    ``body(data_t, states) -> (outputs, new_states)`` over axis 0 of
    ``data``; returns (stacked outputs, final states). The eager form
    (module docstring) is a Python loop; a hybridized block's forward (and
    the T == 0 edge, where only a step can learn the output shapes) takes
    the graph form, the loop unrolled."""
    data_l, d_single = _as_seq(data)
    states_l, s_single = _as_seq(init_states)
    nd = _is_nd(data_l + states_l)
    T = data_l[0].shape[0]
    if not in_graph_form() and T > 0:
        st = _repack(list(states_l), s_single)
        out_steps: List[list] = []
        o_single = True
        for t in range(T):
            xs = [d[t] for d in data_l]
            out, st = body(_repack(xs, d_single), st)
            if len(_as_seq(st)[0]) != len(states_l):
                raise ValueError(
                    f"foreach: body must preserve the number of states "
                    f"({len(states_l)}), got {len(_as_seq(st)[0])}")
            out_l, o_single = _as_seq(out if out is not None else [])
            out_steps.append(out_l)
        stacked = [_stack([row[i] for row in out_steps])
                   for i in range(len(out_steps[0]))] if out_steps[0] else []
        final_l, _ = _as_seq(st)
        return (_repack(stacked, o_single) if stacked else [],
                _repack(list(final_l), s_single))

    fmt: Dict[str, Any] = {}
    step = _step_adapter(
        lambda xs, st: body(_repack(xs, d_single), _repack(st, s_single)),
        len(states_l), fmt, nd, "foreach")
    res = _graph_call(_foreach_op, [*data_l, *states_l], nd, body=step,
                      n_data=len(data_l), n_states=len(states_l))
    n_outs = fmt["n_outs"]
    return (_repack(res[:n_outs], fmt["o_single"]) if n_outs else [],
            _repack(res[n_outs:], s_single))


def while_loop(cond, func, loop_vars, max_iterations: Optional[int] = None,
               name: str = "while_loop"):
    """``mx.nd.contrib.while_loop`` (JAX counterpart: ``:332``): run
    ``func(*loop_vars) -> (step_output, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times; returns
    (stacked outputs, final loop vars). The eager form returns exactly the
    executed steps; the graph form ``max_iterations`` rows, zero after the
    last executed step."""
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    vars_l, v_single = _as_seq(loop_vars)
    nd = _is_nd(vars_l)

    if not in_graph_form():
        _no_capture("while_loop")
        st = list(vars_l)
        out_steps: List[list] = []
        o_single = True
        steps = 0
        while steps < max_iterations:
            if not _host_true(cond(*st)):
                break
            out, new_st = func(*st)
            out_l, o_single = _as_seq(out if out is not None else [])
            new_l, _ = _as_seq(new_st)
            if len(new_l) != len(st):
                raise ValueError("while_loop: func must preserve the number "
                                 "of loop_vars")
            out_steps.append(out_l)
            st = list(new_l)
            steps += 1
        if out_steps and out_steps[0]:
            stacked = [_stack([row[i] for row in out_steps])
                       for i in range(len(out_steps[0]))]
            stacked = _repack(stacked, o_single)
        else:
            stacked = []
        return stacked, _repack(st, v_single)

    fmt: Dict[str, Any] = {}
    wrapped = _step_adapter(lambda xs, st: func(*st), len(vars_l), fmt, nd,
                            "while_loop")

    def step_fn(st_vals, capt):
        return wrapped((), st_vals, capt)

    def cond_fn(st_vals, _capt):
        return _tensor(cond(*_wrap_as(st_vals, nd)))

    res = _graph_call(_while_loop_op, vars_l, nd, cond_fn=cond_fn,
                      step_fn=step_fn, n_states=len(vars_l),
                      max_iterations=int(max_iterations))
    n_outs = fmt["n_outs"]
    return (_repack(res[:n_outs], fmt["o_single"]) if n_outs else [],
            _repack(res[n_outs:], v_single))


def cond(pred, then_func, else_func, name: str = "cond"):
    """``mx.nd.contrib.cond`` (JAX counterpart: ``:407``): if the scalar
    ``pred`` (an array or a zero-argument callable) is true run
    ``then_func()``, else ``else_func()``. The eager form reads the
    predicate on the host and runs one branch; the graph form runs both on
    gated inputs and selects (module docstring)."""
    p = pred() if callable(pred) else pred
    if not isinstance(p, torch.Tensor) and not _is_nd([p]):
        return then_func() if bool(p) else else_func()
    if not in_graph_form():
        _no_capture("cond")
        return then_func() if _host_true(p) else else_func()

    nd = _is_nd([p])
    fmt: Dict[str, Any] = {}

    def _branch(fn, tag):
        def run(_capt):
            out_l, single = _as_seq(fn())
            fmt[tag] = (single, len(out_l))
            return [_tensor(a) for a in out_l]
        return run

    try:
        res = _graph_call(_cond_op, [p], nd,
                          then_branch=_branch(then_func, "then"),
                          else_branch=_branch(else_func, "else"))
    except ValueError as e:
        if "then" in fmt and "else" in fmt and fmt["then"] != fmt["else"]:
            raise _cond_mismatch_error(fmt) from e
        raise
    if fmt["then"] != fmt["else"]:
        raise _cond_mismatch_error(fmt)
    return _repack(res, fmt["then"][0])


def _cond_mismatch_error(fmt) -> ValueError:
    return ValueError(
        "cond: then/else branches disagree on output structure "
        f"(then: single={fmt['then'][0]}, n_outs={fmt['then'][1]}; "
        f"else: single={fmt['else'][0]}, n_outs={fmt['else'][1]}); "
        "return the same single-array-vs-list style from both branches")


# ---------------------------------------------------------------------------
# Symbol front end (mx.sym.contrib / mx.contrib.sym): the JAX package's
# functions (``:466-562``), so the nodes serialize to the same JSON
# ---------------------------------------------------------------------------

def _free_vars(roots, bound_names):
    """Variable nodes reachable from ``roots`` that are not placeholders:
    the subgraph's captured inputs."""
    from .. import symbol as S
    seen, out = set(), []
    for r in roots:
        for node in S._topo(r):
            if node._op is None and node._base is None \
                    and node._name not in bound_names \
                    and id(node) not in seen:
                seen.add(id(node))
                out.append(node)
    return out


def sym_foreach(body, data, init_states, name: str = "foreach"):
    """``mx.sym.contrib.foreach``: the ``_foreach`` subgraph node.
    ``body(data_t, states) -> (outputs, new_states)`` is called once with
    placeholder Variables to cut the subgraph; its free variables become
    captured node inputs."""
    from .. import symbol as S
    data_l, d_single = _as_seq(data)
    states_l, s_single = _as_seq(init_states)
    data_ph = [S.Variable(f"{name}_data{i}") for i in range(len(data_l))]
    state_ph = [S.Variable(f"{name}_state{i}") for i in range(len(states_l))]
    out, new_st = body(_repack(list(data_ph), d_single),
                       _repack(list(state_ph), s_single))
    out_l, o_single = _as_seq(out if out is not None else [])
    new_l, _ = _as_seq(new_st)
    if len(new_l) != len(states_l):
        raise ValueError("foreach: body must preserve the number of states")
    ph_names = [p.name for p in data_ph] + [p.name for p in state_ph]
    capt = _free_vars(out_l + new_l, set(ph_names))
    sub = {"roots": out_l + new_l,
           "arg_names": ph_names + [c.name for c in capt]}
    node = S.Symbol("_foreach", [*data_l, *states_l, *capt],
                    attrs={"sub": sub, "n_data": len(data_l),
                           "n_states": len(states_l), "n_outs": len(out_l)},
                    name=name, num_outputs=len(out_l) + len(new_l))
    outs = [node[i] for i in range(len(out_l))]
    states_out = [node[len(out_l) + j] for j in range(len(new_l))]
    return (_repack(outs, o_single if out_l else True),
            _repack(states_out, s_single))


def sym_while_loop(cond, func, loop_vars, max_iterations: Optional[int] = None,
                   name: str = "while_loop"):
    """``mx.sym.contrib.while_loop``: the ``_while_loop`` subgraph node.
    Outputs are stacked over ``max_iterations`` ticks (zero-padded after
    the executed steps)."""
    from .. import symbol as S
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    vars_l, v_single = _as_seq(loop_vars)
    ph = [S.Variable(f"{name}_var{i}") for i in range(len(vars_l))]
    pred = cond(*ph)
    out, new_st = func(*ph)
    out_l, o_single = _as_seq(out if out is not None else [])
    new_l, _ = _as_seq(new_st)
    if len(new_l) != len(vars_l):
        raise ValueError("while_loop: func must preserve the number of "
                         "loop_vars")
    ph_names = [p.name for p in ph]
    capt = _free_vars([pred] + out_l + new_l, set(ph_names))
    sub = {"roots": out_l + new_l, "cond_roots": [pred],
           "arg_names": ph_names + [c.name for c in capt]}
    node = S.Symbol("_while_loop", [*vars_l, *capt],
                    attrs={"sub": sub, "n_states": len(vars_l),
                           "n_outs": len(out_l),
                           "max_iterations": int(max_iterations)},
                    name=name, num_outputs=len(out_l) + len(new_l))
    outs = [node[i] for i in range(len(out_l))]
    states_out = [node[len(out_l) + j] for j in range(len(new_l))]
    return (_repack(outs, o_single if out_l else True),
            _repack(states_out, v_single))


def sym_cond(pred, then_func, else_func, name: str = "cond"):
    """``mx.sym.contrib.cond``: the ``_cond`` subgraph node. ``pred`` is a
    Symbol (or a zero-argument callable giving one) evaluated in the outer
    graph; the branch subgraphs capture their free variables."""
    from .. import symbol as S
    p = pred if isinstance(pred, S.Symbol) else pred()
    then_l, t_single = _as_seq(then_func())
    else_l, e_single = _as_seq(else_func())
    if len(then_l) != len(else_l):
        raise ValueError("cond: then/else branches must produce the same "
                         "number of outputs")
    capt = _free_vars(then_l + else_l, set())
    sub = {"then": then_l, "else": else_l,
           "arg_names": [c.name for c in capt]}
    node = S.Symbol("_cond", [p, *capt],
                    attrs={"sub": sub, "n_outs": len(then_l)},
                    name=name, num_outputs=len(then_l))
    outs = [node[i] for i in range(len(then_l))]
    return _repack(outs, t_single)
