"""PyTorch port: the ``mx.nd`` op surface held against the JAX package on
the CPU.

Every name of the JAX registry and of the JAX ``mx.nd`` is in the port's
``mx.nd`` or on one list of names a later slice brings; the four repaired
faults (MXNet's reshape codes, integer reductions, MXNet's keyword
arguments, saturating casts); each op family of ``ops/tensor.py``,
``ops/nn.py`` and ``ops/vision.py`` on the same seeded inputs as the
reference, outputs and, where an op is differentiable, the gradients for
one seeded cotangent; the JAX package's own op tests run on the port; and
``amp.init`` over the new ops.

Tolerances (float32, relative to the largest reference value, with the
same absolute floor): elementwise, shape and custom-gradient ops 1e-5
(another summation order or libm; observed ~1e-7); reductions, softmax and
normalisation 1e-5; the special functions (``erfinv``, ``gamma``,
``gammaln``, ``digamma``) and linear algebra 1e-4 (other algorithms;
observed ~1e-6); bilinear resizes, sampling and correlation 1e-5. Integer,
boolean and index results, ties included, are equal, and every dtype is
the reference's.
"""
import importlib.util
import inspect
import types
import typing

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu.ops.registry import OPS as JOPS

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import amp, autograd, nd
from incubator_mxnet_tpu_torch.ops.registry import OPS

#: JAX ``mx.nd`` names a later slice brings -> the ROADMAP queue A item
#: (none since ``Custom``, the ``interleaved_matmul_*`` ops and ``sparse``
#: came with item 7c-1)
DEFERRED = {}

METHODS = ("argmax", "argmin", "as_in_ctx", "broadcast_like", "dot", "norm",
           "one_hot", "pick", "prod", "reshape_like", "sign", "slice",
           "stype", "take", "tostype", "to_dlpack_for_read",
           "to_dlpack_for_write", "as_nd_ndarray", "asnumpy_or_none",
           "version")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _dt(x) -> str:
    return str(onp.dtype(x.dtype)) if not isinstance(x.dtype, str) \
        else x.dtype


def _as_j(v):
    return jnp.asarray(v) if isinstance(v, onp.ndarray) else v


def _as_p(v):
    return nd.array(v, dtype=v.dtype) if isinstance(v, onp.ndarray) else v


def _outs(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _close(name, got, want, tol):
    """Equal dtype and shape; equal values for integers and booleans,
    else within ``tol`` of the largest reference value (NaN where NaN)."""
    assert _dt(got) == _dt(want), (name, _dt(got), _dt(want))
    g = got.asnumpy() if hasattr(got, "asnumpy") else onp.asarray(got)
    w = onp.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    if w.dtype.kind in "biu":
        onp.testing.assert_array_equal(g, w, err_msg=name)
        return
    finite = onp.isfinite(w)
    scale = max(float(onp.abs(w[finite]).max()) if finite.any() else 0.0,
                1.0)
    onp.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                equal_nan=True, err_msg=name)


#: XLA:CPU's cheapest compile: each reference runs once, so compiling it
#: takes most of its time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


class _Case:
    """One op call of a table: its JAX reference as a function of the
    array arguments, and the gradient positions."""

    def __init__(self, name, args, kw=None, tol=1e-5, grad=(), seed=0):
        self.name, self.args, self.kw = name, args, kw or {}
        self.tol, self.grad = tol, tuple(grad)
        self.pos = [i for i, a in enumerate(args)
                    if isinstance(a, onp.ndarray)]
        self.keys = [k for k, v in self.kw.items()
                     if isinstance(v, onp.ndarray)]
        self.vals = [jnp.asarray(args[i]) for i in self.pos] + [
            jnp.asarray(self.kw[k]) for k in self.keys]
        self.gpos = [self.pos.index(i) for i in self.grad]
        self.seed = seed

    def call(self, vals):
        full = list(self.args)
        for i, v in zip(self.pos, vals[:len(self.pos)]):
            full[i] = v
        kws = dict(self.kw)
        kws.update(zip(self.keys, vals[len(self.pos):]))
        return JOPS[self.name].fn(*full, **kws)

    def cotangent(self, shape):
        return onp.asarray(onp.random.RandomState(self.seed + 1).randn(
            *shape), "float32")

    def run(self, vals, cot):
        """Outputs, and the gradients for ``cot`` of the first output."""
        if not self.gpos:
            return self.call(vals), ()

        def first(*gv):
            v = list(vals)
            for j, g in zip(self.gpos, gv):
                v[j] = g
            return _outs(self.call(v))[0]
        _, vjp = jax.vjp(first, *[vals[j] for j in self.gpos])
        return self.call(vals), vjp(cot)


def _jax_references(cases):
    """Every case's JAX outputs and gradients, the traceable ones in one
    jitted program (one compile for the table), the others (outputs
    whose shape depends on the data) eagerly."""
    traced, results = [], {}
    for n, c in enumerate(cases):
        try:
            shape = _outs(jax.eval_shape(c.call, c.vals))[0].shape
        except Exception:  # noqa: BLE001  (data-dependent: eager)
            cot = c.cotangent(_outs(c.call(c.vals))[0].shape)
            results[n] = c.run(c.vals, jnp.asarray(cot)) + (cot,)
            continue
        traced.append((n, c.cotangent(shape)))
    if traced:
        def program(vals, cots):
            return [cases[n].run(v, ct) for (n, _), v, ct in
                    zip(traced, vals, cots)]
        vals = [cases[n].vals for n, _ in traced]
        cots = [jnp.asarray(ct) for _, ct in traced]
        outs = jax.jit(program).lower(vals, cots).compile(FAST_COMPILE)(
            vals, cots)
        for (n, ct), (out, grads) in zip(traced, outs):
            results[n] = (out, grads, ct)
    return [results[n] for n in range(len(cases))]


def _check_port(c, want, wants, cot):
    """``mx.nd.<name>`` on NDArrays against the reference's outputs and
    gradients."""
    pkw = {k: _as_p(v) for k, v in c.kw.items()}
    got = getattr(nd, c.name)(*[_as_p(a) for a in c.args], **pkw)
    for i, (g, w) in enumerate(zip(_outs(got), _outs(want))):
        _close(f"{c.name} output {i}", g, w, c.tol)
    if not c.grad:
        return
    pargs = [_as_p(a) for a in c.args]
    for i in c.grad:
        pargs[i].attach_grad()
    with autograd.record():
        out = _outs(getattr(nd, c.name)(*pargs, **pkw))[0]
    out.backward(nd.array(cot))
    for i, w in zip(c.grad, wants):
        _close(f"{c.name} gradient of argument {i}", pargs[i].grad, w, c.tol)


def run_table(table):
    """Each ``(name, args[, options])`` of ``table`` on both packages;
    every failure is reported, by op name."""
    cases = [_Case(t[0], t[1], **(t[2] if len(t) > 2 else {}))
             for t in table]
    failed = []
    for c, (want, wants, cot) in zip(cases, _jax_references(cases)):
        try:
            _check_port(c, want, wants, cot)
        except Exception as e:  # noqa: BLE001  (reported below, by name)
            failed.append(f"{c.name} {sorted(c.kw)}: {type(e).__name__}: "
                          f"{str(e)[:300]}")
    assert not failed, "\n".join(failed)


# -- the name audit ---------------------------------------------------------------
def _jax_public_names():
    """The public names of the JAX ``mx.nd`` (its own, not the modules and
    typing objects it imports) and the registry's."""
    names = set()
    for n in dir(jmx.nd):
        if n.startswith("_"):
            continue
        v = getattr(jmx.nd, n)
        if isinstance(v, types.ModuleType) and not v.__name__.startswith(
                "incubator_mxnet_tpu"):
            continue
        if v is typing.Optional:
            continue
        names.add(n)
    return names | {n for n in JOPS if not n.startswith("_")}


def test_mx_nd_name_audit():
    want = _jax_public_names()
    missing = sorted(n for n in want if not hasattr(nd, n)
                     and n not in DEFERRED)
    assert not missing, f"mx.nd lacks {missing}"
    # the deferred list holds only names the port still lacks
    assert not [n for n in DEFERRED if hasattr(nd, n)]
    assert set(DEFERRED) <= want
    lacking = [m for m in METHODS if not hasattr(nd.NDArray, m)]
    assert not lacking, lacking
    # every registry name of the port is an mx.nd op, aliases the same one
    for name, opdef in OPS.items():
        assert getattr(nd, name) is getattr(nd, opdef.name), name
    assert nd.random_uniform is nd.random.uniform
    assert mx.waitall is nd.waitall
    # make_loss: the registry keeps the MakeLoss of ops/vision.py, as the
    # JAX registry does (it is registered after ops/tensor.py's)
    assert JOPS["make_loss"].name == "MakeLoss"
    assert OPS["make_loss"].name == "MakeLoss"
    assert nd.make_loss is nd.MakeLoss
    x = nd.array([[1.0, 2.0], [3.0, 4.0]])
    assert x.stype == "default" and x.tostype("default") is x
    csr = x.tostype("csr")
    assert csr.stype == "csr"
    onp.testing.assert_array_equal(csr.asnumpy(), x.asnumpy())
    v = x.version
    x[0, 0] = 5.0
    assert x.version > v
    assert onp.from_dlpack(x.to_dlpack_for_read())[0, 0] == 5.0
    assert x.as_in_ctx(mx.cpu()) is x and x.as_nd_ndarray() is x
    onp.testing.assert_array_equal(x.asnumpy_or_none(), x.asnumpy())
    assert nd.from_dlpack(x.to_dlpack_for_write()).shape == (2, 2)


# -- queue C faults 1-4 ----------------------------------------------------------------
RESHAPES = [(-3, 4), (-2,), (2, -2), (-4, 1, 2, -2), (0, -1), (-1, 0, 2),
            (2, -4, -1, 3, 4), (0, -3)]


def test_reshape_special_codes_match_jax():
    """Queue C fault 1: MXNet's codes 0, -1, -2, -3, -4, with and without
    ``reverse`` (taken and not applied, as in the JAX package)."""
    x = onp.arange(24, dtype="float32").reshape(2, 3, 4)
    for shape in RESHAPES:
        for reverse in (False, True):
            want = JOPS["reshape"].fn(jnp.asarray(x), shape=shape,
                                      reverse=reverse)
            got = nd.reshape(nd.array(x), shape=shape, reverse=reverse)
            _close(f"reshape{shape}", got, want, 0.0)
            _close(f"NDArray.reshape{shape}",
                   nd.array(x).reshape(shape, reverse=reverse), want, 0.0)
            _close(f"Reshape{shape}", nd.Reshape(nd.array(x), shape=shape),
                   want, 0.0)
    assert nd.array(x).reshape(-3, 4).shape == (6, 4)


INT_DTYPES = ("int8", "int16", "int32", "uint8")


def test_integer_reductions_match_jax():
    """Queue C fault 2: ``sum`` of int32 is int32, of uint8 uint32,
    ``mean`` of an integer input float32; every integer dtype both
    packages have, for sum, mean, prod, nansum, max and min, over all
    axes, one axis and with ``keepdims``."""
    rng = onp.random.RandomState(3)
    cases = []
    for dt in INT_DTYPES:
        lo = 0 if dt.startswith("u") else -5
        x = rng.randint(lo, 6, (3, 4)).astype(dt)
        for op in ("sum", "mean", "prod", "nansum", "max", "min"):
            for kw in ({}, {"axis": 1}, {"axis": 0, "keepdims": True}):
                cases.append((op, [x], {"kw": kw}))
        cases.append(("sum", [x], {"kw": {"axis": 1, "exclude": True}}))
    run_table(cases)
    assert nd.sum(nd.array([1, 2], dtype="int32")).dtype == onp.int32
    assert nd.sum(nd.array([1, 2], dtype="uint8")).dtype == onp.uint32
    assert float(nd.mean(nd.array([1, 2], dtype="int32")).asscalar()) == 1.5


def test_ops_take_mxnet_keywords():
    """Queue C fault 3: the reference's signatures, ``name=`` and
    ``out=`` on every op."""
    rng = onp.random.RandomState(4)
    x = rng.randn(3, 5).astype("float32")
    ln = onp.array([2, 5, 1], "float32")
    run_table([
        ("relu", [x], {"kw": {"name": "r"}}),
        ("softmax", [x], {"kw": {"temperature": 2.0}}),
        ("softmax", [x, ln], {"kw": {"use_length": True}}),
        ("softmax", [x], {"kw": {"length": ln, "use_length": True,
                                 "axis": -1}}),
        ("sum", [x], {"kw": {"axis": 1, "exclude": True}}),
        ("mean", [x], {"kw": {"axis": (0,), "exclude": True,
                              "keepdims": True}}),
    ])
    a, b = nd.array(x), nd.array(x.T)
    c = nd.zeros((3, 3))
    assert nd.dot(a, b, out=c) is c
    onp.testing.assert_allclose(c.asnumpy(), x @ x.T, rtol=1e-5, atol=1e-5)
    w = rng.randn(5, 3).astype("float32")
    ids = onp.array([[0, 4], [2, 7]], "float32")
    _close("Embedding", nd.Embedding(nd.array(ids), nd.array(w),
                                     input_dim=5, output_dim=3),
           JOPS["Embedding"].fn(jnp.asarray(ids), jnp.asarray(w),
                                input_dim=5, output_dim=3), 0.0)
    _close("NDArray.softmax", a.softmax(axis=0, temperature=3.0),
           JOPS["softmax"].fn(jnp.asarray(x), axis=0, temperature=3.0),
           1e-6)
    _close("NDArray.softmax(length)", a.softmax(nd.array(ln),
                                                use_length=True),
           JOPS["softmax"].fn(jnp.asarray(x), jnp.asarray(ln),
                              use_length=True), 1e-6)


def test_astype_and_cast_saturate_as_jax():
    """Queue C fault 4: a float going to an integer type saturates at
    both ends, as XLA's conversion does; NaN gives 0 in both."""
    x = onp.array([-1.5, 300.7, 1e10, -1e10, 2.5, -2.5, 0.5, 127.9, -128.9,
                   65535.5, onp.nan, onp.inf, -onp.inf], "float32")
    for dt in ("uint8", "int8", "int16", "int32", "bool"):
        want = jnp.asarray(x).astype(dt)
        _close(f"astype({dt})", nd.array(x).astype(dt), want, 0.0)
        _close(f"cast({dt})", nd.cast(nd.array(x), dtype=dt), want, 0.0)
        _close(f"Cast({dt})", nd.Cast(nd.array(x), dtype=dt),
               JOPS["Cast"].fn(jnp.asarray(x), dtype=dt), 0.0)
    assert nd.array([-1.5, 300.7]).astype("uint8").asnumpy().tolist() == \
        [0, 255]


# -- the op families of ops/tensor.py ----------------------------------------------------
def _tensor_cases():
    rng = onp.random.RandomState(5)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    x, y, yb = f(4, 6), f(4, 6), f(1, 6)
    pos = (rng.rand(4, 6) + 0.5).astype("float32")
    u = rng.uniform(-0.9, 0.9, (4, 6)).astype("float32")
    i32 = rng.randint(-7, 8, (4, 6)).astype("int32")
    u8 = rng.randint(0, 255, (4, 6)).astype("uint8")
    i8 = rng.randint(-9, 9, (4, 6)).astype("int8")
    ties = onp.round(x, 0)
    ties[:, 2] = ties[:, 4]
    special = onp.array([0.5, 1.5, 2.5, -0.5, -1.5, onp.nan, onp.inf,
                         -onp.inf, 0.0], "float32")
    g = dict(grad=(0,))
    cases = []
    for name in ("negative", "abs", "sign", "ceil", "floor", "round", "rint",
                 "trunc", "fix", "square", "cbrt", "exp", "expm1", "sin",
                 "cos", "tan", "arctan", "sinh", "cosh", "tanh", "arcsinh",
                 "degrees", "radians", "reciprocal", "erf", "logical_not",
                 "relu", "sigmoid", "softsign", "softrelu", "softplus",
                 "hard_sigmoid", "identity", "copy", "BlockGrad",
                 "stop_gradient", "isnan", "isinf", "isfinite"):
        cases.append((name, [x]))
    for name in ("sqrt", "rsqrt", "rcbrt", "log", "log10", "log2", "log1p"):
        cases.append((name, [pos], g))
    for name in ("arcsin", "arccos", "arctanh"):
        cases.append((name, [u], g))
    cases += [("arccosh", [pos + 1], g), ("erfinv", [u], dict(tol=1e-4)),
              ("gamma", [pos], dict(tol=1e-4)),
              ("gammaln", [pos], dict(tol=1e-4)),
              ("digamma", [pos], dict(tol=1e-4))]
    for name in ("exp", "tanh", "sigmoid", "softrelu", "erf", "relu",
                 "square", "cbrt"):
        cases.append((name, [x], g))
    for name in ("round", "rint", "ceil", "floor", "isnan", "relu", "sign",
                 "abs"):
        cases.append((name, [special]))
    for name in ("ceil", "round", "abs", "sign", "negative", "relu",
                 "square", "logical_not", "sqrt", "degrees", "reciprocal"):
        cases += [(name, [i32]), (name, [u8])]
    for name in ("add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "hypot", "arctan2", "broadcast_add",
                 "broadcast_plus", "broadcast_minus", "broadcast_mul",
                 "broadcast_div", "broadcast_maximum", "broadcast_minimum",
                 "broadcast_hypot", "elemwise_add", "elemwise_sub",
                 "elemwise_mul", "elemwise_div"):
        cases += [(name, [x, y], dict(grad=(0, 1))), (name, [x, yb])]
    for name in ("mod", "broadcast_mod", "floor_divide", "power",
                 "broadcast_power", "pow"):
        cases += [(name, [pos * 3, yb * 0 + 0.7]), (name, [x * 4, yb + 2])]
    for name in ("add", "subtract", "multiply", "divide", "mod",
                 "floor_divide", "maximum", "power", "hypot"):
        # exponents below 64: from 64 on the JAX package does not give
        # the wrapped integer power (queue C, kept)
        cases += [(name, [i32, onp.abs(i32) + 1]), (name, [i8, u8 % 63 + 1]),
                  (name, [x, 2.0]), (name, [i32, 3])]
    for name in ("equal", "not_equal", "greater", "greater_equal", "lesser",
                 "lesser_equal", "less", "less_equal", "logical_and",
                 "logical_or", "logical_xor", "broadcast_equal",
                 "broadcast_not_equal", "broadcast_greater",
                 "broadcast_greater_equal", "broadcast_lesser",
                 "broadcast_lesser_equal", "broadcast_logical_and",
                 "broadcast_logical_or", "broadcast_logical_xor"):
        cases += [(name, [ties, ties.T.reshape(4, 6)]), (name, [x, yb]),
                  (name, [i32, i32[::-1].copy()]), (name, [x, 0.0])]
    cases += [
        ("add_n", [x, y, pos], dict(grad=(0, 2))), ("ElementWiseSum", [x, y]),
        ("sum_n", [x, y, x]),
        ("where", [(x > 0).astype("float32"), x, y], dict(grad=(1, 2))),
        ("where", [i32, x, y]),
        ("clip", [x], dict(kw={"a_min": -0.5, "a_max": 0.7}, grad=(0,))),
        ("clip", [i32], dict(kw={"a_min": -2, "a_max": 3})),
        ("cast", [x * 100], dict(kw={"dtype": "int32"})),
        ("Cast", [x], dict(kw={"dtype": "float16"})),
    ]
    for name in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min",
                 "sum_axis", "max_axis", "min_axis", "norm", "logsumexp"):
        for kw in ({}, {"axis": 1}, {"axis": (0, 1), "keepdims": True},
                   {"axis": -1, "keepdims": True}):
            cases.append((name, [x], dict(kw=kw, grad=(0,))))
    xn = x.copy()
    xn[1, 2] = onp.nan
    cases += [("nansum", [xn], dict(kw={"axis": 1})),
              ("nanprod", [xn], dict(kw={"axis": 0})),
              ("norm", [x], dict(kw={"ord": 1, "axis": 0}, grad=(0,))),
              ("norm", [i32], dict(kw={"axis": 1})),
              ("sum", [x], dict(kw={"axis": ()}))]
    for name in ("argmax", "argmin"):
        for kw in ({}, {"axis": 1}, {"axis": 0, "keepdims": True},
                   {"keepdims": True}):
            cases += [(name, [ties], dict(kw=kw)), (name, [i32], dict(kw=kw))]
        cases.append((name, [onp.array([1.0, onp.nan, 3.0, onp.nan],
                                       "float32")]))
    cases += [("argmax_channel", [ties])]
    # matmul family and linear algebra
    a3, b2 = f(2, 4, 6), f(6, 3)
    spd = (lambda m: m @ m.T + 6 * onp.eye(6, dtype="float32"))(f(6, 6))
    lower = onp.tril(f(6, 6)) + 4 * onp.eye(6, dtype="float32")
    la = dict(grad=(0, 1), tol=1e-4)
    cases += [
        ("dot", [x, y.T], la), ("dot", [x[0], y[0]], la),
        ("dot", [x, y], dict(kw={"transpose_a": True}, grad=(0, 1))),
        ("dot", [x, y], dict(kw={"transpose_b": True}, grad=(0, 1))),
        ("dot", [a3, b2], la),
        ("batch_dot", [a3, f(2, 6, 5)], la),
        ("batch_dot", [a3, f(2, 5, 6)], dict(kw={"transpose_b": True})),
        ("batch_dot", [a3, f(2, 4, 5)], dict(kw={"transpose_a": True})),
        ("matmul", [a3, b2], la), ("khatri_rao", [f(3, 4), f(2, 4)], la),
        ("linalg_gemm2", [x, y], dict(kw={"transpose_b": True,
                                          "alpha": 0.5})),
        ("linalg_gemm", [x, y, f(4, 4)], dict(kw={"transpose_b": True,
                                                  "beta": 2.0},
                                              grad=(0, 1, 2))),
        ("linalg_potrf", [spd], dict(grad=(0,), tol=1e-4)),
        ("linalg_sumlogdiag", [spd], dict(grad=(0,), tol=1e-4)),
        ("linalg_syrk", [x], dict(kw={"alpha": 2.0}, grad=(0,))),
        ("linalg_syrk", [x], dict(kw={"transpose": True})),
        ("linalg_extractdiag", [spd], dict(kw={"offset": 1})),
        ("linalg_makediag", [x]), ("linalg_makediag", [x[0]],
                                   dict(kw={"offset": 1})),
        ("tril", [x], dict(kw={"k": 1})), ("triu", [x], dict(kw={"k": -1})),
    ]
    for kw in ({}, {"transpose": True}, {"rightside": True},
               {"rightside": True, "transpose": True}, {"lower": False},
               {"alpha": 2.0}):
        B = f(6, 3) if not kw.get("rightside") else f(3, 6)
        A = lower if kw.get("lower", True) else lower.T.copy()
        cases += [("linalg_trsm", [A, B], dict(kw=kw, grad=(0, 1),
                                              tol=1e-4)),
                  ("linalg_trmm", [A, B], dict(kw=kw, grad=(0, 1)))]
    # shapes and indexing
    idx = onp.array([[0, 5, -2], [3, 3, 9]], "float32")
    cases += [
        ("reshape_like", [x, f(3, 8)], g), ("transpose", [a3], g),
        ("transpose", [a3], dict(kw={"axes": (1, 0, 2)})),
        ("swapaxes", [a3], dict(kw={"dim1": 0, "dim2": 2})),
        ("SwapAxis", [a3], dict(kw={"dim1": 1, "dim2": 2})),
        ("flatten", [a3]), ("Flatten", [a3]),
        ("expand_dims", [x], dict(kw={"axis": 1})),
        ("squeeze", [f(1, 4, 1)]), ("squeeze", [f(1, 4, 1)],
                                    dict(kw={"axis": 2})),
        ("broadcast_to", [yb], dict(kw={"shape": (4, 0)}, grad=(0,))),
        ("broadcast_like", [yb, x]),
        ("broadcast_axis", [f(2, 1, 3)], dict(kw={"axis": 1, "size": 4},
                                               grad=(0,))),
        ("broadcast_axes", [f(1, 1, 3)], dict(kw={"axis": (0, 1),
                                                  "size": (2, 5)})),
        ("slice", [a3], dict(kw={"begin": (0, 1, None),
                                 "end": (2, None, 5)}, grad=(0,))),
        ("slice", [a3], dict(kw={"begin": (None, 3, 5), "end": (None, 0, 1),
                                 "step": (1, -1, -2)}, grad=(0,))),
        ("crop", [a3], dict(kw={"begin": (1, 0), "end": (2, 3)})),
        ("slice_axis", [a3], dict(kw={"axis": 2, "begin": 1, "end": -1},
                                  grad=(0,))),
        ("slice_like", [a3, f(1, 2, 3)], dict(kw={"axes": (1, 2)})),
        ("take", [x, idx], dict(grad=(0,))),
        ("take", [x, idx], dict(kw={"axis": 1, "mode": "wrap"})),
        ("pick", [x, onp.array([0, 5, -1, 9], "float32")], g),
        ("pick", [x, onp.array([1, 2, 0, 3, 3, 1], "float32")],
         dict(kw={"axis": 0, "keepdims": True})),
        ("choose_element_0index", [x, onp.array([0, 5, 2, 1], "float32")]),
        ("gather_nd", [a3, onp.array([[1, 0, 1], [2, 3, 0]], "float32")],
         g),
        ("scatter_nd", [f(3), onp.array([[1, 0, 1], [2, 3, 0]], "float32")],
         dict(kw={"shape": (2, 4)})),
        ("one_hot", [onp.array([0, 3, -1, 5, 2], "float32")],
         dict(kw={"depth": 4})),
        ("one_hot", [onp.array([1, 2], "int32")],
         dict(kw={"depth": 3, "on_value": 5.0, "off_value": -1.0,
                  "dtype": "int32"})),
        ("concat", [x, y, pos], dict(kw={"dim": 0}, grad=(0, 1))),
        ("Concat", [x, y]), ("concat", [x, i32]),
        ("stack", [x, y], dict(kw={"axis": 1}, grad=(0, 1))),
        ("split", [x], dict(kw={"num_outputs": 3, "axis": 1})),
        ("SliceChannel", [x], dict(kw={"num_outputs": 2, "axis": 0,
                                       "squeeze_axis": False})),
        ("split_v2", [x], dict(kw={"indices_or_sections": 2})),
        ("split_v2", [x], dict(kw={"indices_or_sections": (1, 4),
                                   "axis": 1})),
        ("tile", [x], dict(kw={"reps": (2, 1, 3)}, grad=(0,))),
        ("repeat", [x], dict(kw={"repeats": 2})),
        ("repeat", [x], dict(kw={"repeats": 3, "axis": 1}, grad=(0,))),
        ("pad", [f(1, 2, 3, 4)], dict(kw={"mode": "constant",
                                          "pad_width": (0, 0, 1, 0, 2, 1,
                                                        0, 3),
                                          "constant_value": 1.5})),
        ("Pad", [f(1, 2, 3, 4)], dict(kw={"mode": "edge",
                                          "pad_width": (0, 0, 0, 0, 1, 2,
                                                        2, 1)})),
        ("reverse", [a3], dict(kw={"axis": (0, 2)})),
        ("flip", [a3], dict(kw={"axis": 1})),
        ("roll", [a3], dict(kw={"shift": 2, "axis": 1})),
        ("roll", [a3], dict(kw={"shift": -3})),
        ("diag", [x], dict(kw={"k": 1})), ("diag", [x[0]],
                                           dict(kw={"k": -1})),
        ("depth_to_space", [f(2, 8, 3, 3)], dict(kw={"block_size": 2},
                                                 grad=(0,))),
        ("space_to_depth", [f(2, 2, 4, 6)], dict(kw={"block_size": 2})),
        ("ravel_multi_index", [onp.array([[-1, 5, 1], [1, 9, 2]],
                                         "float32")],
         dict(kw={"shape": (2, 3)})),
        ("unravel_index", [onp.array([-1, 7, 100, 4], "float32")],
         dict(kw={"shape": (2, 3)})),
        ("shape_array", [a3]), ("size_array", [a3]),
        ("zeros_like", [i32]), ("ones_like", [x]),
        ("full_like", [x], dict(kw={"fill_value": 2.5})),
    ]
    # ordering, ties included, on a vocabulary row with forced ties
    vocab = onp.round(f(4, 301) * 2, 0)
    vocab[:, 7] = vocab[:, 100] = vocab[:, 300] = vocab.max() + 1
    for data in (ties, vocab):
        for kw in ({}, {"is_ascend": False}, {"axis": 0}):
            cases += [("sort", [data], dict(kw=kw)),
                      ("argsort", [data], dict(kw=kw))]
        for kw in ({"k": 3}, {"k": 2, "is_ascend": True},
                   {"k": 2, "axis": 0}, {"k": 4, "ret_typ": "value"},
                   {"k": 3, "ret_typ": "both", "dtype": "int32"},
                   {"k": 2, "ret_typ": "mask"},
                   {"k": 3, "ret_typ": "mask", "is_ascend": True}):
            cases.append(("topk", [data], dict(kw=kw)))
    signed = onp.array([[0.0, -0.0, 0.0, -0.0, 0.0, 2.0, -1.0, onp.nan,
                         -onp.nan, onp.inf]], "float32")
    cases += [("sort", [special]), ("argsort", [special],
                                    dict(kw={"dtype": "int32"})),
              ("sort", [signed]), ("argsort", [signed],
                                   dict(kw={"is_ascend": False})),
              ("topk", [signed], dict(kw={"k": 10})),
              ("topk", [signed], dict(kw={"k": 10, "is_ascend": True})),
              ("sort", [x], dict(kw={"is_ascend": False}, grad=(0,))),
              ("topk", [x], dict(kw={"k": 2, "ret_typ": "value"},
                                 grad=(0,)))]
    # sequences: time-major, and batch-major on axis 1
    seq = f(5, 3, 2)
    ln = onp.array([2, 5, 1], "float32")
    for name, kws in (("SequenceMask", ({"value": -1.0},
                                        {"value": 0.5, "axis": 1})),
                      ("SequenceLast", ({}, {"axis": 1})),
                      ("SequenceReverse", ({},))):
        for kw in kws:
            data = seq if kw.get("axis", 0) == 0 else seq.transpose(1, 0, 2)
            cases += [(name, [data], dict(kw=kw)),
                      (name, [data, ln], dict(kw=dict(
                          kw, use_sequence_length=True), grad=(0,)))]
    cases += [("sequence_mask", [seq, ln], dict(kw={
        "use_sequence_length": True})),
              ("sequence_last", [seq]), ("sequence_reverse", [seq])]
    # numpy-style additions and the rest
    cases += [
        ("cumsum", [x], dict(kw={"axis": 1}, grad=(0,))),
        ("cumsum", [i8]), ("cumsum", [(x > 0)]),
        ("cumprod", [pos], dict(kw={"axis": 0}, grad=(0,))),
        ("cumsum", [x], dict(kw={"dtype": "int32"})),
        ("trace", [x], dict(kw={"offset": 1}, grad=(0,))),
        ("trace", [u8]), ("kron", [f(2, 3), f(3, 2)], dict(grad=(0, 1))),
        ("bincount", [onp.array([0, 2, 2, 7, -1], "float32")]),
        ("bincount", [onp.array([0, 2, 2], "int32")],
         dict(kw={"minlength": 5})),
        ("bincount", [onp.array([1, 1, 3], "int32")],
         dict(kw={"weights": onp.array([0.5, 1.0, 2.0], "float32")})),
        ("boolean_mask", [x, onp.array([1, 0, 2, 0], "float32")], g),
        ("_contrib_boolean_mask", [x, onp.array([0, 1, 1, 0, 1, 0],
                                                "int32")],
         dict(kw={"axis": 1})),
        ("all_finite", [x]), ("all_finite", [xn]),
        ("multi_all_finite", [x, y]), ("multi_all_finite", [x, xn]),
        ("index_copy", [x, onp.array([2, 0, 2], "float32"), f(3, 6)],
         dict(grad=(0, 2))),
        ("index_array", [a3]), ("index_array", [a3],
                                dict(kw={"axes": (-1, 0)})),
        ("Embedding", [idx, f(6, 3)], dict(kw={"input_dim": 6,
                                               "output_dim": 3},
                                           grad=(1,))),
        ("embedding", [idx, f(6, 3)]),
    ]
    return cases


def test_tensor_ops_match_jax():
    """Every family of ``ops/tensor.py``: values, dtypes and ties equal to
    the reference's, and gradients where the ops are differentiable."""
    run_table(_tensor_cases())


# -- ops/nn.py and ops/vision.py --------------------------------------------------------
def _nn_vision_cases():
    rng = onp.random.RandomState(6)
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    img, x = f(2, 4, 5, 6), f(4, 7)
    lab = onp.array([1, 6, 0, 3], "float32")
    g = dict(grad=(0,))
    cases = [
        ("GroupNorm", [img, f(4), f(4)], dict(kw={"num_groups": 2},
                                              grad=(0, 1, 2))),
        ("InstanceNorm", [img, f(4), f(4)], dict(grad=(0, 1, 2))),
        ("RMSNorm", [x, f(7)], dict(grad=(0, 1))),
        ("rms_norm", [img, f(6)]),
        ("LRN", [img], dict(kw={"nsize": 3}, grad=(0,))),
        ("lrn", [img]),
        ("LayerNorm", [img, f(4), f(4)], dict(kw={"axis": 1}, grad=(0, 1))),
        ("LayerNorm", [x, f(7), f(7)], dict(kw={"output_mean_var": True})),
        ("layer_norm", [x, f(7), f(7)], g),
        ("FullyConnected", [img, f(3, 120), f(3)], dict(
            kw={"num_hidden": 3}, grad=(0, 1, 2))),
        ("fully_connected", [x, f(3, 7), f(3)], dict(kw={"no_bias": True})),
        ("gelu_tanh", [x], g), ("silu", [x], g), ("swish", [x]),
        ("log_softmax", [x], dict(kw={"temperature": 2.0}, grad=(0,))),
        ("softmin", [x], g),
        ("SoftmaxActivation", [img], g),
        ("SoftmaxActivation", [img], dict(kw={"mode": "channel"})),
        ("masked_softmax", [x, (x > 0).astype("float32")],
         dict(kw={"temperature": 0.5}, grad=(0,))),
        ("softmax", [img], dict(kw={"axis": 1}, grad=(0,))),
        ("softmax_cross_entropy", [x, lab], g),
        ("smooth_l1", [x * 2], dict(kw={"scalar": 2.0}, grad=(0,))),
        ("UpSampling", [img], dict(kw={"scale": 2}, grad=(0,))),
        ("UpSampling", [img], dict(kw={"scale": 3,
                                       "sample_type": "bilinear"},
                                   grad=(0,))),
        ("contrib_BilinearResize2D", [img], dict(kw={"height": 9,
                                                     "width": 11})),
        ("bilinear_resize_2d", [f(1, 2, 12, 10)],
         dict(kw={"height": 5, "width": 4}, grad=(0,))),
        ("contrib_BilinearResize2D", [img], dict(kw={"scale_height": 0.5,
                                                     "scale_width": 2.0})),
        ("im2col", [img], dict(kw={"kernel": (3, 2), "stride": (1, 2),
                                   "pad": (1, 1), "dilate": (2, 1)},
                               grad=(0,))),
        ("im2col", [f(2, 3, 9)], dict(kw={"kernel": (3,), "stride": (2,)})),
        ("col2im", [f(2, 36, 9)], dict(kw={"output_size": (5, 6),
                                            "kernel": (3, 3),
                                            "stride": (2, 2),
                                            "pad": (1, 1)}, grad=(0,))),
        ("Activation", [x], dict(kw={"act_type": "softsign"})),
        ("activation", [x], dict(kw={"act_type": "mish"})),
        ("Dropout", [x], dict(kw={"p": 0.5})),
    ]
    for act in ("leaky", "elu", "selu", "gelu", "rrelu"):
        cases.append(("LeakyReLU", [x], dict(kw={"act_type": act,
                                                 "slope": 0.1}, grad=(0,))))
    cases.append(("leaky_relu", [img], dict(kw={"act_type": "prelu",
                                                "gamma": f(4)})))
    for mode in ("instance", "channel", "spatial"):
        cases.append(("L2Normalization", [img], dict(kw={"mode": mode},
                                                     grad=(0,))))
    # output heads: their own gradients, the incoming one ignored
    lab2 = onp.array([[1, 2, 0], [2, -1, 1]], "float32")
    for kw in ({}, {"grad_scale": 2.0, "normalization": "batch"},
               {"use_ignore": True, "ignore_label": 3,
                "normalization": "valid"}, {"smooth_alpha": 0.1},
               {"out_grad": True}):
        cases.append(("SoftmaxOutput", [x, lab], dict(kw=kw, grad=(0,))))
    cases += [
        ("SoftmaxOutput", [f(2, 4, 3), lab2], dict(kw={
            "multi_output": True, "use_ignore": True}, grad=(0,))),
        ("softmax_output", [x, lab], g),
    ]
    reg_lab = f(4, 7)
    for name in ("LinearRegressionOutput", "LogisticRegressionOutput",
                 "MAERegressionOutput", "linear_regression_output",
                 "logistic_regression_output", "mae_regression_output"):
        cases.append((name, [x, reg_lab], dict(kw={"grad_scale": 3.0},
                                              grad=(0,))))
    for kw in ({}, {"use_linear": True, "margin": 0.5},
               {"regularization_coefficient": 2.0}):
        cases += [("SVMOutput", [x, lab], dict(kw=kw, grad=(0,))),
                  ("svm_output", [x, lab], dict(kw=kw))]
    # ops/vision.py
    theta = onp.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.2],
                       [1.2, 0.0, 0.3, 0.0, 0.8, 0.1]], "float32")
    flow = f(2, 2, 5, 6)
    grid = rng.uniform(-1.2, 1.2, (2, 2, 3, 4)).astype("float32")
    cases += [
        ("GridGenerator", [theta], dict(kw={"target_shape": (5, 6)},
                                        grad=(0,))),
        ("grid_generator", [flow], dict(kw={"transform_type": "warp"},
                                        grad=(0,))),
        ("BilinearSampler", [img, grid], dict(grad=(0, 1))),
        ("bilinear_sampler", [img, grid * 0.5]),
        ("SpatialTransformer", [img, theta], dict(kw={"target_shape": (4,
                                                                       3)},
                                                  grad=(0, 1))),
        ("spatial_transformer", [img, theta], dict(kw={"target_shape":
                                                       (6, 5)})),
        ("Correlation", [img, f(2, 4, 5, 6)], dict(kw={
            "max_displacement": 2, "pad_size": 2}, grad=(0, 1))),
        ("correlation", [f(1, 3, 9, 8), f(1, 3, 9, 8)], dict(kw={
            "kernel_size": 3, "max_displacement": 2, "stride1": 2,
            "stride2": 2, "pad_size": 3, "is_multiply": False},
            grad=(0, 1))),
        ("Crop", [img], dict(kw={"h_w": (3, 4), "offset": (1, 2)})),
        ("Crop", [img], dict(kw={"h_w": (3, 3), "center_crop": True},
                             grad=(0,))),
        ("crop_like", [img, f(1, 1, 2, 5)]),
        ("batch_take", [x, onp.array([0, -1, 7, 3], "float32")]),
        ("batch_take", [x, lab], g),
    ]
    for kw in ({}, {"grad_scale": 2.0, "normalization": "batch"},
               {"normalization": "valid", "valid_thresh": 0.3}):
        cases += [("MakeLoss", [x], dict(kw=kw, grad=(0,))),
                  ("make_loss", [x], dict(kw=kw, grad=(0,)))]
    return cases


def test_nn_and_vision_ops_match_jax():
    """The rest of ``ops/nn.py`` and all of ``ops/vision.py``: values and
    gradients, the output heads' own gradients included."""
    run_table(_nn_vision_cases())


# -- the reference's own op tests, and AMP ----------------------------------------------
#: tests of the JAX package's ``tests/test_operator.py`` and
#: ``tests/test_ndarray.py`` that run unchanged on the port (with ``mx``,
#: ``nd`` and ``default_context`` swapped for the port's). Not taken:
#: ``test_getitem_is_copy`` (the port's basic indexing returns views, as
#: upstream MXNet), ``test_create_graph_*`` (they import the JAX package's
#: ``autograd`` themselves; ``tests/test_torch_gluon_extra.py`` holds the
#: port's against it),
#: ``test_multi_output_ops_record_safe`` (records with the JAX autograd),
#: ``test_im2col_col2im`` (the declarative schemas: string shapes and the
#: refusal of unknown keywords), ``test_numeric_gradient_sweep`` (the JAX
#: ``check_numeric_gradient``; the gradients are held above) and
#: ``test_save_load`` (``tests/test_torch_ndarray.py``).
REFERENCE_TESTS = {
    "test_operator.py": (
        "test_unary_ops", "test_activation_ops", "test_reductions",
        "test_argmax_argmin", "test_dot", "test_batch_dot",
        "test_take_pick_gather", "test_one_hot_embedding",
        "test_rnn_op_shapes",
        "test_embedding_onehot_grad_matches_scatter", "test_softmax_family",
        "test_topk_sort", "test_elementwise_broadcast_binary",
        "test_where_clip", "test_convolution_shapes_and_numerics",
        "test_pooling", "test_fully_connected", "test_batchnorm_layernorm",
        "test_sequence_ops", "test_dropout_modes", "test_linalg_ops",
        "test_pad_tile_repeat_flip", "test_scalar_ops_on_int",
        "test_grid_generator_identity_affine",
        "test_bilinear_sampler_identity",
        "test_spatial_transformer_translation",
        "test_correlation_reference_geometry_and_values",
        "test_make_loss_valid_normalization_and_dtype",
        "test_crop_center_and_like", "test_batch_take",
        "test_make_loss_gradient_semantics", "test_lrn_matches_manual",
        "test_regression_output_heads", "test_svm_output_hinge_gradients",
        "test_np_compat_additions", "test_tril_triu_trmm",
        "test_softmax_activation_modes", "test_all_finite",
        "test_boolean_mask_eager_only", "test_index_copy_contrib",
        "test_index_array_contrib", "test_index_copy_rejects_out_of_range",
        "test_index_array_validates_axes",
        "test_index_copy_duplicate_indices_last_wins",
        "test_index_copy_rejects_shape_mismatch"),
    "test_ndarray.py": (
        "test_creation_dtypes", "test_context_placement",
        "test_basic_arithmetic", "test_broadcast_arithmetic",
        "test_comparison_ops", "test_inplace_mutation",
        "test_setitem_getitem", "test_reshape_magic_codes",
        "test_shape_ops", "test_copy_semantics", "test_scalar_conversion",
        "test_wait_to_read_and_waitall", "test_concat_split_stack",
        "test_dtype_cast", "test_numpy_interop", "test_mixed_scalar_types",
        "test_iter_len", "test_random_sampling_surface",
        "test_sample_multinomial_logp_gradient_flows",
        "test_sample_multinomial_multi_draw_shapes_and_grads",
        "test_np_namespace_tail"),
}


def _reference_module(fname):
    """A private copy of a JAX test module whose ``mx``, ``nd`` and
    ``default_context`` are the port's."""
    path = __file__.rsplit("/", 1)[0] + "/" + fname
    spec = importlib.util.spec_from_file_location(
        "_port_run_of_" + fname[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.mx, mod.nd = mx, nd
    mod.default_context = lambda: mx.cpu()
    return mod


def test_reference_op_tests_and_amp_on_the_port():
    """The JAX package's op tests listed above pass on the port; and
    ``amp.init("bfloat16")`` casts the inputs of ``batch_dot`` and
    ``linalg_gemm2`` (FP16_FP32_FUNCS) and leaves ``GroupNorm``,
    ``norm``, ``prod`` and ``SoftmaxOutput`` (FP32_FUNCS) in float32, as
    in the JAX package."""
    failed = []
    for fname, names in REFERENCE_TESTS.items():
        mod = _reference_module(fname)
        for name in names:
            fn = getattr(mod, name)
            assert not inspect.signature(fn).parameters, name
            try:
                fn()
            except Exception as e:  # noqa: BLE001  (reported below)
                failed.append(f"{fname}::{name}: {type(e).__name__}: {e}")
    assert not failed, "\n".join(failed)

    rng = onp.random.RandomState(7)
    a, b = rng.randn(2, 3, 4).astype("float32"), rng.randn(2, 4, 5).astype(
        "float32")
    img = rng.randn(2, 4, 3, 3).astype("float32")
    gb = [rng.randn(4).astype("float32") for _ in range(2)]
    lab = onp.array([1, 0], "float32")
    calls = [("batch_dot", (a, b), {}), ("linalg_gemm2", (a, b), {}),
             ("GroupNorm", (img,) + tuple(gb), {"num_groups": 2}),
             ("norm", (img,), {"axis": 1}), ("prod", (img,), {"axis": 1}),
             ("SoftmaxOutput", (img.reshape(2, -1), lab), {}),
             ("dot", (a[0], b[0]), {})]
    amp.init("bfloat16")
    jamp.init("bfloat16")
    try:
        for name, args, kw in calls:
            got = getattr(nd, name)(*[nd.array(v) for v in args], **kw)
            want = getattr(jmx.nd, name)(*[jmx.nd.array(v) for v in args],
                                         **kw)
            assert str(got.dtype) == str(want.dtype), (name, got.dtype,
                                                       want.dtype)
            w = want.astype("float32").asnumpy()
            onp.testing.assert_allclose(got.astype("float32").asnumpy(), w,
                                        rtol=2e-2, atol=2e-2 * max(
                                            onp.abs(w).max(), 1.0),
                                        err_msg=name)
    finally:
        amp.reset()
        jamp.reset()
    assert str(nd.batch_dot(nd.array(a), nd.array(b)).dtype) == "float32"
