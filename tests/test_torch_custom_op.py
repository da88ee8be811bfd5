"""PyTorch port: ``mx.operator`` and the ``Custom`` op held against the JAX
package on the CPU (the cases of ``tests/test_custom_op.py``).

The same user ops are registered in both packages. Each package runs them
eagerly and under ``autograd.record`` on the same seeded inputs: outputs
and input gradients agree within 1e-6 of the largest value, and the
finite-difference check of the float64 ``host_softsign`` passes (rtol 1e-4, as the JAX test). Beyond the JAX
package, the port honours ``req`` (``"null"`` for an input that takes no
gradient), ``need_top_grad=False`` with MXNet's default
``declare_backward_dependency`` (the backward gets no output gradient),
and one op instance per call (two forwards before their backwards keep
their own state). ``mx.sym.Custom`` infers its shapes through the prop,
serialises to the JAX JSON byte for byte and binds to an Executor whose
forward and backward equal the JAX Executor's. A hybridized block holding
a ``Custom`` op runs eagerly and captures nothing (``cache_info``), and
three Adam steps of it give the JAX block's losses and weights (1e-5).
"""
import functools

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx

TOL = 1e-6


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


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else onp.asarray(a)


def _close(got, want, tol=TOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(onp.abs(w).max()) if w.size else 0.0, 1.0)
    onp.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


def _register(lib):
    """The JAX test's ops, registered in ``lib``."""
    op, nd = lib.operator, lib.nd

    @op.register("parity_scaled_square")
    class ScaledSquareProp(op.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, shapes, dtypes):
            scale = self.scale

            class _Op(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0], nd.array(scale * x * x))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    x, g = in_data[0].asnumpy(), out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                nd.array(2.0 * scale * x * g))

            return _Op()

    @op.register("parity_host_softsign")
    class HostSoftsignProp(op.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class _Op(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0],
                                nd.array(x / (1 + onp.abs(x)), dtype=x.dtype))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    x, g = in_data[0].asnumpy(), out_grad[0].asnumpy()
                    self.assign(in_grad[0], req[0],
                                nd.array(g / (1 + onp.abs(x)) ** 2,
                                         dtype=x.dtype))

            return _Op()

    @op.register("parity_split_pm")
    class SplitProp(op.CustomOpProp):
        def list_outputs(self):
            return ["plus", "minus"]

        def create_operator(self, ctx, shapes, dtypes):
            class _Op(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.assign(out_data[0], req[0], nd.array(x + 1))
                    self.assign(out_data[1], req[1], nd.array(x - 1))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] - out_grad[1] * 2.0)

            return _Op()

    @op.register("parity_host_mul")
    class HostMulProp(op.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def create_operator(self, ctx, shapes, dtypes):
            class _Op(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[1])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * in_data[1])
                    self.assign(in_grad[1], req[1], out_grad[0] * in_data[0])

            return _Op()


_register(mx)
_register(jmx)


def _run(lib, case, seed=0):
    """Outputs and input gradients of one op call under ``record``."""
    nd, autograd = lib.nd, lib.autograd
    rng = onp.random.RandomState(seed)
    if case == "parity_host_softsign":
        vals = [rng.randn(5) * 2]
        kw = {}
    elif case == "parity_host_mul":
        vals = [rng.randn(2, 3).astype("float32") for _ in range(2)]
        kw = {}
    else:
        vals = [rng.randn(3, 4).astype("float32")]
        kw = {"scale": 3.0} if case == "parity_scaled_square" else {}
    xs = [nd.array(v, dtype=v.dtype) for v in vals]
    eager = nd.Custom(*xs, op_type=case, **kw)
    for x in xs:
        x.attach_grad()
    with autograd.record():
        out = nd.Custom(*xs, op_type=case, **kw)
        outs = out if isinstance(out, (list, tuple)) else [out]
        loss = sum((o * (i + 1.0)).sum() for i, o in enumerate(outs))
    loss.backward()
    eager = eager if isinstance(eager, (list, tuple)) else [eager]
    return [_np(e) for e in eager] + [_np(o) for o in outs] + \
        [_np(x.grad) for x in xs]


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    return _run(jmx, case)


@pytest.mark.parametrize("case", ["parity_scaled_square",
                                  "parity_host_softsign", "parity_split_pm",
                                  "parity_host_mul"])
def test_custom_nd_forward_backward_match_jax(case):
    got, want = _run(mx, case), _jax_run(case)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if case != "parity_host_softsign":
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
        _close(g, w)
    if case == "parity_host_softsign":
        xv = onp.random.RandomState(0).randn(5) * 2
        eps = 1e-6
        num = ((xv + eps) / (1 + abs(xv + eps))
               - (xv - eps) / (1 + abs(xv - eps))) / (2 * eps)
        onp.testing.assert_allclose(got[-1], num, rtol=1e-4)


def test_custom_req_need_top_grad_and_one_instance_a_call():
    seen = {}

    @mx.operator.register("stateful_gate")
    class StatefulProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    self.mask = (x > 0).astype(x.dtype)
                    self.assign(out_data[0], req[0],
                                mx.nd.array(x * self.mask))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                mx.nd.array(out_grad[0].asnumpy()
                                            * self.mask))

            return _Op()

    @mx.operator.register("loss_like")
    class LossProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def create_operator(self, ctx, shapes, dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * 1.0)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    seen["req"], seen["out_grad"] = list(req), out_grad
                    self.assign(in_grad[0], req[0],
                                out_data[0] - in_data[1])
                    self.assign(in_grad[1], req[1], in_data[1] * 100.0)

            return _Op()

    a = onp.array([[1.0, -2.0, 3.0]], "float32")
    b = onp.array([[-1.0, 2.0, -3.0]], "float32")
    xa, xb = mx.nd.array(a), mx.nd.array(b)
    xa.attach_grad()
    xb.attach_grad()
    with mx.autograd.record():
        ya = mx.nd.Custom(xa, op_type="stateful_gate")
        yb = mx.nd.Custom(xb, op_type="stateful_gate")   # before a backward
        (ya.sum() + yb.sum()).backward()
    onp.testing.assert_array_equal(_np(xa.grad), (a > 0).astype("float32"))
    onp.testing.assert_array_equal(_np(xb.grad), (b > 0).astype("float32"))

    data, label = mx.nd.array(a), mx.nd.array(b)
    data.attach_grad()                    # label takes no gradient
    with mx.autograd.record():
        out = mx.nd.Custom(data, label, op_type="loss_like")
        (out * 5.0).sum().backward()
    assert seen["req"] == ["write", "null"]
    assert seen["out_grad"] == [None]      # need_top_grad=False
    onp.testing.assert_array_equal(_np(data.grad), a - b)


def _sym_case(lib):
    with lib.name.NameManager():
        x = lib.sym.Variable("x")
        y = lib.sym.Custom(x, op_type="parity_scaled_square", scale=2.0,
                           name="sq")
        return lib.sym.sum(y * x, name="loss")


@functools.lru_cache(maxsize=None)
def _jax_sym(seed=1):
    xv = onp.random.RandomState(seed).randn(3, 4).astype("float32")
    sym = _sym_case(jmx)
    g = jmx.nd.zeros(xv.shape)
    ex = sym.bind(jmx.cpu(), {"x": jmx.nd.array(xv)}, args_grad={"x": g})
    out = ex.forward(is_train=True)[0]
    ex.backward()
    return (xv, sym.tojson(), sym.infer_shape(x=xv.shape), _np(out),
            _np(g))


def test_custom_sym_infer_shape_json_and_executor():
    xv, j_json, j_shapes, j_out, j_grad = _jax_sym()
    sym = _sym_case(mx)
    assert sym.tojson() == j_json
    assert sym.infer_shape(x=xv.shape) == j_shapes
    g = mx.nd.zeros(xv.shape)
    ex = sym.bind(mx.cpu(), {"x": mx.nd.array(xv)}, args_grad={"x": g})
    _close(ex.forward(is_train=True)[0], j_out)
    ex.backward()
    _close(g, j_grad)
    _close(mx.sym.load_json(j_json).eval(x=mx.nd.array(xv))[0], j_out)
    with pytest.raises(KeyError, match="no CustomOp registered as 'nope'"):
        mx.nd.Custom(mx.nd.ones((2, 2)), op_type="nope")


def _custom_dense(lib):
    class CustomDense(lib.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = lib.gluon.nn.Dense(4, in_units=8, flatten=False)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="parity_scaled_square",
                            scale=0.5)
    return CustomDense()


def _train(lib, weights, X, Y, steps=3):
    net = _custom_dense(lib)
    net.initialize()
    for (_, p), w in zip(sorted(net.collect_params().items()), weights):
        p.set_data(lib.nd.array(w))
    net.hybridize()
    trainer = lib.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.05})
    l2 = lib.gluon.loss.L2Loss()
    x, y = lib.nd.array(X), lib.nd.array(Y)
    losses = []
    for _ in range(steps):
        with lib.autograd.record():
            loss = l2(net(x), y).mean()
        loss.backward()
        trainer.step(16)
        losses.append(float(_np(loss)))
    return net, losses, [_np(p.data()) for _, p in
                         sorted(net.collect_params().items())]


@functools.lru_cache(maxsize=None)
def _jax_train():
    rng = onp.random.RandomState(0)
    weights = [rng.randn(4).astype("float32") * 0.1,
               rng.randn(4, 8).astype("float32") * 0.3]
    X = rng.randn(16, 8).astype("float32")
    Y = onp.abs(rng.randn(16, 4)).astype("float32")
    _, losses, after = _train(jmx, weights, X, Y)
    return weights, X, Y, losses, after


def test_custom_in_hybridized_block_trains_like_jax():
    weights, X, Y, j_losses, j_after = _jax_train()
    net, losses, after = _train(mx, weights, X, Y)
    onp.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for g, w in zip(after, j_after):
        _close(g, w, 1e-5)
    info = net.cache_info()
    assert info["eager_host_op"] and info["host_op_calls"] == 3
    assert info["captured"] == 0 and info["signatures"] == 0
