"""PyTorch port: ``mx.subgraph``, ``Symbol.optimize_for`` and
``HybridBlock.optimize_for``, held against the JAX package on the CPU: the
port of JAX ``tests/test_subgraph.py`` and of
``tests/test_quantization.py:192-213``, its cases merged where they repeat.

- A partitioned graph's JSON is the JAX package's byte for byte (graphs
  built under a fresh ``NameManager`` in each package, so auto-names do
  not depend on what the process built before; the fused
  ``_sg_dense_act`` node, the opaque ``_subgraph_exec`` node and its
  ``sub`` payload, a region left alone when an interior output escapes),
  loads in either package and evaluates to the unpartitioned graph's
  values.
- Third-party properties (the default rewrite, a custom one with a veto)
  register without editing the package.
- The Gluon side: a property backend installs the partitioned graph as the
  hybridized block's compute (and trains through it), ``hybridize(False)``
  and ``backend=None`` revert it, a training-dependent child is refused;
  the ``INT8`` block-rewrite backend quantizes as the JAX one does and
  clears an earlier partitioning.

Tolerances: float32 values within 1e-6 relative of the same package's
unpartitioned graph (the same operations) and within 1e-5 of the JAX
package's; int8 outputs within one int8 step of the JAX package's, as in
``tests/test_torch_quantization.py``.
"""
import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops.registry import OPS
from test_torch_artifact_common import (  # noqa: F401  (fixtures)
    on_cpu, one_torch_thread, scratch_dir,
)
from test_torch_quantization import _compare_quantized

ATOL = 1e-5


def _ops_in(sym):
    from incubator_mxnet_tpu_torch import symbol as S
    return [n._op for n in S._topo(sym) if n._op is not None]


def _dense_act(pkg, num_hidden=8, act="tanh"):
    S = pkg.sym
    x = S.Variable("x")
    return S.Activation(S.FullyConnected(x, num_hidden=num_hidden,
                                         name="fc"), act_type=act)


def _values(seed, n=4, d=3, h=8):
    rng = onp.random.RandomState(seed)
    return {"x": rng.randn(n, d).astype("float32"),
            "fc_weight": rng.randn(h, d).astype("float32"),
            "fc_bias": rng.randn(h).astype("float32")}


def _eval(sym, vals, pkg=mx):
    arrays = {k: pkg.nd.array(v) for k, v in vals.items()}
    return sym.eval(**arrays)[0].asnumpy()


def test_dense_act_partition_matches_jax():
    """``FullyConnected -> Activation`` becomes one ``_sg_dense_act`` node:
    the JSON is the JAX one's, the values the unfused graph's; an interior
    output with a second consumer keeps the chain unfused, as in JAX."""
    with mx.name.NameManager(), jmx.name.NameManager():
        y, jy = _dense_act(mx), _dense_act(jmx)
    part, jpart = y.optimize_for("DENSE_ACT"), jy.optimize_for("DENSE_ACT")
    assert part.tojson() == jpart.tojson()
    assert "_sg_dense_act" in _ops_in(part)
    assert "FullyConnected" not in _ops_in(part)
    vals = _values(0)
    out = _eval(part, vals)
    onp.testing.assert_allclose(out, _eval(y, vals), rtol=1e-6)
    onp.testing.assert_allclose(out, _eval(jpart, vals, jmx), atol=ATOL)
    escaped = []
    for pkg in (mx, jmx):
        with pkg.name.NameManager():
            S = pkg.sym
            fc = S.FullyConnected(S.Variable("x"), num_hidden=4, name="fc")
            escaped.append((S.Activation(fc, act_type="relu") + fc
                            ).optimize_for("DENSE_ACT"))
    assert escaped[0].tojson() == escaped[1].tojson()
    assert "_sg_dense_act" not in _ops_in(escaped[0])


def test_dense_act_partitioned_executor_backward():
    """The gradients of ``sum(partitioned)`` through an Executor equal the
    unpartitioned graph's and the JAX partitioned graph's."""
    vals = _values(1, n=5, h=4)

    def grads(pkg, sym):
        args = {k: pkg.nd.array(v) for k, v in vals.items()}
        gargs = {k: pkg.nd.zeros(v.shape) for k, v in vals.items()}
        ex = sym.bind(pkg.cpu(), args, args_grad=gargs)
        ex.forward(is_train=True)
        ex.backward()
        return {k: g.asnumpy() for k, g in gargs.items()}

    got = {}
    for pkg in (mx, jmx):
        y = _dense_act(pkg, num_hidden=4, act="relu")
        got[pkg] = (grads(pkg, pkg.sym.sum(y.optimize_for("DENSE_ACT"))),
                    grads(pkg, pkg.sym.sum(y)))
    (g_part, g_ref), (j_part, _) = got[mx], got[jmx]
    for k in vals:
        onp.testing.assert_allclose(g_part[k], g_ref[k], rtol=1e-5,
                                    err_msg=k)
        onp.testing.assert_allclose(g_part[k], j_part[k], atol=ATOL,
                                    err_msg=k)


def test_external_backends_match_jax():
    """A third-party property with the default rewrite wraps its region in
    ``_subgraph_exec`` (JSON the JAX one's; it reloads and evaluates); a
    custom rewrite collapses ``x * 2 * 3`` to one node and vetoes the
    product 1."""
    calls = {mx: [], jmx: []}
    for pkg in (mx, jmx):
        @pkg.subgraph.register_property("TOY_ADD_RELU")
        class FuseAddRelu(pkg.subgraph.SubgraphProperty):
            op_names = ("broadcast_add", "Activation")

        def rewrite(self, region, inputs, externs, pkg=pkg):
            s = float(region[0]._attrs["scalar"]) * \
                float(region[1]._attrs["scalar"])
            calls[pkg].append(s)
            if s == 1.0:
                return None
            return pkg.sym.Symbol("_mul_scalar", list(inputs),
                                  attrs={"scalar": s, "_scalar_rhs": True})

        pkg.subgraph.register_property("TOY_SCALE", type(
            "CollapseDoubleScale", (pkg.subgraph.SubgraphProperty,),
            {"op_names": ("_mul_scalar", "_mul_scalar"),
             "rewrite": rewrite}))
    try:
        parts = []
        for pkg in (mx, jmx):
            with pkg.name.NameManager():
                S = pkg.sym
                a, b = S.Variable("a"), S.Variable("b")
                y = S.Activation(a + b, act_type="relu")
            parts.append((y, y.optimize_for("TOY_ADD_RELU")))
        (y, part), (_, jpart) = parts
        assert part.tojson() == jpart.tojson()
        assert "_subgraph_exec" in _ops_in(part)
        assert "broadcast_add" not in _ops_in(part)
        rng = onp.random.RandomState(2)
        vals = {"a": rng.randn(3, 4).astype("float32"),
                "b": rng.randn(3, 4).astype("float32")}
        out = _eval(part, vals)
        onp.testing.assert_allclose(out, _eval(y, vals), rtol=1e-6)
        back = mx.sym.load_json(part.tojson())
        onp.testing.assert_allclose(_eval(back, vals), out, rtol=1e-6)
        for pkg in (mx, jmx):
            x = pkg.sym.Variable("x")
            part = ((x * 2.0) * 3.0).optimize_for("TOY_SCALE")
            vetoed = ((x * 4.0) * 0.25).optimize_for("TOY_SCALE")
            assert [n._op for n in pkg.sym._topo(part)].count(
                "_mul_scalar") == 1
            assert [n._op for n in pkg.sym._topo(vetoed)].count(
                "_mul_scalar") == 2
            onp.testing.assert_allclose(
                _eval(part, {"x": onp.ones((2, 2), "float32")}, pkg),
                6.0 * onp.ones((2, 2)))
        assert calls[mx] == calls[jmx] and 1.0 in calls[mx]
    finally:
        for pkg in (mx, jmx):
            for name in ("TOY_ADD_RELU", "TOY_SCALE"):
                pkg.subgraph._BACKENDS.pop(name, None)


def test_partitioned_json_crosses_packages():
    """A partitioned graph saved by either package loads in the other and
    evaluates to the same values; the partitioner's ops live in the one
    op registry (``mx.nd`` reflects them), registered with every other
    op, so a saved graph needs no ``mx.subgraph`` import to run."""
    root = scratch_dir()
    vals = _values(5, n=2, h=4)
    for src, dst in ((mx, jmx), (jmx, mx)):
        part = _dense_act(src, num_hidden=4, act="relu").optimize_for(
            "DENSE_ACT")
        part.save(f"{root}/part.json")
        back = dst.sym.load(f"{root}/part.json")
        assert back.tojson() == part.tojson()
        onp.testing.assert_allclose(_eval(back, vals, dst),
                                    _eval(part, vals, src), atol=ATOL)
    assert OPS["_sg_dense_act"].module.endswith("ops.subgraph_ops")
    assert OPS["_subgraph_exec"].module.endswith("ops.subgraph_ops")
    x = onp.random.RandomState(6).randn(2, 3).astype("float32")
    w = onp.random.RandomState(7).randn(4, 3).astype("float32")
    onp.testing.assert_allclose(
        nd._sg_dense_act(nd.array(x), nd.array(w), None, no_bias=True,
                         act_type="relu").asnumpy(),
        onp.maximum(x @ w.T, 0), rtol=1e-6)


def test_unknown_and_invalid_backends_raise():
    """An unknown backend name (symbol and Gluon) and a non-backend given
    to ``partition`` raise as in the JAX package."""
    x = mx.sym.Variable("x")
    with pytest.raises(MXNetError, match="unknown subgraph backend"):
        (x + 1.0).optimize_for("NOPE_BACKEND")
    with pytest.raises(MXNetError, match="backend name or SubgraphBackend"):
        mx.subgraph.partition(x + 1.0, None)
    net = gluon.nn.Dense(4, in_units=3)
    net.initialize()
    with pytest.raises(MXNetError, match="unknown subgraph backend"):
        net.optimize_for(nd.ones((1, 3)), backend="TensorRT")


def _mlp_pair(pkg, dropout=False):
    """Dense(8, relu) -> [Dropout] -> Dense(3) with deferred input units
    (the port's initialised)."""
    net = pkg.gluon.nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu"))
        if dropout:
            net.add(pkg.gluon.nn.Dropout(0.5))
        net.add(pkg.gluon.nn.Dense(3))
    if pkg is mx:
        net.initialize()
    return net


def test_gluon_optimize_for_property_backend_matches_jax():
    """``optimize_for(x, backend="DENSE_ACT")`` traces the block, installs
    the partitioned graph (two ``_sg_dense_act``-or-FC nodes as in JAX)
    and returns the unpartitioned output; later hybridized calls run the
    graph; options are refused; ``hybridize(False)`` and ``backend=None``
    revert; a Dropout child is refused."""
    root = scratch_dir()
    x = onp.random.RandomState(3).randn(4, 5).astype("float32")
    net = _mlp_pair(mx)
    ref = net(nd.array(x)).asnumpy()
    net.save_parameters(f"{root}/m.params")
    jnet = _mlp_pair(jmx)
    jnet.load_parameters(f"{root}/m.params")
    out = net.optimize_for(nd.array(x), backend="DENSE_ACT")
    jout = jnet.optimize_for(jnd.array(x), backend="DENSE_ACT")
    onp.testing.assert_allclose(out.asnumpy(), ref, rtol=1e-5)
    onp.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), atol=ATOL)
    part, names = net._sg_graph
    assert names == jnet._sg_graph[1] == ["data0"]
    assert _ops_in(part) == [n._op for n in jmx.sym._topo(jnet._sg_graph[0])
                             if n._op is not None]
    assert "_sg_dense_act" in _ops_in(part)
    onp.testing.assert_allclose(net(nd.array(x)).asnumpy(), ref, rtol=1e-5)
    with pytest.raises(MXNetError, match="takes no options"):
        net.optimize_for(nd.array(x), backend="DENSE_ACT", calib_data=[x])
    net.hybridize(False)
    onp.testing.assert_allclose(net(nd.array(x)).asnumpy(), ref, rtol=1e-6)
    net.optimize_for(nd.array(x), backend=None)
    assert net._sg_graph is None
    onp.testing.assert_allclose(net(nd.array(x)).asnumpy(), ref, rtol=1e-6)
    with pytest.raises(MXNetError, match="Dropout"):
        _mlp_pair(mx, dropout=True).optimize_for(
            nd.ones((2, 3)), backend="DENSE_ACT")


def test_gluon_partitioned_training_step():
    """25 SGD steps through the partitioned graph: the gradients reach the
    parameters (losses equal the unpartitioned twin's within 1e-5 and fall
    below 0.7 of the first), as the JAX test's convergence check asks."""
    rng = onp.random.RandomState(4)
    x = nd.array(rng.randn(16, 4).astype("float32"))
    yt = nd.array(rng.randn(16, 1).astype("float32"))
    losses = []
    for partitioned in (True, False):
        mx.random.seed(11)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(8, activation="relu"), gluon.nn.Dense(1))
        net.initialize()
        net(x)
        if partitioned:
            net.optimize_for(x, backend="DENSE_ACT")
            assert net._sg_graph is not None
        loss_fn = gluon.loss.L2Loss()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        run = []
        for _ in range(25):
            with autograd.record():
                l = loss_fn(net(x), yt)
            l.backward()
            trainer.step(16)
            run.append(float(l.mean().asnumpy()))
        losses.append(run)
    onp.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    assert losses[0][-1] < losses[0][0] * 0.7, losses[0][::8]


def _lenet(pkg):
    """JAX ``tests/test_quantization.py:101``, under a fixed prefix."""
    net = pkg.gluon.nn.HybridSequential(prefix="q_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(8, kernel_size=3, padding=1,
                                    activation="relu", in_channels=1))
        net.add(pkg.gluon.nn.MaxPool2D(pool_size=2, strides=2))
        net.add(pkg.gluon.nn.Flatten())
        net.add(pkg.gluon.nn.Dense(32, activation="relu", in_units=288))
        net.add(pkg.gluon.nn.Dense(10, in_units=32))
    return net


def test_optimize_for_int8_matches_jax():
    """``optimize_for(x, backend="INT8", calib_data=[x])`` swaps in the
    quantized layers as the JAX backend does (the same layers, int8
    weights and ranges; outputs within one int8 step of the JAX ones and
    within 10% of the float net, JAX ``test_quantization.py:192``), and
    clears an earlier property-backend partitioning."""
    root = scratch_dir()
    rng = onp.random.RandomState(9)
    x = rng.randn(2, 1, 12, 12).astype("float32")
    mx.random.seed(44)
    net = _lenet(mx)
    net.initialize()
    want = net(nd.array(x)).asnumpy()
    net.save_parameters(f"{root}/q.params")
    jnet = _lenet(jmx)
    jnet.load_parameters(f"{root}/q.params")
    net.optimize_for(nd.array(x), backend="DENSE_ACT")
    assert net._sg_graph is not None
    out = net.optimize_for(nd.array(x), backend="INT8",
                           calib_data=[nd.array(x)], calib_mode="naive")
    jnet.optimize_for(jnd.array(x), backend="INT8",
                      calib_data=[jnd.array(x)], calib_mode="naive")
    assert net._sg_graph is None
    from incubator_mxnet_tpu_torch.quantization import _QuantizedLayerBase
    assert any(isinstance(c, _QuantizedLayerBase)
               for c in net._children.values())
    err = onp.abs(out.asnumpy() - want).mean() / (onp.abs(want).mean()
                                                  + 1e-6)
    assert err < 0.10, err
    _compare_quantized(jnet, net, [x], "INT8 backend", 16)
