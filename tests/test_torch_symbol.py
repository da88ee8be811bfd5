"""PyTorch port: ``mx.sym`` held against the JAX package on the CPU.

- ``list_arguments`` and ``infer_shape`` of ``mlp_symbol`` and
  ``lenet_symbol`` (the port walks meta tensors, the JAX package
  ``jax.eval_shape``) are the JAX package's.
- ``tojson`` of the same graphs, of scalar and comparison ops, a ``Group``
  and ``AttrScope`` attributes are equal strings; a JAX-written JSON loads
  in the port and a port-written one in the JAX package, with equal
  ``infer_shape`` and equal JSON again.
- ``eval`` of ``Group``, scalar ops, comparisons, ``zeros``/``ones`` and
  ``get_internals`` outputs equals the JAX ``eval``; the source ops behind
  ``zeros``/``ones`` are ``ops/tensor.py``'s, as in the JAX package, and
  through ``mx.nd`` make an NDArray on the asked or the current context.
- ``Executor.forward``/``backward`` of a LeNet with a BatchNorm with
  ``grad_req="write"`` and ``"add"`` (and given ``out_grads``): outputs and
  every gradient within 1e-5 of the JAX Executor's on the same arguments
  (of each tensor's largest magnitude, at least 1: the convolutions' bias
  gradients sum 576 positions to ~17, where float32 sums in another order
  differ by ~1e-5).
- ``AttrScope`` and ``name.Prefix`` under the JAX test's cases
  (``tests/test_symbol_module.py:136-168``), and ``print_summary``'s table
  and total.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.models import lenet as jlenet
from incubator_mxnet_tpu import visualization as jviz
from incubator_mxnet_tpu.ops.registry import OPS as jOPS

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import models, visualization
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops.registry import OPS

ATOL = 1e-5
SHAPES = {"mlp": dict(data=(8, 1, 28, 28), softmax_label=(8,)),
          "lenet": dict(data=(4, 1, 28, 28), softmax_label=(4,))}


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
    mx.random.seed(0)
    with mx.cpu():
        yield


def _build(lib, network):
    m = jlenet if lib is jmx else models
    return m.mlp_symbol() if network == "mlp" else m.lenet_symbol()


def _close(a, b, atol=ATOL):
    """Within ``atol`` of the reference's largest magnitude (at least 1)."""
    b = onp.asarray(b)
    scale = max(1.0, float(onp.abs(b).max())) if b.size else 1.0
    onp.testing.assert_allclose(onp.asarray(a), b, rtol=0, atol=atol * scale)


@pytest.mark.parametrize("network", ["mlp", "lenet"])
def test_arguments_and_infer_shape_match_jax(network):
    j, p = _build(jmx, network), _build(mx, network)
    assert p.list_arguments() == j.list_arguments()
    assert p.list_outputs() == j.list_outputs()
    assert p.list_auxiliary_states() == j.list_auxiliary_states()
    assert p.infer_shape(**SHAPES[network]) == \
        j.infer_shape(**SHAPES[network])
    assert p.infer_type(**SHAPES[network]) == \
        j.infer_type(**SHAPES[network])
    ji, pi = j.get_internals(), p.get_internals()
    assert pi.list_outputs() == ji.list_outputs()
    k = ji.list_outputs().index("fc1_output")
    assert pi[k].infer_shape(**SHAPES[network]) == \
        ji[k].infer_shape(**SHAPES[network])


def _graphs(lib):
    """The graphs whose JSON must cross: the MLP and LeNet symbols, scalar
    and comparison ops with a Group, and AttrScope attributes on variables
    and ops; auto-names drawn in a fresh NameManager."""
    with lib.name.NameManager():
        a, b = lib.sym.Variable("a"), lib.sym.Variable("b", shape=(2, 3))
        arith = lib.sym.Group([(a * 2.0 + b) / 4.0 - a, -b, a < 0.5,
                               a >= b, lib.sym.broadcast_maximum(a, b)])
        with lib.AttrScope(ctx_group="dev1", lr_mult="0.1"):
            w = lib.sym.Variable("w")
            fc = lib.sym.FullyConnected(a, w, num_hidden=4, no_bias=True)
        return {"mlp": _build(lib, "mlp"), "lenet": _build(lib, "lenet"),
                "arith": arith, "scoped": lib.sym.Activation(
                    fc, act_type="tanh")}


def test_json_crosses_both_ways():
    jg, pg = _graphs(jmx), _graphs(mx)
    for name in jg:
        js, ps = jg[name].tojson(), pg[name].tojson()
        assert ps == js, name
        from_jax, from_port = mx.sym.load_json(js), jmx.sym.load_json(ps)
        assert from_jax.tojson() == js and from_port.tojson() == ps
        if name in SHAPES:
            assert from_jax.infer_shape(**SHAPES[name]) == \
                from_port.infer_shape(**SHAPES[name])
    # loading inside a scope stamps nothing; the scope's attrs survive
    with mx.AttrScope(ctx_group="dev9"):
        clean = mx.sym.load_json(jg["mlp"].tojson())
    assert clean.attr("ctx_group") is None
    fc = mx.sym.load_json(jg["scoped"].tojson())._inputs[0]
    assert (fc.attr("lr_mult"), fc._inputs[1].attr("ctx_group")) == \
        ("0.1", "dev1")


def test_eval_group_scalars_and_internals_match_jax():
    rng = onp.random.RandomState(1)
    av = rng.rand(2, 3).astype("float32")
    bv = rng.rand(2, 3).astype("float32")
    outs = []
    for lib in (jmx, mx):
        g = _graphs(lib)["arith"]
        z = lib.sym.Group([lib.sym.zeros((2, 2)) + 1.0,
                           lib.sym.ones((3,)) * 3.0])
        x = lib.sym.Variable("x")
        net = lib.sym.Activation(lib.sym.FullyConnected(
            x, num_hidden=3, name="fc"), act_type="relu", name="act")
        args = dict(x=lib.nd.array(av), fc_weight=lib.nd.array(bv.T @ bv),
                    fc_bias=lib.nd.array(bv[0]))
        outs.append([o.asnumpy() for o in
                     g.eval(a=lib.nd.array(av), b=lib.nd.array(bv))
                     + z.eval() + net.get_internals().eval(**args)])
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(b, a)
    for name in ("_sym_zeros", "_sym_ones"):
        assert OPS[name].module.endswith(".ops.tensor")
        assert jOPS[name].module.endswith(".ops.tensor")
    zs = mx.nd._sym_zeros(shape=(2, 2), ctx=mx.cpu())
    os_ = mx.nd._sym_ones(shape=(3,), dtype="int32")
    for got, want in ((zs, jmx.sym.zeros((2, 2)).eval()[0]),
                      (os_, jmx.sym.ones((3,), dtype="int32").eval()[0])):
        assert isinstance(got, mx.nd.NDArray) and got.context == mx.cpu()
        assert got.dtype == want.dtype
        onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def _lenet_bn(lib):
    """LeNet with a BatchNorm (learned gamma) after the first convolution:
    its moving statistics are arguments the Executor differentiates too."""
    s = lib.sym
    c1 = s.Convolution(s.Variable("data"), kernel=(5, 5), num_filter=4,
                       name="conv1")
    t1 = s.Activation(s.BatchNorm(c1, fix_gamma=False, name="bn1"),
                      act_type="tanh", name="tanh1")
    p1 = s.Pooling(t1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                   name="pool1")
    fc = s.FullyConnected(s.flatten(p1, name="flatten"), num_hidden=10,
                          name="fc")
    return s.SoftmaxOutput(fc, s.Variable("softmax_label"), name="softmax")


def _lenet_args(seed=0):
    sym = _lenet_bn(jmx)
    shapes, _, _ = sym.infer_shape(**SHAPES["lenet"])
    rng = onp.random.RandomState(seed)
    args = {n: (rng.rand(*s).astype("float32") - 0.5) * 0.3
            for n, s in zip(sym.list_arguments(), shapes)}
    args["softmax_label"] = rng.randint(0, 10, (4,)).astype("float32")
    args["bn1_moving_var"] += 0.5
    return args


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_executor_forward_backward_matches_jax(grad_req):
    """Two forward/backward rounds (the second with given ``out_grads``)
    on ``simple_bind`` Executors whose arguments are set alike."""
    args = _lenet_args()
    cot = onp.random.RandomState(2).rand(4, 10).astype("float32")
    got = []
    for lib, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        exe = _lenet_bn(lib).simple_bind(ctx=ctx, grad_req=grad_req,
                                         **SHAPES["lenet"])
        exe.copy_params_from({k: lib.nd.array(v) for k, v in args.items()})
        rounds = []
        for out_grads in (None, [lib.nd.array(cot)]):
            out = exe.forward(is_train=True)[0].asnumpy()
            exe.backward(out_grads)
            rounds.append([out] + [exe.grad_dict[n].asnumpy()
                                   for n in sorted(exe.grad_dict)])
        rounds.append([exe.forward(is_train=False)[0].asnumpy()])
        got.append(rounds)
    for r_jax, r_port in zip(*got):
        for a, b in zip(r_jax, r_port):
            _close(b, a)
    with pytest.raises(MXNetError, match="forward\\(is_train=True\\)"):
        exe.backward()


def test_attr_scope_and_name_prefix_match_jax():
    """The JAX test's cases, and the node names and attrs equal to the
    JAX package's."""
    res = []
    for lib in (jmx, mx):
        with lib.name.NameManager():
            with lib.AttrScope(ctx_group="dev1", lr_mult="0.1"):
                with lib.name.Prefix("enc_"):
                    data = lib.sym.Variable("data")
                    fc = lib.sym.FullyConnected(data, num_hidden=4)
            fc2 = lib.sym.FullyConnected(data, num_hidden=4)
        assert fc.name.startswith("enc_fullyconnected")
        assert fc.attr("ctx_group") == "dev1" and fc.attr("lr_mult") == "0.1"
        assert fc.list_attr()["ctx_group"] == "dev1"
        assert fc2.attr("ctx_group") is None
        with pytest.raises(ValueError):
            lib.AttrScope(bad=3)
        assert lib.sym.load_json(fc.tojson()).attr("ctx_group") == "dev1"
        with lib.AttrScope(lr_mult="0.1"):
            w = lib.sym.Variable("w_annotated")
        assert lib.sym.load_json(w.tojson()).attr("lr_mult") == "0.1"
        with lib.AttrScope(ctx_group="scope"):
            n = lib.sym.Symbol(None, [], attrs={"ctx_group": "explicit"},
                               name="n0")
        assert n.attr("ctx_group") == "explicit"
        assert n.list_attr()["ctx_group"] == "explicit"
        res.append((fc.name, fc2.name, fc.list_attr(), fc2.list_attr(),
                    fc.list_arguments(), fc2.list_arguments()))
    assert res[0] == res[1]


def test_print_summary_matches_jax(capsys):
    """The same table and total (LeNet: 431,080 parameters)."""
    totals, tables = [], []
    for viz, lib in ((jviz, jmx), (visualization, mx)):
        totals.append(viz.print_summary(_build(lib, "lenet"),
                                        shape=SHAPES["lenet"]))
        tables.append(capsys.readouterr().out)
    assert totals[1] == totals[0] == 431080
    assert tables[1] == tables[0]
    assert "fc1 (FullyConnected)" in tables[1]
    assert mx.viz is visualization
