"""PyTorch port: the vision path held against the JAX package on the CPU.

Convolution, transposed convolution, pooling, BatchNorm, padding and the
activations against the JAX ops (forward, and the gradients for one seeded
cotangent); the conv, pooling and BatchNorm layers; ResNet v1 from the
model zoo with the same weights (``convert.params_from_jax``) and through
``.params`` files both ways; and one ``parallel.ShardedTrainer`` step of a
net with BatchNorm against the JAX trainer's, running statistics included.

Tolerances, float32: ops atol 1e-5 (another summation order; observed
~1e-6), ResNet logits atol 1e-4 (18 and 50 layers of it; observed ~1e-5),
trainer loss rtol 1e-5 and gradients within 1e-4 of each parameter's
largest gradient. bfloat16 ResNet logits: within 5e-2 of their largest
value (the activations round to bf16 after every conv and BatchNorm, at
places that differ by one ulp between the packages; observed ~1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import optimizer as joptimizer
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu.ops import tensor as jtensor

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd, parallel
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.ops import nn as tnn

ATOL = 1e-5


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


def _rand(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _vs_jax(jfn, tfn, args, seed=0, atol=ATOL, grad=True):
    """``jfn`` (jnp arrays) and ``tfn`` (tensors) on the same float32
    ``args``: equal outputs, and equal gradients of every argument for
    one seeded cotangent."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a.copy()).requires_grad_(grad) for a in args]
    tout = tfn(*ts)
    onp.testing.assert_allclose(tout.detach().numpy(), onp.asarray(jout),
                                atol=atol, rtol=ATOL)
    if not grad:
        return
    cot = onp.random.RandomState(seed + 1).randn(*jout.shape).astype(
        "float32")
    jgrads = vjp(jnp.asarray(cot))
    tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(cot),
                                 allow_unused=True)
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        w = onp.asarray(w)
        g = onp.zeros_like(w) if g is None else g.numpy()
        onp.testing.assert_allclose(g, w, atol=atol * max(1.0, onp.abs(
            w).max()), rtol=ATOL, err_msg=f"gradient of argument {i}")


# -- ops ---------------------------------------------------------------------
CONV_CASES = [
    # (data shape, weight shape, kwargs)
    ((2, 3, 9), (4, 3, 3), dict(kernel=(3,), stride=(2,), pad=(1,))),
    ((2, 3, 9, 8), (4, 3, 3, 3), dict(kernel=(3, 3), pad=(1, 1))),
    ((2, 4, 9, 7), (6, 2, 3, 2), dict(kernel=(3, 2), stride=(2, 1),
                                      dilate=(2, 1), pad=(2, 0),
                                      num_group=2)),
    ((1, 2, 5, 6, 7), (3, 2, 3, 3, 3), dict(kernel=(3, 3, 3),
                                            stride=(1, 2, 2),
                                            pad=(1, 1, 0))),
    ((2, 4, 8, 8), (8, 1, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), num_group=4)),
]


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
@pytest.mark.parametrize("bias", [False, True])
def test_convolution_matches_jax(case, bias):
    dshape, wshape, kw = CONV_CASES[case]
    rng = onp.random.RandomState(case)
    args = [_rand(rng, *dshape), _rand(rng, *wshape)]
    if bias:
        args.append(_rand(rng, wshape[0]))
    _vs_jax(lambda *a: jnn.convolution(*a, **kw),
            lambda *a: tnn.convolution(*a, **kw), args, seed=case)


DECONV_CASES = [
    ((2, 3, 7), (3, 4, 3), dict(kernel=(3,), stride=(2,), pad=(1,),
                                adj=(1,))),
    ((2, 4, 5, 6), (4, 3, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 0))),
    ((1, 4, 5, 5), (4, 2, 4, 4), dict(kernel=(4, 4), stride=(2, 2),
                                      pad=(1, 1), num_group=2)),
    ((1, 2, 3, 4, 5), (2, 3, 2, 2, 3), dict(kernel=(2, 2, 3),
                                            stride=(2, 1, 2),
                                            adj=(1, 0, 1))),
]


@pytest.mark.parametrize("case", range(len(DECONV_CASES)))
def test_deconvolution_matches_jax(case):
    dshape, wshape, kw = DECONV_CASES[case]
    rng = onp.random.RandomState(10 + case)
    groups = kw.get("num_group", 1)
    args = [_rand(rng, *dshape), _rand(rng, *wshape),
            _rand(rng, wshape[1] * groups)]
    _vs_jax(lambda *a: jnn.deconvolution(*a, **kw),
            lambda *a: tnn.deconvolution(*a, **kw), args, seed=case)


POOL_SHAPES = {1: (2, 3, 11), 2: (2, 3, 9, 7), 3: (1, 2, 7, 6, 5)}
POOL_KW = {1: dict(kernel=(3,), stride=(2,), pad=(1,)),
           2: dict(kernel=(3, 2), stride=(2, 2), pad=(1, 0)),
           3: dict(kernel=(2, 3, 2), stride=(2, 2, 1), pad=(0, 1, 1))}


@pytest.mark.parametrize("nd_", [1, 2, 3])
@pytest.mark.parametrize("convention", ["valid", "full", "same"])
@pytest.mark.parametrize("pool", ["max", "avg", "avg_exclude", "sum", "lp"])
def test_pooling_matches_jax(nd_, convention, pool):
    """Odd sizes, so each convention pads or drops a partial window."""
    rng = onp.random.RandomState(nd_)
    kw = dict(POOL_KW[nd_], pooling_convention=convention,
              pool_type=pool.split("_")[0],
              count_include_pad=pool != "avg_exclude")
    _vs_jax(lambda x: jnn.pooling(x, **kw),
            lambda x: tnn.pooling(x, **kw),
            [_rand(rng, *POOL_SHAPES[nd_])], seed=nd_)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_global_pooling_matches_jax(pool):
    rng = onp.random.RandomState(3)
    kw = dict(global_pool=True, pool_type=pool, kernel=(1, 1))
    _vs_jax(lambda x: jnn.pooling(x, **kw), lambda x: tnn.pooling(x, **kw),
            [_rand(rng, 2, 3, 5, 4)])


def test_pooling_full_is_not_torch_ceil_mode():
    """At size 5, kernel 2, stride 2, pad 1, MXNet's ``full`` convention
    keeps a last window that starts in the padding; torch's ``ceil_mode``
    drops it."""
    x = torch.arange(25.0).reshape(1, 1, 5, 5)
    got = tnn.pooling(x, kernel=(2, 2), stride=(2, 2), pad=(1, 1),
                      pooling_convention="full")
    want = jnn.pooling(jnp.asarray(x.numpy()), kernel=(2, 2), stride=(2, 2),
                       pad=(1, 1), pooling_convention="full")
    assert tuple(got.shape) == want.shape == (1, 1, 4, 4)
    torch_ceil = torch.nn.functional.max_pool2d(x, 2, 2, 1, ceil_mode=True)
    assert tuple(torch_ceil.shape) == (1, 1, 3, 3)
    onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))


BN_CASES = [
    # (training, fix_gamma, use_global_stats, axis)
    (True, False, False, 1),
    (True, True, False, 1),
    (True, False, True, 1),
    (False, False, False, 1),
    (True, False, False, 3),
]


@pytest.mark.parametrize("case", range(len(BN_CASES)))
def test_batch_norm_matches_jax(case):
    """Output, batch (or moving) mean and the biased variance, and the
    gradients of data, gamma and beta."""
    training, fix_gamma, use_global, axis = BN_CASES[case]
    rng = onp.random.RandomState(case)
    x = (_rand(rng, 4, 3, 5, 3) * 2 + 0.5)
    c = x.shape[axis]
    g, b = rng.rand(c).astype("float32") + 0.5, _rand(rng, c)
    mm, mv = _rand(rng, c), rng.rand(c).astype("float32") + 0.5
    kw = dict(eps=1e-5, fix_gamma=fix_gamma, use_global_stats=use_global,
              axis=axis, training=training)
    for i in (0, 1, 2):
        _vs_jax(lambda x, g, b: jnn.batch_norm(x, g, b, jnp.asarray(mm),
                                               jnp.asarray(mv), **kw)[i],
                lambda x, g, b: tnn.batch_norm(x, g, b, torch.from_numpy(mm),
                                               torch.from_numpy(mv),
                                               **kw)[i],
                [x, g, b], seed=case, grad=i == 0)


def test_batch_norm_variance_is_biased_and_bf16_keeps_fp32_stats():
    """The batch variance is ``jnp.var``'s (biased), not the unbiased one
    torch's ``F.batch_norm`` puts in its running statistics; bfloat16 data
    gives bfloat16 output from float32 statistics, as the reference's."""
    rng = onp.random.RandomState(7)
    x = _rand(rng, 2, 3, 2, 2)
    g, b = onp.ones(3, "float32"), onp.zeros(3, "float32")
    mm, mv = onp.zeros(3, "float32"), onp.ones(3, "float32")
    _, _, var = tnn.batch_norm(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(b), torch.from_numpy(mm),
                               torch.from_numpy(mv), training=True)
    onp.testing.assert_allclose(var.numpy(), x.var(axis=(0, 2, 3)),
                                rtol=1e-5)
    assert not onp.allclose(var.numpy(), x.var(axis=(0, 2, 3), ddof=1))
    xb = jnp.asarray(x, jnp.bfloat16)
    jout, jm, jv = jnn.batch_norm(xb, jnp.asarray(g), jnp.asarray(b),
                                  jnp.asarray(mm), jnp.asarray(mv),
                                  fix_gamma=False, training=True)
    tout, tm, tv = tnn.batch_norm(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(g),
        torch.from_numpy(b), torch.from_numpy(mm), torch.from_numpy(mv),
        fix_gamma=False, training=True)
    assert tout.dtype == torch.bfloat16 and tm.dtype == tv.dtype \
        == torch.float32
    onp.testing.assert_allclose(tm.numpy(), onp.asarray(jm), atol=1e-6)
    onp.testing.assert_allclose(tv.numpy(), onp.asarray(jv), rtol=1e-5)
    # the outputs round to bf16 from the same float32 values: one ulp
    onp.testing.assert_allclose(tout.float().numpy(),
                                onp.asarray(jout.astype(jnp.float32)),
                                atol=2 ** -7 * 4)


@pytest.mark.parametrize("act", sorted(tnn.ACTIVATIONS))
def test_activations_match_jax(act):
    x = onp.random.RandomState(5).randn(4, 6).astype("float32") * 3
    _vs_jax(lambda a: jnn.activation(a, act_type=act),
            lambda a: tnn.activation(a, act), [x])


@pytest.mark.parametrize("act", ["leaky", "prelu", "elu", "selu", "gelu",
                                 "rrelu"])
def test_leaky_relu_matches_jax(act):
    rng = onp.random.RandomState(6)
    x, gamma = _rand(rng, 2, 3, 4), rng.rand(3).astype("float32")
    if act == "prelu":
        _vs_jax(lambda a, g: jnn.leaky_relu(a, g, act_type=act),
                lambda a, g: tnn.leaky_relu(a, g, act_type=act), [x, gamma])
    else:
        _vs_jax(lambda a: jnn.leaky_relu(a, act_type=act, slope=0.3),
                lambda a: tnn.leaky_relu(a, act_type=act, slope=0.3), [x])


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad_matches_jax(mode):
    x = _rand(onp.random.RandomState(8), 2, 3, 4, 5)
    pw = (0, 0, 0, 0, 1, 2, 2, 1)
    _vs_jax(lambda a: jtensor.pad(a, mode=mode, pad_width=pw,
                                  constant_value=0.5),
            lambda a: tnn.pad(a, mode, pw, 0.5), [x])


def test_nd_ops_take_ndarrays():
    """The ``F``/``mx.nd`` names the JAX blocks call, on NDArrays."""
    rng = onp.random.RandomState(9)
    x, w = _rand(rng, 2, 3, 6, 6), _rand(rng, 4, 3, 3, 3)
    got = nd.Convolution(nd.array(x), nd.array(w), None, kernel=(3, 3),
                         pad=(1, 1), no_bias=True)
    want = jmx.nd.Convolution(jmx.nd.array(x), jmx.nd.array(w), None,
                              kernel=(3, 3), pad=(1, 1), no_bias=True)
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), atol=ATOL)
    p = nd.Pooling(got, kernel=(2, 2), stride=(2, 2), pool_type="avg")
    assert p.shape == (2, 4, 3, 3)
    assert nd.Flatten(p).shape == (2, 36) == nd.flatten(p).shape
    assert (nd.relu(nd.array([-1.0, 2.0])).asnumpy() == [0, 2]).all()
    out, m, v = nd.BatchNorm(got, nd.ones(4), nd.zeros(4), nd.zeros(4),
                             nd.ones(4), training=True, fix_gamma=False)
    assert out.shape == got.shape and m.shape == v.shape == (4,)
    y = nd.Deconvolution(p, nd.array(_rand(rng, 4, 2, 2, 2)), None,
                         kernel=(2, 2), stride=(2, 2), no_bias=True)
    assert y.shape == (2, 2, 6, 6)


# -- layers ------------------------------------------------------------------
def _copy_params(jnet, tnet):
    arrays = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    params_from_jax(tnet, arrays)
    return arrays


def test_conv_and_pool_layers_match_jax():
    """Deferred ``in_channels`` inferred at the first call,
    ``activation=``, transposed convs, the pooling layers, ceil_mode,
    ReflectionPad2D, Flatten and Identity, in both packages."""
    rng = onp.random.RandomState(11)
    x = _rand(rng, 2, 3, 11, 9)

    def build(pkg):
        n = pkg.gluon.nn
        net = n.HybridSequential()
        with net.name_scope():
            net.add(n.Conv2D(6, 3, padding=1, activation="relu"),
                    n.MaxPool2D(3, 2, ceil_mode=True),
                    n.Conv2DTranspose(4, 3, strides=2, padding=1,
                                      output_padding=1),
                    n.AvgPool2D(2, count_include_pad=False, padding=1),
                    n.ReflectionPad2D(1),
                    n.Conv2D(5, (2, 3), strides=(1, 2), dilation=(2, 1),
                             groups=1, use_bias=False),
                    n.GlobalMaxPool2D(), n.Identity(), n.Flatten())
        net.initialize(pkg.init.Xavier())
        return net

    jnet, tnet = build(jmx), build(mx)
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet(nd.array(x))                     # finishes deferred init
    assert {k: p.shape for k, p in tnet.collect_params().items()} == {
        k: p.shape for k, p in jnet.collect_params().items()}
    _copy_params(jnet, tnet)
    onp.testing.assert_allclose(tnet(nd.array(x)).asnumpy(), want,
                                atol=ATOL)
    for ndim in (1, 3):
        shape = (2, 3) + (7,) * ndim
        xs = _rand(rng, *shape)
        for name in ("Conv{}D", "Conv{}DTranspose"):
            jl = getattr(jgluon.nn, name.format(ndim))(2, 3, strides=2)
            tl = getattr(gluon.nn, name.format(ndim))(2, 3, strides=2)
            jl.initialize()
            want = jl(jmx.nd.array(xs)).asnumpy()
            tl.initialize()
            tl(nd.array(xs))
            _copy_params(jl, tl)
            onp.testing.assert_allclose(tl(nd.array(xs)).asnumpy(), want,
                                        atol=ATOL)
        for name in ("MaxPool{}D", "AvgPool{}D", "GlobalAvgPool{}D"):
            jl = getattr(jgluon.nn, name.format(ndim))()
            tl = getattr(gluon.nn, name.format(ndim))()
            onp.testing.assert_allclose(
                tl(nd.array(xs)).asnumpy(),
                jl(jmx.nd.array(xs)).asnumpy(), atol=ATOL)


@pytest.mark.parametrize("name", ["LeakyReLU", "PReLU", "ELU", "SELU",
                                  "Swish", "GELU", "SiLU"])
def test_activation_layers_match_jax(name):
    x = _rand(onp.random.RandomState(12), 2, 3, 4)
    args = {"LeakyReLU": (0.1,)}.get(name, ())
    kw = {"PReLU": dict(in_channels=3)}.get(name, {})
    jl, tl = (getattr(p.gluon.nn, name)(*args, **kw) for p in (jmx, mx))
    jl.initialize()
    tl.initialize()
    if name == "PReLU":
        assert (tl.alpha.data().asnumpy() == 0.25).all()
        _copy_params(jl, tl)
    onp.testing.assert_allclose(tl(nd.array(x)).asnumpy(),
                                jl(jmx.nd.array(x)).asnumpy(), atol=ATOL)


def test_lambda_layers():
    x = nd.array([[-1.0, 2.0]])
    assert (gluon.nn.Lambda("relu")(x).asnumpy() == [[0, 2]]).all()
    assert (gluon.nn.Lambda(lambda a: a * 2)(x).asnumpy() == [[-2, 4]]).all()
    assert (gluon.nn.HybridLambda("tanh")(x).asnumpy()
            == onp.tanh([[-1.0, 2.0]]).astype("float32")).all()
    assert (gluon.nn.HybridLambda(lambda F, a: F.relu(a) + 1)(x).asnumpy()
            == [[1, 3]]).all()


def test_batchnorm_layer_running_stats_match_jax():
    """Three training forwards move the running statistics as the JAX
    layer's (biased variance, momentum 0.9), then ``predict_mode`` reads
    them; ``cast("bfloat16")`` keeps the layer float32; ``SyncBatchNorm``
    is BatchNorm on one device."""
    rng = onp.random.RandomState(13)
    xs = [(_rand(rng, 4, 3, 3, 3) * 3 + 1) for _ in range(3)]
    for cls in ("BatchNorm", "SyncBatchNorm"):
        jl = getattr(jgluon.nn, cls)(momentum=0.8, in_channels=3)
        tl = getattr(gluon.nn, cls)(momentum=0.8, in_channels=3)
        jl.initialize()
        tl.initialize()
        for x in xs:
            with jmx.autograd.record():
                want = jl(jmx.nd.array(x))
            with autograd.record():
                got = tl(nd.array(x))
            onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                        atol=ATOL)
        for stat in ("running_mean", "running_var"):
            onp.testing.assert_allclose(
                getattr(tl, stat).data().asnumpy(),
                getattr(jl, stat).data().asnumpy(), rtol=1e-5, atol=1e-7)
        with autograd.predict_mode():
            got = tl(nd.array(xs[0]))
        onp.testing.assert_allclose(got.asnumpy(), jl(jmx.nd.array(
            xs[0])).asnumpy(), atol=ATOL)
    tl.cast("bfloat16")
    assert all(p.dtype == "float32" for p in tl.collect_params().values())
    assert tl(nd.array(xs[0]).astype("bfloat16")).dtype == "bfloat16"
    assert [p.grad_req for p in tl.collect_params().values()] == [
        "write", "write", "null", "null"]


def test_initializers_on_conv_and_batchnorm_params():
    """``Xavier`` counts the receptive field in fan-in and fan-out on a 4-D
    conv weight, as the reference; the running statistics start at 0 and 1
    under any initializer; ``Zero``/``One`` fill them by name."""
    shape = (8, 4, 3, 3)
    scale = (3.0 / ((4 * 9 + 8 * 9) / 2.0)) ** 0.5
    for pkg in (jmx, mx):
        layer = pkg.gluon.nn.Conv2D(8, 3, in_channels=4, use_bias=False)
        layer.initialize(pkg.init.Xavier())
        w = layer.weight.data().asnumpy()
        assert w.shape == shape
        assert onp.abs(w).max() <= scale and onp.abs(w).max() > 0.9 * scale
        bn = pkg.gluon.nn.BatchNorm(in_channels=5)
        bn.initialize(pkg.init.Xavier())
        assert (bn.running_mean.data().asnumpy() == 0).all()
        assert (bn.running_var.data().asnumpy() == 1).all()
        for name, init, want in (("x_running_var", pkg.init.Zero(), 1.0),
                                 ("x_running_mean", pkg.init.One(), 0.0)):
            arr = pkg.nd.array(onp.full(3, 7.0, "float32"))
            init(name, arr)
            assert (arr.asnumpy() == want).all(), (pkg.__name__, name)


# -- the model zoo ------------------------------------------------------------
#: XLA:CPU's cheapest compile: each reference runs once, so compiling it
#: takes most of its time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_predict(net, x):
    """The JAX net's predict-mode logits, jitted with its weights as trace
    proxies (one XLA program; eager JAX Gluon compiles each op)."""
    from incubator_mxnet_tpu.gluon import _trace
    from incubator_mxnet_tpu.gluon.block import _TRACING
    params = list(net.collect_params().values())
    vals = [p.data()._data for p in params]

    def run(pvals, xin):
        proxies = {id(p): jmx.nd.NDArray(v) for p, v in zip(params, pvals)}
        _TRACING.flag = True
        try:
            with jmx.autograd.pause(train_mode=False), \
                    _trace.TraceScope(proxies):
                return net(jmx.nd.NDArray(xin))._data
        finally:
            _TRACING.flag = False
    xj = jnp.asarray(x)
    return onp.asarray(jax.jit(run).lower(vals, xj).compile(FAST_COMPILE)(
        vals, xj).astype(jnp.float32))


@pytest.fixture(scope="module")
def resnets(tmp_path_factory):
    """The JAX resnet18_v1 and resnet50_v1 (10 classes) with the weights
    of a seeded port net (Xavier, running statistics moved off 0 and 1 by
    one training forward), loaded from its ``.params`` file, and their
    logits on one 32x32 batch in float32 (jitted)."""
    x = _rand(onp.random.RandomState(14), 2, 3, 32, 32)
    out = {"x": x}
    d = tmp_path_factory.mktemp("resnets")
    for name in ("resnet18_v1", "resnet50_v1"):
        mx.random.seed(0)
        with mx.cpu():
            pnet = vision.get_model(name, classes=10)
            pnet.initialize(mx.init.Xavier())
            with autograd.train_mode():
                pnet(nd.array(x * 0.5 + 0.3))
            f = str(d / f"{name}.params")
            pnet.save_parameters(f)
        net = jvision.get_model(name, classes=10)
        net.load_parameters(f)
        out[name] = {"net": net, "want": _jax_predict(net, x), "file": f,
                     "arrays": {k: p.data().asnumpy() for k, p in
                                net.collect_params().items()}}
    return out


def _by_suffix(net):
    """A net's Parameters by name without the net's own prefix."""
    n = len(net.prefix)
    return {k[n:]: p for k, p in net.collect_params().items()}


def _suffixed(net, arrays):
    """``arrays`` keyed by names without ``net``'s prefix."""
    n = len(net.prefix)
    return {k[n:]: v for k, v in arrays.items()}


def _port_resnet(name, arrays, x):
    net = vision.get_model(name, classes=10)
    net.initialize(mx.init.Xavier())
    net(nd.array(x))
    params_from_jax(net, arrays)
    return net


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_forward_matches_jax(resnets, name, dtype):
    ref, x = resnets[name], resnets["x"]
    net = _port_resnet(name, ref["arrays"], x)
    assert sorted(_by_suffix(net)) == sorted(_suffixed(ref["net"],
                                                       ref["arrays"]))
    assert sum(p.numel() for p in net.parameters()) == sum(
        a.size for a in ref["arrays"].values())
    if dtype == "float32":
        onp.testing.assert_allclose(net(nd.array(x)).asnumpy(), ref["want"],
                                    atol=1e-4)
        return
    jnet = jvision.get_model(name, classes=10)
    jnet.load_parameters(ref["file"])
    jnet.cast("bfloat16")
    want = _jax_predict(jnet, jnp.asarray(x).astype(jnp.bfloat16))
    net.cast("bfloat16")
    kinds = {p.name.rsplit("_", 1)[-1]: p.dtype
             for p in net.collect_params().values()}
    assert kinds["weight"] == "bfloat16" and kinds["gamma"] == "float32"
    assert kinds["mean"] == kinds["var"] == "float32"
    # the bf16-cast net takes the JAX weights directly, BN in float32
    params_from_jax(net, {k: p.data().asnumpy() for k, p in
                          jnet.collect_params().items()})
    got = net(nd.array(x).astype("bfloat16"))
    assert got.dtype == "bfloat16"
    err = onp.abs(got.asnumpy().astype("float32") - want).max()
    assert err <= 5e-2 * onp.abs(want).max(), err


def test_model_zoo_names_and_v2(tmp_path):
    with pytest.raises(ValueError, match="resnet50_v1"):
        vision.get_model("vgg99")
    assert sorted(vision._MODELS) == sorted(jvision._MODELS)
    x = _rand(onp.random.RandomState(15), 1, 3, 32, 32)
    mx.random.seed(1)
    net = vision.resnet18_v2(classes=4, thumbnail=True)
    net.initialize(mx.init.Xavier())
    net(nd.array(x))
    f = str(tmp_path / "v2.params")
    net.save_parameters(f)
    jnet = jvision.resnet18_v2(classes=4, thumbnail=True)
    jnet.load_parameters(f)
    want = _jax_predict(jnet, x)
    onp.testing.assert_allclose(net(nd.array(x)).asnumpy(), want, atol=1e-4)


def test_resnet_params_files_move_both_ways(resnets, tmp_path):
    """A JAX ``save_parameters`` file of resnet18_v1 loads into the port
    (running statistics included) with equal logits, and a port file
    into JAX."""
    ref, x = resnets["resnet18_v1"], resnets["x"]
    jfile = str(tmp_path / "jax.params")
    ref["net"].save_parameters(jfile)
    net = vision.resnet18_v1(classes=10)
    net.load_parameters(jfile)
    names = net._collect_params_with_prefix()
    assert "features.1.running_mean" in names
    onp.testing.assert_allclose(net(nd.array(x)).asnumpy(), ref["want"],
                                atol=1e-4)
    with autograd.train_mode():                  # moves the statistics
        net(nd.array(x))
    pfile = str(tmp_path / "port.params")
    net.save_parameters(pfile)
    other = jvision.resnet18_v1(classes=10)
    other.load_parameters(pfile)
    onp.testing.assert_allclose(
        other(jmx.nd.array(x)).asnumpy(), net(nd.array(x)).asnumpy(),
        atol=1e-4)
    rm = "features.1.running_mean"
    onp.testing.assert_array_equal(
        other._collect_params_with_prefix()[rm].data().asnumpy(),
        names[rm].data().asnumpy())


# -- ShardedTrainer over a net with BatchNorm --------------------------------
def _bn_net(pkg):
    n = pkg.gluon.nn
    net = n.HybridSequential()
    with net.name_scope():
        net.add(n.Conv2D(8, 3, padding=1, use_bias=False), n.BatchNorm(),
                n.Activation("relu"), n.MaxPool2D(2, 2),
                n.Conv2D(8, 3, padding=1), n.BatchNorm(scale=False),
                n.Activation("relu"), n.GlobalAvgPool2D(), n.Dense(5))
    return net


def _train_batch():
    rng = onp.random.RandomState(16)
    return (_rand(rng, 6, 3, 10, 10),
            rng.randint(0, 5, (6,)).astype("float32"))


SGD = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(scope="module", params=[0.0, 0.5])
def jax_step(request):
    """One step of the JAX ``ShardedTrainer`` (SGD momentum, ``wd`` 0 or
    0.5): initial weights, loss, gradients, and each running statistic
    after the step (the Gluon parameter's, where the step's running
    update lands)."""
    wd = request.param
    x, y = _train_batch()
    jmx.random.seed(3)
    net = _bn_net(jmx)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(x[:1]))
    arrays = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    tr = jparallel.ShardedTrainer(
        net, lambda o, l: ce(o, l), "sgd", dict(SGD, wd=wd),
        mesh=jparallel.make_mesh(devices=jax.devices()[:1]), n_labels=1)
    tr.prepare(x, y)
    # the trainer's own forward + backward, jitted as its step jits it
    loss, gnorm, grads, _, _ = jax.jit(tr._make_loss_grads(1))(
        tr._param_vals, tr._base_key, jnp.int32(1), *tr.place(x, y))
    names = [n for n, _ in sorted(net.collect_params().items())]
    tr.step(x, y)
    stats = {k: p.data().asnumpy() for k, p in net.collect_params().items()
             if "running" in k}
    return {"wd": wd, "arrays": arrays, "prefix": net.prefix,
            "loss": float(loss),
            "grad_norm": float(gnorm), "stats": stats,
            "grads": dict(zip(names, (onp.asarray(g) for g in grads)))}


def test_sharded_trainer_step_with_batchnorm_matches_jax(jax_step):
    """Loss, gradient norm and gradients equal the reference's; each
    running statistic is the reference's running update followed by the
    reference optimizer's step on it with a zero gradient: the JAX trainer
    sends every parameter through the optimizer, so at ``wd > 0`` weight
    decay and momentum move the statistics too."""
    x, y = _train_batch()
    net = _bn_net(mx)
    net.initialize(mx.init.Xavier())
    net(nd.array(x[:1]))
    params_from_jax(net, jax_step["arrays"])
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = parallel.ShardedTrainer(net, lambda o, l: ce(o, l), "sgd",
                                 dict(SGD, wd=jax_step["wd"]), device="cpu",
                                 n_labels=1)
    loss = float(tr.step(x, y))
    onp.testing.assert_allclose(loss, jax_step["loss"], rtol=1e-5)
    onp.testing.assert_allclose(tr.last_grad_norm, jax_step["grad_norm"],
                                rtol=1e-5)
    params = _by_suffix(net)
    jprefix = jax_step["prefix"]
    for name, want in jax_step["grads"].items():
        p = params[name[len(jprefix):]]
        got = p._var.grad
        if got is None:             # the eager step leaves none on aux
            assert p.grad_req == "null" and not want.any(), name
            continue
        # a bias before a BatchNorm has a zero gradient, up to rounding
        assert onp.abs(got.numpy() - want).max() <= 1e-4 * max(
            onp.abs(want).max(), 1e-3), name
    jopt = joptimizer.create("sgd", **dict(SGD, wd=jax_step["wd"]))
    for name, ema in jax_step["stats"].items():
        w = jnp.asarray(ema)
        want, _ = jopt.step(w, jnp.zeros_like(w),
                            jopt.create_state(0, jmx.nd.array(ema)),
                            SGD["learning_rate"], jax_step["wd"], 1)
        got = params[name[len(jprefix):]].data().asnumpy()
        onp.testing.assert_allclose(got, onp.asarray(want), rtol=1e-5,
                                    atol=1e-7, err_msg=name)
        if jax_step["wd"] == 0.0:
            onp.testing.assert_allclose(got, ema, rtol=1e-5, atol=1e-7)
        else:
            assert not onp.allclose(got, ema, rtol=1e-3, atol=0), name


def test_sharded_trainer_fused_function_keeps_running_update():
    """The fused step's function (run uncaptured here) moves the running
    statistics as the eager step does, and gives the same losses and
    weights over three steps; the deferred net is warmed by the trainer
    itself, as the JAX trainer warms it."""
    x, y = _train_batch()
    nets, trainers = [], []
    for _ in range(2):
        mx.random.seed(4)
        net = _bn_net(mx)
        net.initialize(mx.init.Xavier())
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        nets.append(net)
        tr = parallel.ShardedTrainer(
            net, lambda o, l, ce=ce: ce(o, l), "sgd", dict(SGD, wd=1e-4),
            device="cpu", n_labels=1)
        assert not net[0].weight._initialized
        tr._init_state(tr.place(x)[:1])     # initialises from the seed
        trainers.append(tr)
    fused, eager = trainers
    eager_losses = [float(eager.step(x, y)) for _ in range(3)]
    fused_losses = [float(fused._fused_step(fused.place(x, y),
                                            capture=False))
                    for _ in range(3)]
    assert eager.last_path == "eager"
    onp.testing.assert_allclose(fused_losses, eager_losses, rtol=1e-6)
    for (k, a), b in zip(nets[0].collect_params().items(),
                         nets[1].collect_params().values()):
        onp.testing.assert_allclose(a.data().asnumpy(), b.data().asnumpy(),
                                    rtol=1e-5, atol=1e-7, err_msg=k)
    rm = nets[0].collect_params()
    assert not onp.allclose(
        [v.data().asnumpy() for k, v in rm.items()
         if k.endswith("running_mean")][0], 0.0)


def test_hybridized_resnet_training_and_predict_modes(resnets):
    """A hybridized net on CPU arrays runs its eager forward: under
    ``autograd.record()`` it moves the running statistics and normalises
    by the batch, under ``predict_mode()`` it reads them; the JAX net does
    the same. At 64x64 the last stage's BatchNorms see 8 values per
    channel (batch 2, 2x2), enough to keep them well conditioned."""
    ref = resnets["resnet18_v1"]
    x = _rand(onp.random.RandomState(17), 2, 3, 64, 64)
    net = _port_resnet("resnet18_v1", ref["arrays"], x)
    net.hybridize()
    # the fixture's weights from its file, which also finishes the JAX
    # net's deferred shapes (no eager forward to initialise it)
    jnet = jvision.resnet18_v1(classes=10)
    jnet.load_parameters(ref["file"])
    jnet.hybridize()
    for _ in range(2):
        with autograd.record():
            got = net(nd.array(x))
        with jmx.autograd.record():
            want = jnet(jmx.nd.array(x))
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    atol=1e-4)
    rm = "features.1.running_mean"
    onp.testing.assert_allclose(
        net._collect_params_with_prefix()[rm].data().asnumpy(),
        jnet._collect_params_with_prefix()[rm].data().asnumpy(), rtol=1e-5,
        atol=1e-7)
    with autograd.predict_mode():
        got = net(nd.array(x)).asnumpy()
    with jmx.autograd.predict_mode():
        want = jnet(jmx.nd.array(x)).asnumpy()
    onp.testing.assert_allclose(got, want, atol=1e-4)


def _jax_bench_module():
    import importlib.util
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(repo, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_resnet_workload_on_cpu(monkeypatch):
    """The port bench's ``resnet`` workload at a tiny size on the CPU:
    ``run_resnet``'s JSON keys, the JAX bench's FLOP table and formula, a
    finite loss, bf16 weights with float32 BatchNorm, and the trainer's
    fp32 masters."""
    from incubator_mxnet_tpu_torch import bench
    assert bench.RESNET_FWD_GMACS_224 == \
        _jax_bench_module()._RESNET_FWD_GMACS_224
    for k, v in dict(MXTPU_BENCH_MODEL="resnet18_v1", MXTPU_BENCH_BATCH="2",
                     MXTPU_BENCH_IMG="32").items():
        monkeypatch.setenv(k, v)
    trainer, batch, info = bench.build_resnet("cpu")
    assert batch[0].dtype == torch.bfloat16 and batch[0].shape == (2, 3, 32,
                                                                   32)
    timings = {}
    dt, losses = bench.measure(trainer, batch, 1, timings)
    rec = bench.resnet_result(info, dt, losses, timings["first_step_s"])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert {"step_ms", "mfu", "batch", "img", "backend", "loss"} <= set(
        rec["extra"])
    assert rec["metric"] == "resnet18_v1_train_imgs_per_sec_per_chip"
    assert rec["unit"] == "imgs/sec/chip" and rec["extra"]["img"] == 32
    assert all(onp.isfinite(float(x)) for x in losses)
    flops = 3 * 2 * 1.82e9 * (32 / 224) ** 2 * 2
    onp.testing.assert_allclose(rec["extra"]["mfu"], round(
        flops / dt / 989e12, 4))
    dtypes = {p.name.rsplit("_", 1)[-1]: p.dtype
              for p in info["net"].collect_params().values()}
    assert dtypes["weight"] == "bfloat16" and dtypes["var"] == "float32"
    assert any(trainer._mp) and not all(trainer._mp)
    monkeypatch.setenv("MXTPU_BENCH_MODEL", "vgg16")
    with pytest.raises(SystemExit, match="resnet50_v1"):
        bench.build_resnet("cpu")
