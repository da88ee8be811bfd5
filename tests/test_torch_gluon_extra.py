"""PyTorch port: the rest of the Gluon surface, held against the JAX
package on the CPU.

- Initializers: the deterministic ones (``Bilinear``, ``LSTMBias``,
  ``Mixed``, ``Load``, ``InitDesc`` names) fill exactly what the JAX ones
  fill; ``Orthogonal`` gives ``scale`` times orthonormal rows or columns
  (within 1e-5) and ``MSRAPrelu`` the He deviation (within 5 standard
  errors); the registry names (``he``, ``msraprelu`` ...).
- ``autograd.grad(create_graph=True)``: second and third derivatives and
  a mixed one, against the JAX package's (rtol 1e-6); ``attach_grad``
  twice on one array (it raised in the port: the variable registry
  compared arrays with ``==``).
- ``GroupNorm``/``InstanceNorm`` layers (deferred ``in_channels``):
  outputs and input gradients within 1e-5; ``Block.summary`` prints what
  the JAX one prints; ``save_params``/``load_params``;
  ``Parameter.list_data``/``list_grad``/``reset_ctx``/``var``.
- ``gluon.utils``: ``split_data``, ``split_and_load``,
  ``clip_global_norm`` (the norm within 1e-6 relative, the arrays within
  1e-6), ``check_sha1`` and ``download`` (a local file only).
- ``contrib.nn.SparseEmbedding`` against the JAX one; ``Estimator.fit``
  with its handlers on a small task, its checkpoint loaded by the JAX
  package.
- ``dcgan_example`` against the JAX example's loop, 3 steps from one pair
  of ``.params`` files: ``lossD`` and ``lossG`` within 1e-4. The JAX
  reference is one jitted program: each step's losses and gradients by
  ``jax.value_and_grad`` of the traced JAX nets (what its autograd tape
  records) and the JAX ``Adam.step`` of its trainers.
"""
import contextlib
import hashlib
import importlib.util
import io
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, init, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import dcgan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


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


@contextlib.contextmanager
def _jax_trace(proxies, train=False):
    """The JAX Gluon blocks read ``proxies`` (traced values) for their
    parameters: inside ``jax.jit`` the nets become one XLA program (eager
    JAX Gluon compiles each op on its first call)."""
    from incubator_mxnet_tpu.gluon import _trace
    from incubator_mxnet_tpu.gluon.block import _TRACING
    _TRACING.flag = True
    try:
        with jmx.autograd.pause(train_mode=train), \
                _trace.TraceScope(proxies):
            yield
    finally:
        _TRACING.flag = False


def _fill(pkg_init, name, shape, ctor, *args, **kw):
    """One initializer of a package filling a zero array named ``name``."""
    if pkg_init is init:
        a = nd.zeros(shape)
    else:
        a = jmx.nd.zeros(shape)
    getattr(pkg_init, ctor)(*args, **kw)(name, a)
    return a.asnumpy()


def test_initializers():
    """Deterministic initializers equal the JAX ones; Orthogonal and
    MSRAPrelu by orthogonality and moments; the registry names."""
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "load.params")
        src = {"arg:net_w": onp.arange(6, dtype="float32").reshape(2, 3)}
        nd.save(f, {k: nd.array(v) for k, v in src.items()})
        cases = [
            ("up_weight", (3, 1, 4, 4), "Bilinear", (), {}),
            ("up_weight", (2, 2, 5, 3), "Bilinear", (), {}),
            ("l0_i2h_bias", (20,), "LSTMBias", (), dict(forget_bias=2.5)),
            ("lstm_weight", (8,), "LSTMBias", (), {}),
            ("net_w", (2, 3), "Load", (f,), {}),
            ("net_b", (3,), "Load", (f,), dict(default_init="one")),
            ("dense_bias", (4,), "Mixed", ([".*bias", ".*"],
                                           ["one", "zeros"]), {}),
            ("dense_weight", (4,), "Mixed", ([".*bias", ".*"],
                                             ["one", "constant"]), {}),
        ]
        for name, shape, ctor, args, kw in cases:
            if ctor == "Load":
                jargs = ({k: jmx.nd.array(v) for k, v in src.items()},)
            else:
                jargs = args
            for desc in (name, init.InitDesc(name, attrs={"a": 1})):
                got = _fill(init, desc, shape, ctor, *args, **kw)
                want = _fill(jmx.init, name, shape, ctor, *jargs, **kw)
                assert onp.array_equal(got, want), (ctor, name, shape)
    with pytest.raises(ValueError, match="no default_init"):
        _fill(init, "other", (3,), "Load", {"x": nd.zeros((3,))})
    # Orthogonal: square, tall and wide, and conv-shaped weights
    mx.random.seed(0)
    for shape in ((6, 6), (8, 3), (3, 8), (4, 2, 3)):
        w = _fill(init, "o_weight", shape, "Orthogonal", scale=1.5)
        w = w.reshape(shape[0], -1)
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        onp.testing.assert_allclose(gram, 2.25 * onp.eye(len(gram)),
                                    atol=1e-5, err_msg=str(shape))
    w = _fill(init, "he_weight", (400, 500), "MSRAPrelu", slope=0.1)
    std = (2.0 / (1 + 0.01) / 450.0) ** 0.5
    n = w.size
    assert abs(w.mean()) <= 5 * std / n ** 0.5
    assert abs(w.std() - std) <= 5 * std / (2 * n) ** 0.5
    assert isinstance(init.create("he"), init.MSRAPrelu)
    for name in ("orthogonal", "msraprelu", "bilinear", "lstmbias"):
        assert type(init.create(name)).__name__.lower() == name


def _second_orders(pkg):
    """The JAX test's three higher-order cases (``tests/test_ndarray.py``)
    in ``pkg``: each variable's gradient."""
    ag, pnd = pkg.autograd, pkg.nd
    out = []
    x = pnd.array(onp.array([2.0, -0.5], "float32"))
    x.attach_grad()
    x.attach_grad()          # again: a loop that re-attaches each step
    with ag.record():
        dx, = ag.grad(x * x * x, [x], create_graph=True)
        z = (dx * dx).sum()
    z.backward()
    out.append(x.grad.asnumpy())
    x = pnd.array(onp.array([0.7, 1.1], "float32"))
    w = pnd.array(onp.array([-1.3, 0.4], "float32"))
    x.attach_grad()
    w.attach_grad()
    with ag.record():
        dfdx, = ag.grad(pnd.sin(x * w), [x], create_graph=True)
        s = dfdx.sum()
    s.backward()
    out.append(w.grad.asnumpy())
    x = pnd.array(onp.array([1.5, 0.3], "float32"))
    x.attach_grad()
    with ag.record():
        g1, = ag.grad(x * x * x * x, [x], create_graph=True)
        g2, = ag.grad(g1, [x], create_graph=True)
        s = g2.sum()
    s.backward()
    out.append(x.grad.asnumpy())
    return out


def test_create_graph_matches_jax():
    """Higher-order gradients through ``grad(create_graph=True)``; an
    explicit ``retain_graph=False`` still returns the gradient."""
    x = onp.array([1.5, 0.3], "float32")
    x_sin = onp.array([0.7, 1.1], "float32")
    w_sin = onp.array([-1.3, 0.4], "float32")
    x_cube = onp.array([2.0, -0.5], "float32")
    got = _second_orders(mx)
    want = _second_orders(jmx)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-6)
    onp.testing.assert_allclose(got[0], 36 * x_cube ** 3, rtol=1e-5)
    wx = x_sin * w_sin
    onp.testing.assert_allclose(got[1], onp.cos(wx) - wx * onp.sin(wx),
                                rtol=1e-5)
    onp.testing.assert_allclose(got[2], 24 * x, rtol=1e-5)
    v = nd.array(onp.array([2.0], "float32"))
    v.attach_grad()
    with autograd.record():
        g, = autograd.grad(v * v, [v], create_graph=True, retain_graph=False)
    assert float(g.asscalar()) == 4.0


def test_norm_layers_summary_and_parameters():
    """GroupNorm and InstanceNorm against the JAX layers (values and input
    gradients), ``summary`` printing the JAX text, the deprecated
    ``save_params``/``load_params``, and the Parameter extras."""
    rng = onp.random.RandomState(3)
    x = rng.randn(2, 6, 4, 3).astype("float32")
    jnet, pnet = [], []
    for pkg, out in ((jmx, jnet), (mx, pnet)):
        net = pkg.gluon.nn.HybridSequential(prefix="norms_")
        with net.name_scope():
            net.add(pkg.gluon.nn.GroupNorm(num_groups=3, epsilon=1e-4))
            net.add(pkg.gluon.nn.InstanceNorm(scale=True))
            net.add(pkg.gluon.nn.Dense(5, in_units=72))
        out.append(net)
    jnet, pnet = jnet[0], pnet[0]
    pnet.initialize()
    pnet(nd.array(x))                     # deferred in_channels
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "n.params")
        pnet.save_params(f)
        jnet.load_params(f)
        pnet.load_params(f)
    pnet[0].gamma.set_data(nd.array(rng.rand(6).astype("float32") + 0.5))
    jnet[0].gamma.set_data(jmx.nd.array(pnet[0].gamma.data().asnumpy()))
    a = nd.array(x)
    a.attach_grad()
    with autograd.record():
        y = pnet(a)
        (y * y).sum().backward()
    params = [p for _, p in sorted(jnet.collect_params().items())]

    def jrun(pvals, xin):
        def f(xin):
            proxies = {id(p): jmx.nd.NDArray(v)
                       for p, v in zip(params, pvals)}
            with _jax_trace(proxies, train=True):
                out = jnet(jmx.nd.NDArray(xin))._data
            return jnp.sum(out * out), out
        (_, out), g = jax.value_and_grad(f, has_aux=True)(xin)
        return out, g

    pvals = [p.data()._data for p in params]
    want = jax.jit(jrun).lower(pvals, x).compile(FAST_COMPILE)(pvals, x)
    for g, w in zip((y.asnumpy(), a.grad.asnumpy()), want):
        onp.testing.assert_allclose(g, onp.asarray(w), atol=TOL, rtol=TOL)
    texts = []
    for pkg, net in ((mx, pnet), (jmx, jnet)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            net.summary(pkg.nd.array(x))
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    p = pnet[2].weight
    assert [a.shape for a in p.list_data()] == [(5, 72)]
    with autograd.record():
        pnet(nd.array(x)).sum().backward()
    assert onp.array_equal(p.list_grad()[0].asnumpy(), p.grad().asnumpy())
    before = p.data().asnumpy()
    pnet.collect_params().reset_ctx(mx.cpu(0))
    assert onp.array_equal(p.data().asnumpy(), before)
    assert pnet.collect_params().list_ctx() == [mx.cpu(0)]
    pnet.collect_params().setattr("lr_mult", 0.5)
    assert p.lr_mult == 0.5
    with pytest.raises(MXNetError, match="mx.sym"):
        p.var()


def test_gluon_utils_match_jax():
    """split_data, split_and_load, clip_global_norm, check_sha1 and
    download, against the JAX ``gluon.utils``."""
    from incubator_mxnet_tpu.gluon import utils as jutils
    rng = onp.random.RandomState(4)
    a = rng.randn(7, 4).astype("float32")
    for kw in (dict(num_slice=1), dict(num_slice=3, even_split=False),
               dict(num_slice=2, batch_axis=1)):
        got = gluon.utils.split_data(nd.array(a), **kw)
        want = jutils.split_data(jmx.nd.array(a), **kw)
        assert [g.asnumpy().tolist() for g in got] == \
            [w.asnumpy().tolist() for w in want], kw
    with pytest.raises(ValueError, match="evenly split"):
        gluon.utils.split_data(nd.array(a), 3)
    parts = gluon.utils.split_and_load(a[:6], [mx.cpu(0), mx.cpu(0)])
    assert [p.shape for p in parts] == [(3, 4), (3, 4)]
    assert onp.array_equal(parts[1].asnumpy(), a[3:6])
    for scale in (10.0, 0.1):
        arrays = [scale * rng.randn(*s).astype("float32")
                  for s in ((3, 4), (5,), (2, 2, 2))]
        pa = [nd.array(v) for v in arrays]
        ja = [jmx.nd.array(v) for v in arrays]
        n_got = gluon.utils.clip_global_norm(pa, 1.0)
        n_want = jutils.clip_global_norm(ja, 1.0)
        assert isinstance(n_got, float)
        assert abs(n_got - n_want) <= 1e-6 * n_want
        for g, w in zip(pa, ja):
            onp.testing.assert_allclose(g.asnumpy(), w.asnumpy(),
                                        rtol=1e-6, atol=1e-7)
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "data.bin")
        with open(f, "wb") as fh:
            fh.write(b"port" * 1000)
        sha = hashlib.sha1(b"port" * 1000).hexdigest()
        assert gluon.utils.check_sha1(f, sha)
        assert not gluon.utils.check_sha1(f, "0" * 40)
        assert gluon.utils.download("http://host/data.bin", path=d,
                                    sha1_hash=sha) == f
        with pytest.raises(MXNetError, match="not fetched"):
            gluon.utils.download("http://host/other.bin", path=d)


def test_sparse_embedding_and_estimator():
    """SparseEmbedding equals the JAX one (dense gradients); Estimator.fit
    with its handlers learns, and its checkpoint loads in the JAX
    package."""
    from incubator_mxnet_tpu.gluon.contrib import nn as jcnn
    from incubator_mxnet_tpu_torch.gluon.contrib import estimator as est
    ids = onp.array([[1, 3, 3], [0, 2, 9]], "float32")
    pe = gluon.contrib.nn.SparseEmbedding(10, 4, prefix="se_")
    pe.initialize()
    je = jcnn.SparseEmbedding(10, 4, prefix="se_")
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "se.params")
        pe.save_parameters(f)
        je.load_parameters(f)
    a = nd.array(ids)
    with autograd.record():
        y = pe(a)
        y.sum().backward()
    onp.testing.assert_allclose(y.asnumpy(), je(jmx.nd.array(ids))
                                .asnumpy(), rtol=0, atol=0)
    g = pe.weight.grad().asnumpy()
    assert g[3].tolist() == [2.0] * 4 and g[4].tolist() == [0.0] * 4

    rng = onp.random.RandomState(5)
    X = rng.randn(64, 6).astype("float32")
    Y = (X[:, 0] > 0).astype("float32")
    mx.random.seed(1)
    net = gluon.nn.HybridSequential(prefix="estnet_")
    with net.name_scope():
        net.add(gluon.nn.Dense(8, activation="relu", in_units=6))
        net.add(gluon.nn.Dense(2, in_units=8))
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.05})
    e = gluon.contrib.Estimator(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                trainer=trainer)
    data = mx.io.NDArrayIter(X, Y, batch_size=16)
    with tempfile.TemporaryDirectory() as d:
        ck = est.CheckpointHandler(d, "m")
        stop = est.EarlyStoppingHandler(monitor="accuracy", mode="max",
                                        patience=10)
        e.fit(data, val_data=data, epochs=4,
              event_handlers=[ck, stop, est.LoggingHandler(2)])
        assert len(ck.saved) == 4 and all(os.path.exists(p)
                                          for p in ck.saved)
        jnet = jmx.gluon.nn.HybridSequential(prefix="estnet_")
        with jnet.name_scope():
            jnet.add(jmx.gluon.nn.Dense(8, activation="relu", in_units=6))
            jnet.add(jmx.gluon.nn.Dense(2, in_units=8))
        jnet.load_parameters(ck.saved[-1])
    acc = dict(e.evaluate(data))["accuracy"]
    assert acc > 0.85, acc
    onp.testing.assert_allclose(jnet(jmx.nd.array(X)).asnumpy(),
                                net(nd.array(X)).asnumpy(), atol=1e-5)


def _jax_example(name):
    path = os.path.join(REPO, "examples", name)
    spec = importlib.util.spec_from_file_location("_jax_" + name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dcgan_example_matches_jax():
    """``dcgan_example`` against the JAX example's loop for 3 steps."""
    from incubator_mxnet_tpu import optimizer as jopt
    ex = _jax_example("dcgan.py")
    latent, B, steps = 8, 6, 3
    with tempfile.TemporaryDirectory() as d:
        fg, fd = os.path.join(d, "g.params"), os.path.join(d, "d.params")
        mx.random.seed(2)
        pg, pd = dcgan.build_generator(latent), dcgan.build_discriminator()
        pg.initialize(init.Normal(0.02))
        pd.initialize(init.Normal(0.02))
        pg.save_parameters(fg)
        pd.save_parameters(fd)
        got = dcgan.dcgan_example(latent=latent, batch_size=B, steps=steps,
                                  params_g=fg, params_d=fd, ctx=mx.cpu())
        # the JAX nets stay uninitialised: their traced runs read the
        # port's initial values by name (sparing a compile per shape)
        jg, jd = ex.build_generator(latent), ex.build_discriminator()
    rng = onp.random.RandomState(11)
    feeds = []
    for _ in range(steps):
        real = ex.real_batch(rng, B)
        z1 = rng.randn(B, latent).astype("float32")
        z2 = rng.randn(B, latent).astype("float32")
        feeds.append((real, z1, z2))
    gp = [p for _, p in sorted(jg.collect_params().items())]
    dp = [p for _, p in sorted(jd.collect_params().items())]
    g_train = [p.grad_req != "null" for p in gp]
    d_train = [p.grad_req != "null" for p in dp]
    loss_fn = jmx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones = jnp.ones((B, 1), jnp.float32)
    zeros = jnp.zeros((B, 1), jnp.float32)

    def traced(gv, dv, fn):
        proxies = {id(p): jmx.nd.NDArray(v) for p, v in
                   zip(gp + dp, list(gv) + list(dv))}
        with _jax_trace(proxies, train=True):
            return fn()._data

    def lossD(dv, gv, real, z):
        def fn():
            fake = jmx.nd.NDArray(jax.lax.stop_gradient(
                jg(jmx.nd.NDArray(z))._data))
            return (loss_fn(jd(jmx.nd.NDArray(real)), jmx.nd.NDArray(ones))
                    + loss_fn(jd(fake), jmx.nd.NDArray(zeros))).mean()
        return traced(gv, dv, fn)

    def lossG(gv, dv, z):
        return traced(gv, dv, lambda: loss_fn(
            jd(jg(jmx.nd.NDArray(z))), jmx.nd.NDArray(ones)).mean())

    def adam(vals, grads, states, train, t):
        o = jopt.create("adam", learning_rate=2e-4, beta1=0.5)
        new_v, new_s = [], []
        for v, g, s, tr in zip(vals, grads, states, train):
            if tr:
                v, s = o.step(v, g, s, 2e-4, 0.0, t)
            new_v.append(v)
            new_s.append(s)
        return new_v, new_s

    def step(gv, dv, gs, ds, t, real, z1, z2):
        ld, dgrad = jax.value_and_grad(lossD)(dv, gv, real, z1)
        dv, ds = adam(dv, dgrad, ds, d_train, t)
        lg, ggrad = jax.value_and_grad(lossG)(gv, dv, z2)
        gv, gs = adam(gv, ggrad, gs, g_train, t)
        return gv, dv, gs, ds, ld, lg

    start = {k: p.data().asnumpy() for net in (pg, pd)
             for k, p in net.collect_params().items()}
    gv = [start[p.name] for p in gp]
    dv = [start[p.name] for p in dp]
    gs = [(onp.zeros_like(v), onp.zeros_like(v)) for v in gv]
    ds = [(onp.zeros_like(v), onp.zeros_like(v)) for v in dv]
    compiled, want = None, []
    for t, feed in enumerate(feeds, 1):
        args = (gv, dv, gs, ds, jnp.int32(t)) + feed
        if compiled is None:
            compiled = jax.jit(step).lower(*args).compile(FAST_COMPILE)
        gv, dv, gs, ds, ld, lg = compiled(*args)
        want.append((float(ld), float(lg)))
    onp.testing.assert_allclose(got["lossD"], [a for a, _ in want],
                                rtol=0, atol=1e-4)
    onp.testing.assert_allclose(got["lossG"], [b for _, b in want],
                                rtol=0, atol=1e-4)
