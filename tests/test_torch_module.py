"""PyTorch port: ``mx.module``, ``mx.model``, ``mx.callback``,
``mx.monitor`` and the ``train_mnist.py`` loop, held against the JAX
package on the CPU.

- ``Module.fit`` for 2 epochs of SGD with momentum and weight decay, from
  the same start parameters, unshuffled: every parameter within 1e-5 of
  the JAX Module's; ``score`` and ``predict`` equal.
- A checkpoint (``prefix-symbol.json`` + ``prefix-0002.params``) written by
  either package loads in the other with equal symbols, names and arrays,
  and predicts the same.
- The Monitor's collected names and statistics are the JAX ones
  (``tests/test_symbol_module.py:182-197``).
- ``models.mnist_example`` with the JAX gate's arguments
  (``tests/test_examples.py:20-26``) reaches accuracy > 0.9, ``mlp`` and
  ``lenet``.
- The symbolic API imports with ``jax`` and the JAX package unimportable;
  the seams of later items raise naming them.
"""
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import monitor as jmonitor

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, models, monitor
from incubator_mxnet_tpu_torch import io as pio
from incubator_mxnet_tpu_torch.base import MXNetError

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_GATE = dict(num_epochs=3, num_synthetic=600, lr=0.05)


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


def _mlp(lib):
    data = lib.sym.Variable("data")
    fc1 = lib.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = lib.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = lib.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return lib.sym.SoftmaxOutput(fc2, lib.sym.Variable("softmax_label"),
                                 name="softmax")


def _data():
    rng = onp.random.RandomState(1)
    X = rng.randn(64, 20).astype("float32")
    Y = (X @ rng.randn(20, 4).astype("float32")).argmax(1).astype("float32")
    start = {"fc1_weight": rng.randn(16, 20).astype("float32") * 0.3,
             "fc1_bias": rng.randn(16).astype("float32") * 0.1,
             "fc2_weight": rng.randn(4, 16).astype("float32") * 0.3,
             "fc2_bias": onp.zeros(4, "float32")}
    return X, Y, start


def _module(lib, io_mod, start, **kw):
    X, Y, _ = _data()
    it = io_mod.NDArrayIter(X, Y, batch_size=16)
    mod = lib.module.Module(_mlp(lib), **kw)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    mod.set_params({k: lib.nd.array(v) for k, v in start.items()})
    return mod, it


@pytest.fixture(scope="module")
def fitted():
    """The JAX and the port Module after 2 epochs from the same start."""
    _, _, start = _data()
    out = {}
    with mx.cpu():
        for name, lib, io_mod, kw in (
                ("jax", jmx, jio, {}),
                ("port", mx, pio, {"context": mx.cpu()})):
            mod, it = _module(lib, io_mod, start, **kw)
            mod.fit(it, num_epoch=2, optimizer="sgd",
                    optimizer_params=(("learning_rate", 0.1),
                                      ("momentum", 0.9), ("wd", 1e-4)),
                    batch_end_callback=[lib.callback.Speedometer(16, 2),
                                        lib.callback.log_train_metric(2)])
            out[name] = (mod, it)
    return out


def test_fit_matches_jax(fitted):
    (jm, _), (pm, _) = fitted["jax"], fitted["port"]
    ja, jaux = jm.get_params()
    pa, paux = pm.get_params()
    assert sorted(pa) == sorted(ja) and paux == {} and jaux == {}
    _, _, start = _data()
    for k in ja:
        assert not onp.allclose(pa[k].asnumpy(), start[k])
        onp.testing.assert_allclose(pa[k].asnumpy(), ja[k].asnumpy(),
                                    rtol=0, atol=ATOL)


def test_score_and_predict_match_jax(fitted):
    (jm, jit), (pm, pit) = fitted["jax"], fitted["port"]
    assert pm.score(pit, "acc") == jm.score(jit, "acc")
    assert pm.score(pit, mx.metric.create("ce")) == pytest.approx(
        jm.score(jit, jmx.metric.create("ce")), abs=ATOL)
    p, j = pm.predict(pit), jm.predict(jit)
    assert p.shape == j.shape == (64, 4) and p.context == mx.cpu()
    onp.testing.assert_allclose(p.asnumpy(), j.asnumpy(), rtol=0, atol=ATOL)


def test_checkpoint_crosses_both_ways(fitted, tmp_path):
    """``save_checkpoint`` (and ``callback.do_checkpoint``) of either
    package: the same symbol JSON and ``.params`` arrays by name, and the
    other package's ``Module.load`` predicts the same."""
    (jm, jit), (pm, pit) = fitted["jax"], fitted["port"]
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    jm.save_checkpoint(jp, 2)
    mx.callback.do_checkpoint(pp, period=2)(1, pm.symbol, *pm.get_params())
    with open(jp + "-symbol.json") as a, open(pp + "-symbol.json") as b:
        assert a.read() == b.read()
    js, jarg, _ = jmx.model.load_checkpoint(pp, 2)
    ps, parg, _ = mx.model.load_checkpoint(jp, 2)
    assert ps.tojson() == js.tojson() == pm.symbol.tojson()
    assert sorted(parg) == sorted(jarg)
    for k in parg:
        onp.testing.assert_allclose(parg[k].asnumpy(), jarg[k].asnumpy(),
                                    rtol=0, atol=ATOL)
    port_of_jax = mx.module.Module.load(jp, 2, context=mx.cpu())
    port_of_jax.bind(pit.provide_data, pit.provide_label,
                     for_training=False)
    port_of_jax.init_params()
    jax_of_port = jmx.module.Module.load(pp, 2)
    jax_of_port.bind(jit.provide_data, jit.provide_label,
                     for_training=False)
    jax_of_port.init_params()
    onp.testing.assert_allclose(port_of_jax.predict(pit).asnumpy(),
                                jm.predict(jit).asnumpy(), rtol=0, atol=ATOL)
    onp.testing.assert_allclose(jax_of_port.predict(jit).asnumpy(),
                                pm.predict(pit).asnumpy(), rtol=0, atol=ATOL)


def test_monitor_matches_jax():
    """``Module.fit(monitor=)`` with ``Monitor(interval=2,
    pattern=".*fc.*")``: the same (batch, name) pairs and statistics."""
    _, _, start = _data()
    got = []
    for lib, io_mod, mon_mod, kw in (
            (jmx, jio, jmonitor, {}),
            (mx, pio, monitor, {"context": mx.cpu()})):
        rng = onp.random.RandomState(0)
        x = rng.randn(64, 20).astype("float32")
        y = (x[:, 0] > 0).astype("float32")
        it = io_mod.NDArrayIter(x, y, batch_size=16,
                                label_name="softmax_label")
        mod = lib.module.Module(_mlp(lib), **kw)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params()
        mod.set_params({k: lib.nd.array(v) for k, v in start.items()})
        mon = mon_mod.Monitor(interval=2, pattern=".*fc.*", sort=True)
        collected = []
        mon.toc_print = lambda m=mon, c=collected: c.extend(m.toc())
        mod.fit(it, num_epoch=1, monitor=mon,
                optimizer_params=(("learning_rate", 0.01),))
        got.append(collected)
    assert [(b, n) for b, n, _ in got[1]] == [(b, n) for b, n, _ in got[0]]
    assert {n for _, n, _ in got[1]} == {"fc1", "fc2"}
    onp.testing.assert_allclose([s for _, _, s in got[1]],
                                [s for _, _, s in got[0]], rtol=1e-5)


@pytest.mark.parametrize("network", ["mlp", "lenet"])
def test_mnist_example_gate(network):
    """The JAX gate (``tests/test_examples.py:20-26``) on the port's
    ``mnist_example``."""
    acc = models.mnist_example(network, ctx=mx.cpu(), **MNIST_GATE)
    assert acc > 0.9, acc


def test_symbolic_api_imports_without_jax():
    """``mx.sym``, ``mx.module`` and ``mx.AttrScope`` with ``jax`` and the
    JAX package unimportable; a symbol built there serializes as here."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['incubator_mxnet_tpu'] = None\n"
            "import incubator_mxnet_tpu_torch as mx\n"
            "from incubator_mxnet_tpu_torch import models\n"
            "assert mx.sym and mx.module and mx.AttrScope and mx.viz\n"
            "print(models.lenet_symbol().tojson())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == models.lenet_symbol().tojson()


def test_seams_raise_naming_their_items():
    """``contrib.sym`` composes ``_contrib_*`` ops (``box_nms`` evaluates
    as ``contrib.nd``'s) and its control flow builds the JAX package's
    ``_foreach`` node (item 7c-1);
    ``optimize_for`` with a backend nobody registered raises the JAX
    "unknown subgraph backend" error; a Monitor on a Gluon block names
    item 8; a distributed kvstore is taken as the JAX Module takes it;
    ``autograd.get_symbol``
    raises as in the JAX package; ``Parameter.var()`` is the JAX
    variable."""
    boxes = onp.random.RandomState(5).rand(1, 6, 6).astype("float32")
    x = mx.sym.Variable("x")
    nms = mx.sym.contrib.box_nms(x, overlap_thresh=0.5, name="nms")
    assert mx.sym.contrib is mx.contrib.sym
    assert nms.tojson() == jmx.sym.contrib.box_nms(
        jmx.sym.Variable("x"), overlap_thresh=0.5, name="nms").tojson()
    onp.testing.assert_array_equal(
        nms.eval(x=mx.nd.array(boxes))[0].asnumpy(),
        mx.nd.contrib.box_nms(mx.nd.array(boxes),
                              overlap_thresh=0.5).asnumpy())
    def body(lib):
        def step(d, s):
            a = lib.sym.broadcast_add(d, s, name="add")
            return a, a
        return step

    outs, _ = mx.contrib.sym.foreach(body(mx), x, mx.sym.Variable("s0"),
                                     name="fe")
    jouts, _ = jmx.contrib.sym.foreach(body(jmx), jmx.sym.Variable("x"),
                                       jmx.sym.Variable("s0"), name="fe")
    assert outs.tojson() == jouts.tojson()
    with pytest.raises(MXNetError, match="unknown subgraph backend"):
        nms.optimize_for("MKLDNN")
    with pytest.raises(MXNetError, match="item 8"):
        monitor.Monitor().install(gluon.nn.Dense(2))
    mod = mx.module.Module(_mlp(mx), context=mx.cpu())
    mod.bind([("data", (4, 20))], [("softmax_label", (4,))])
    jmod = jmx.module.Module(_mlp(jmx), context=jmx.cpu())
    jmod.bind([("data", (4, 20))], [("softmax_label", (4,))])
    for m in (jmod, mod):
        m.init_optimizer(kvstore="dist_sync")
        assert m.optimizer_initialized
    with pytest.raises(MXNetError, match="get_symbol"):
        mx.autograd.get_symbol(mx.nd.ones((2,)))
    p = gluon.Parameter("w", shape=(3, 4))
    j = jmx.gluon.Parameter("w", shape=(3, 4))
    assert p.var() is p.var() and p.var().tojson() == j.var().tojson()
