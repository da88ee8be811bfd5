"""PyTorch port: ``mx.io``'s ``NDArrayIter``, ``mx.metric`` and the Gluon
LeNet loop, held against the JAX package on the CPU.

The iterators and metrics are host-side numpy in both packages: batches
and metric values must be equal (metrics rtol 1e-6). The LeNet loop is
the port of ``tests/test_train.py::test_lenet_gluon_converges_digits``:
data iterator -> hybridized conv net -> autograd -> Trainer -> metric, on
sklearn's bundled 8x8 digits, held-out accuracy >= 0.95 as there.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import metric as jmetric
from incubator_mxnet_tpu import models as jmodels

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, io, metric, models, nd


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


def _epochs(it, n):
    """``n`` epochs of ``it``: each batch's data, label and pad."""
    out = []
    for _ in range(n):
        it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return out


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    """The same batches, pads and epoch boundaries as the JAX iterator,
    shuffled from the same numpy seed; the arrays are ``mx.nd`` arrays on
    the current context."""
    x = onp.arange(23 * 3, dtype="float32").reshape(23, 3)
    y = onp.arange(23, dtype="float32")
    onp.random.seed(5)
    want = _epochs(jio.NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                                   last_batch_handle=handle), 3)
    onp.random.seed(5)
    it = io.NDArrayIter(x, y, batch_size=5, shuffle=shuffle,
                        last_batch_handle=handle)
    got = _epochs(it, 3)
    assert [len(e) for e in got] == [len(e) for e in want]
    for eg, ew in zip(got, want):
        for (gx, gy, gp), (wx, wy, wp) in zip(eg, ew):
            onp.testing.assert_array_equal(gx, wx)
            onp.testing.assert_array_equal(gy, wy)
            assert gp == wp
    assert it.provide_data == [io.DataDesc("data", (5, 3), x.dtype)]
    assert it.provide_label[0].name == "softmax_label"
    it.reset()
    batch = next(iter(it))
    assert isinstance(batch.data[0], nd.NDArray)
    assert batch.data[0].context == mx.cpu()


def test_ndarray_iter_dicts_and_errors():
    it = io.NDArrayIter({"a": onp.zeros((4, 2)), "b": onp.ones((4, 1))},
                        batch_size=2)
    assert [d.name for d in it.provide_data] == ["a", "b"]
    assert len(next(it).data) == 2
    with pytest.raises(mx.MXNetError, match="dim 0"):
        io.NDArrayIter(onp.zeros((4, 2)), onp.zeros(3))


def _metric_inputs(seed=0):
    rng = onp.random.RandomState(seed)
    pred = rng.rand(12, 4).astype("float32")
    pred /= pred.sum(axis=1, keepdims=True)
    label = rng.randint(0, 4, (12,)).astype("float32")
    bpred = rng.rand(12, 2).astype("float32")
    blabel = rng.randint(0, 2, (12,)).astype("float32")
    reg = rng.randn(12, 1).astype("float32")
    return pred, label, bpred, blabel, reg


METRICS = [
    ("acc", {}, "cls"), ("topkaccuracy", {"top_k": 2}, "cls"),
    ("f1", {}, "bin"), ("mcc", {}, "bin"), ("mae", {}, "reg"),
    ("mse", {}, "reg"), ("rmse", {}, "reg"), ("ce", {}, "cls"),
    ("nll_loss", {}, "cls"), ("perplexity", {}, "cls"),
    ("pearsoncorrelation", {}, "reg"), ("loss", {}, "reg"),
    ("percentile", {"q": (50, 90)}, "reg"),
]


@pytest.mark.parametrize("name,kw,kind", METRICS)
def test_metrics_match_jax(name, kw, kind):
    """Each metric by name, two updates (NDArrays, then numpy), equal to
    the JAX metric's value; ``reset`` empties it."""
    pred, label, bpred, blabel, reg = _metric_inputs()
    if kind == "cls":
        p, l = pred, label
    elif kind == "bin":
        p, l = bpred, blabel
    else:
        p, l = reg[:, 0] + 0.1, reg[:, 0]
    jm = jmetric.create(name, **kw)
    tm = metric.create(name, **kw)
    for m, pkg in ((jm, jmx), (tm, mx)):
        m.update([pkg.nd.array(l[:6])], [pkg.nd.array(p[:6])])
        m.update([l[6:]], [p[6:]])
    (gn, gv), (wn, wv) = tm.get(), jm.get()
    assert gn == wn
    onp.testing.assert_allclose(gv, wv, rtol=1e-6)
    assert tm.get_name_value() == [(n, v) for n, v in zip(
        *([gn], [gv]) if isinstance(gn, str) else (gn, gv))]
    tm.reset()
    assert onp.isnan(onp.asarray(tm.get()[1], dtype=float)).all()


def test_metric_create_forms():
    """A list gives a composite, a function a custom metric, an unknown
    name an error listing the known ones."""
    pred, label, *_ = _metric_inputs(1)
    comp = metric.create(["acc", metric.TopKAccuracy(top_k=2)])
    assert isinstance(comp, metric.CompositeEvalMetric)
    custom = metric.create(lambda l, p: float((p.argmax(1) == l).mean()))
    jcomp = jmetric.create(["acc", jmetric.TopKAccuracy(top_k=2)])
    for m in (comp, custom, jcomp):
        m.update([label], [pred])
    names, vals = comp.get()
    assert names == ["accuracy", "top_k_accuracy_2"]
    onp.testing.assert_allclose(vals, jcomp.get()[1], rtol=1e-6)
    assert custom.get()[1] == vals[0]
    assert metric.create(custom) is custom
    with pytest.raises(mx.MXNetError, match="accuracy"):
        metric.create("nope")
    acc = metric.Accuracy()
    acc.update(torch.tensor([1.0, 0.0]), torch.tensor([[0.2, 0.8],
                                                       [0.3, 0.7]]))
    assert acc.get() == ("accuracy", 0.5)


def test_lenet_matches_jax():
    """``models.LeNet``: the reference's layers, parameter names and
    logits on the same weights."""
    x = onp.random.RandomState(3).rand(2, 1, 28, 28).astype("float32")
    jnet = jmodels.lenet.lenet(classes=10)
    jnet.initialize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    net = models.lenet.lenet(classes=10)
    net.initialize()
    assert net(nd.array(x)).shape == (2, 10)
    n, jn = len(net.prefix), len(jnet.prefix)
    assert sorted(k[n:] for k in net.collect_params()) == sorted(
        k[jn:] for k in jnet.collect_params())
    from incubator_mxnet_tpu_torch.convert import params_from_jax
    params_from_jax(net, {k: p.data().asnumpy()
                          for k, p in jnet.collect_params().items()})
    onp.testing.assert_allclose(net(nd.array(x)).asnumpy(), want, atol=1e-5)


def _digits():
    pytest.importorskip("sklearn")
    from sklearn.datasets import load_digits
    d = load_digits()
    X = d.images.astype("float32")[:, None] / 16.0      # (N, 1, 8, 8)
    Y = d.target.astype("float32")
    # shuffled split: the dataset's tail block is a different writer cohort
    idx = onp.random.RandomState(42).permutation(len(X))
    X, Y = X[idx], Y[idx]
    n = 1500
    return X[:n], Y[:n], X[n:], Y[n:]


def test_lenet_gluon_converges_digits():
    """The reference's stage-4 gate in the port: data iter -> hybridized
    conv net -> autograd -> Trainer -> metric, accuracy >= 0.95 held
    out."""
    Xtr, Ytr, Xte, Yte = _digits()
    mx.random.seed(42)
    onp.random.seed(42)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(16, 3, padding=1, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(128, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 3e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    it = io.NDArrayIter(Xtr, Ytr, batch_size=100, shuffle=True,
                        last_batch_handle="discard")
    for epoch in range(10):
        it.reset()
        for batch in it:
            with autograd.record():
                out = net(batch.data[0])
                loss = loss_fn(out, batch.label[0]).mean()
            loss.backward()
            trainer.step(100)
    acc = metric.Accuracy()
    with autograd.predict_mode():
        acc.update(nd.array(Yte), net(nd.array(Xte)))
    assert acc.get()[1] >= 0.95, f"held-out accuracy {acc.get()[1]}"


def test_digits_copy_matches_sklearn():
    """``chip_data/digits.npz``, the LeNet gate's data on the card (which
    has no sklearn), is sklearn's bundled digits, value for value."""
    pytest.importorskip("sklearn")
    import os
    from sklearn.datasets import load_digits
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = onp.load(os.path.join(repo, "chip_data", "digits.npz"))
    d = load_digits()
    onp.testing.assert_array_equal(data["images"], d.images)
    onp.testing.assert_array_equal(data["target"], d.target)
