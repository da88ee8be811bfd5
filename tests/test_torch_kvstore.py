"""PyTorch port: ``mx.kv`` and the kvstore seams of ``gluon.Trainer`` and
``Module`` held against the JAX package on the CPU.

The store cases are the ports of ``tests/test_kvstore.py``'s (not its
``dist_async``, row-sparse storage or ``bincount`` ones), run on both
packages with the same inputs; the two-process ``dist_sync`` case is the
port of ``tests/dist_sync_kvstore_worker.py`` in two spawned gloo ranks
(``tests/torch_dist_worker.py``). Every value is exact (sums of small
integers, one SGD step in float32) but the training steps, held to
rtol 1e-6.
"""
import numpy as onp
import pytest
import torch

import torch_dist_worker as W

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store_cases(lib):
    """Every single-process store case of ``tests/test_kvstore.py`` on
    ``lib``; returns the pulled values in order."""
    nd, out = lib.nd, []
    kv = lib.kv.create("local")
    kv.init(3, nd.ones((2, 3)))
    out.append(kv.pull(3).asnumpy())
    kv.push(3, nd.full((2, 3), 4.0))
    out.append(kv.pull(3).asnumpy())
    kv = lib.kv.create("device")
    kv.init("w", nd.zeros((4,)))
    kv.push("w", [nd.ones((4,)), nd.ones((4,)) * 2, nd.ones((4,)) * 3])
    out.append(kv.pull("w").asnumpy())
    kv = lib.kv.create("local")
    kv.init(0, nd.ones((3,)))
    kv.push(0, nd.full((3,), 2.0))
    a, b = nd.zeros((3,)), nd.zeros((3,))
    kv.pull(0, out=[a, b])
    out += [a.asnumpy(), b.asnumpy()]
    kv = lib.kv.create("local")
    keys = [5, 7, 9]
    kv.init(keys, [nd.ones((2,))] * 3)
    kv.push(keys, [nd.full((2,), float(i)) for i in range(3)])
    out += [o.asnumpy() for o in kv.pull(keys)]
    kv = lib.kv.create("local")
    kv.init("w", nd.ones((2,)))

    def sgd(key, grad, weight):
        weight[:] = weight - 0.1 * grad

    kv.set_updater(sgd)
    kv.push("w", nd.ones((2,)))
    out.append(kv.pull("w").asnumpy())
    kv = lib.kv.create("dist_sync")   # one process: local semantics
    kv.init(0, nd.ones((3,)))
    kv.set_optimizer(lib.optimizer.create("sgd", learning_rate=0.5))
    kv.push(0, nd.ones((3,)))
    out.append(kv.pull(0).asnumpy())
    out.append((kv.rank, kv.num_workers, kv.type))
    return out


def test_store_cases_match_jax():
    with mx.cpu():
        got = _store_cases(mx)
    want = _store_cases(jmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g == w
        else:
            onp.testing.assert_allclose(g, w, rtol=1e-6)


def _compression_cases(lib):
    nd, out = lib.nd, []
    kv = lib.kv.create("nccl")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init(0, nd.zeros((4,)))
    kv.push(0, nd.array(onp.array([0.7, -0.9, 0.1, 0.0], "float32")))
    out.append(kv.pull(0).asnumpy())
    kv = lib.kv.create("nccl")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("g", nd.zeros((1,)))
    for _ in range(5):
        kv.push("g", nd.array(onp.array([0.2], "float32")))
        out.append(kv.pull("g").asnumpy())
    for bad in ({"type": "fancy"}, {"threshold": 0.25}):
        with pytest.raises(lib.MXNetError):
            lib.kv.create("nccl").set_gradient_compression(bad)
    return out


def test_gradient_compression_matches_jax():
    """2-bit quantisation to {-t, 0, t} and the residual carried into
    later pushes (5 x 0.2 delivers 1.0 in total), the same pulls as the
    JAX store's; unknown and untyped compressions raise in both."""
    with mx.cpu():
        got = _compression_cases(mx)
    want = _compression_cases(jmx)
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g, w)
    assert abs(sum(float(g[0]) for g in got[1:]) - 1.0) <= 0.5 + 1e-6


def _row_sparse_cases(lib):
    nd, out = lib.nd, []
    kv = lib.kv.create("local")
    w = onp.arange(12, dtype="float32").reshape(4, 3)
    kv.init("emb", nd.array(w))
    o = nd.zeros((4, 3))
    kv.row_sparse_pull("emb", out=o, row_ids=nd.array(
        onp.array([0, 2], "float32")))
    out.append(o.asnumpy())
    with pytest.raises(lib.MXNetError):
        kv.row_sparse_pull("emb", row_ids=nd.array([0.0]))
    kv.init("e2", nd.array(w[:, :2].copy()))
    o1, o2 = nd.zeros((4, 2)), nd.zeros((4, 2))
    kv.row_sparse_pull("e2", out=[o1, o2],
                       row_ids=[nd.array([0.0]), nd.array([3.0])])
    out += [o1.asnumpy(), o2.asnumpy()]
    with pytest.raises(lib.MXNetError):
        kv.row_sparse_pull("e2", out=[o1, o2], row_ids=[nd.array([0.0])] * 3)
    return out


def test_row_sparse_pull_and_names_match_jax():
    """``row_sparse_pull`` on dense storage (the named rows, zeros
    elsewhere; one key's row sets paired with its outs); ``create``'s
    names and refusals: an unknown name raises in both, ``dist_async``
    names item 7c here."""
    with mx.cpu():
        got = _row_sparse_cases(mx)
    for g, w in zip(got, _row_sparse_cases(jmx)):
        onp.testing.assert_array_equal(g, w)
    for name in ("local", "device", "nccl", "dist_sync", "dist_device_sync",
                 "horovod"):
        assert mx.kv.create(name).type == jmx.kv.create(name).type
    for lib in (mx, jmx):
        with pytest.raises(lib.MXNetError):
            lib.kv.create("no_such_backend")
    with pytest.raises(MXNetError, match="7c"):
        mx.kv.create("dist_async")

    @mx.kv.register("mine")
    class Mine(mx.kv.KVStoreBase):
        pass

    try:
        assert isinstance(mx.kv.create("mine"), Mine)
    finally:
        mx.kv._REGISTRY.pop("mine")


def _train(lib, kvstore, compression, steps=3):
    """Three SGD steps of a Dense layer through ``gluon.Trainer`` with
    ``kvstore``; the weights after each."""
    nd, out = lib.nd, []
    net = lib.gluon.nn.Dense(2, in_units=3)
    net.initialize(lib.init.Constant(0.3))
    kv = lib.kv.create("local") if kvstore == "object" else kvstore
    tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore=kv,
                           compression_params=compression)
    x = nd.array(onp.linspace(-1, 1, 12).reshape(4, 3).astype("float32"))
    for _ in range(steps):
        with lib.autograd.record():
            loss = ((net(x) - 0.5) ** 2).sum()
        loss.backward()
        tr.step(4)
        out.append(net.weight.data().asnumpy())
    return out, (tr._kvstore is None)


@pytest.mark.parametrize("kvstore,compression", [
    ("object", None), ("dist_sync", None),
    ("device", {"type": "2bit", "threshold": 0.05})])
def test_gluon_trainer_kvstores_match_jax(kvstore, compression):
    """``gluon.Trainer`` with a ``KVStore`` object, a ``dist_sync`` name
    and a compression on the default store: the JAX Trainer's weights
    after each step, and the same store taken (or none)."""
    with mx.cpu():
        got, none = _train(mx, kvstore, compression)
    want, jnone = _train(jmx, kvstore, compression)
    assert none == jnone
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-6)


def test_dist_sync_two_processes():
    """Two gloo ranks: ``dist_sync`` sums the pushes of both (one key, a
    key batch, after a barrier), updates on the store with the sum, and
    ``gluon.Trainer`` and ``Module`` with ``kvstore="dist_sync"`` on each
    rank's rows give the one-process step on all rows."""
    res = W.run_ranks("dist_sync_case", 2)
    with mx.cpu():
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize(mx.init.Constant(0.1))
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        x = mx.nd.array(onp.arange(12.0).reshape(4, 3))
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(4)
        sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                                    name="fc")
        sym = mx.sym.LinearRegressionOutput(sym, mx.sym.Variable("lin_label"),
                                            name="lin")
        mod = mx.module.Module(sym, label_names=["lin_label"],
                               context=mx.cpu())
        mod.bind([("data", (4, 3))], [("lin_label", (4, 2))])
        mod.init_params(mx.init.Constant(0.1))
        mod.init_optimizer(optimizer="sgd", optimizer_params=(
            ("learning_rate", 0.1), ("rescale_grad", 0.5)))
        mod.forward(mx.io.DataBatch([x], [mx.nd.zeros((4, 2))]),
                    is_train=True)
        mod.backward()
        mod.update()
        module_w = mod.get_params()[0]["fc_weight"].asnumpy()
    for rank, o in enumerate(res):
        assert o["who"] == (rank, 2, "dist_sync")
        onp.testing.assert_array_equal(o["one"], onp.full((4, 2), 3.0))
        onp.testing.assert_array_equal(o["batch"][0], onp.full(3, 3.0))
        onp.testing.assert_array_equal(o["batch"][1], onp.full(3, 6.0))
        onp.testing.assert_array_equal(o["again"], onp.full((4, 2), 2.0))
        onp.testing.assert_allclose(o["updated"], onp.full(3, -0.5))
        onp.testing.assert_allclose(o["trainer"],
                                    net.weight.data().asnumpy(), rtol=1e-6)
        onp.testing.assert_allclose(o["module"], module_w, rtol=1e-6)
