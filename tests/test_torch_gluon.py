"""PyTorch port: the Gluon core held against the JAX package on the CPU.

Blocks are built under explicit prefixes, so the process-wide name
counters (and the order in which xdist deals files) cannot shift the names.
Checked against the JAX package: deferred shapes and names of a
``HybridSequential``, structural and prefix names of ``bert_2_128_2``,
``gluon.Trainer`` with SGD over 30 steps and with Adam over 4 BERT steps,
``.params`` files in both directions (structural and legacy prefix keys),
the stale-gradient protocol and ``save_states``/``load_states``.
Tolerances: the SGD losses float32 rtol 1e-5 with atol 1e-7 (they fall
from 5.3 to residuals near 1e-5, where the products' other summation
order is 1e-4 relative; observed at most 4.3e-9 absolute); BERT
outputs atol 1e-4 (GEMM and softmax summation order through two layers,
as ``test_torch_bert.py``); the 4 Adam losses of BERT rtol 1e-4 (the same,
through 3 updates). The JAX BERT is built and trained once (a module
fixture).
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import models as jax_models
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, models, nd, parallel
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import params_from_jax

VOCAB, L, B, P = 200, 16, 4, 3
BERT_ATOL = 1e-4


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


def _batch(seed=2):
    rng = onp.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, L)).astype("int32")
    tt = rng.randint(0, 2, (B, L)).astype("int32")
    vl = onp.array([L, 10, 5, 1], "float32")
    pos = rng.randint(0, L, (B, P)).astype("int32")
    lab = rng.randint(0, VOCAB, (B, P)).astype("float32")
    w = onp.ones((B, P), "float32")
    nsp = rng.randint(0, 2, (B,)).astype("float32")
    return ids, tt, vl, pos, lab, w, nsp


def _bert(pkg, **kw):
    zoo = jax_models if pkg is jmx else models
    if pkg is mx:
        kw.setdefault("device", "cpu")
    return zoo.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                        dropout=0.0, prefix="bert_", **kw)


def _adam_losses(pkg, net, batch, steps=4):
    """``steps`` Gluon steps of ``net`` as ``tests/test_models.py:85-106``:
    record, ``bert_pretrain_loss``, backward, ``Trainer.step(1)``."""
    zoo = jax_models if pkg is jmx else models
    arrays = [pkg.nd.array(a) for a in batch]
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = zoo.bert_pretrain_loss(net(*arrays[:4]), *arrays[4:])
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    return losses, trainer


@pytest.fixture(scope="module")
def jax_bert(tmp_path_factory):
    """The JAX BERT, once: its names, initial weights, outputs and
    ``.params`` file, then its 4 Adam losses."""
    d = tmp_path_factory.mktemp("bert")
    jmx.random.seed(0)
    net = _bert(jmx)
    net.initialize(ctx=jmx.cpu())
    batch = _batch()
    out = [o.asnumpy() for o in net(*(jmx.nd.array(a) for a in batch[:4]))]
    pfile = str(d / "jax.params")
    net.save_parameters(pfile)
    rec = {"net": net, "batch": batch, "out": out, "file": pfile,
           "arrays": {k: p.data().asnumpy()
                      for k, p in net.collect_params().items()},
           "structural": list(net._collect_params_with_prefix()),
           "prefixed": list(net.collect_params())}
    rec["losses"], _ = _adam_losses(jmx, net, batch)
    return rec


def _outputs(net, batch):
    with autograd.predict_mode():
        return [o.asnumpy() for o in net(*(nd.array(a) for a in batch[:4]))]


def test_bert_names_match_jax(jax_bert):
    """Structural names (39, the tied ``decoder_tied_weight`` among them)
    and prefix names (38) are the JAX package's, in its order."""
    port = _bert(mx)
    assert list(port._collect_params_with_prefix()) == jax_bert["structural"]
    assert list(port.collect_params()) == jax_bert["prefixed"]
    assert len(jax_bert["structural"]) == 39 and len(
        jax_bert["prefixed"]) == 38
    tied = port._collect_params_with_prefix()
    assert tied["decoder_tied_weight"] is tied["word_embed.weight"]
    # one torch tensor each: the tied weight is not registered twice
    assert len(list(port.parameters())) == 38


def test_bert_params_files_move_both_ways(jax_bert, tmp_path):
    """A JAX ``save_parameters`` file loads into the port with equal
    outputs, a port file into JAX, and legacy prefix-keyed files load."""
    batch = jax_bert["batch"]
    port = _bert(mx, generator=torch.Generator().manual_seed(1))
    port.load_parameters(jax_bert["file"])
    for g, w in zip(_outputs(port, batch), jax_bert["out"]):
        onp.testing.assert_allclose(g, w, atol=BERT_ATOL)
    other = _bert(mx, generator=torch.Generator().manual_seed(2))
    pfile = str(tmp_path / "port.params")
    other.save_parameters(pfile)
    net = jax_bert["net"]
    net.load_parameters(pfile)
    want = [o.asnumpy() for o in net(*(jmx.nd.array(a)
                                       for a in batch[:4]))]
    for g, w in zip(_outputs(other, batch), want):
        onp.testing.assert_allclose(g, w, atol=BERT_ATOL)
    # legacy: prefix names without the block's own prefix
    lfile = str(tmp_path / "legacy.params")
    other.collect_params().save(lfile, strip_prefix=other.prefix)
    port.load_parameters(lfile)
    for a, b in zip(_outputs(port, batch), _outputs(other, batch)):
        onp.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError, match="missing"):
        gluon.nn.Dense(3, in_units=2, prefix="d_").load_parameters(
            pfile, ignore_extra=True)


def test_gluon_bert_adam_steps_match_jax(jax_bert):
    """Four Gluon Adam steps on ``bert_2_128_2`` from the same weights
    (dropout 0): the port's losses are the JAX package's."""
    port = _bert(mx)
    params_from_jax(port, jax_bert["arrays"])
    losses, trainer = _adam_losses(mx, port, jax_bert["batch"])
    onp.testing.assert_allclose(losses, jax_bert["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    # the tied weight is one parameter of the trainer, updated once a step
    assert len(trainer._params) == 38
    assert trainer.optimizer.num_update == 4


def _dense_pair(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu"),
                pkg.gluon.nn.Dense(4))
    return net


def test_hybrid_sequential_deferred_params_match_jax():
    """Deferred ``in_units``: the same keys, the same unknown shapes before
    the first forward and the same shapes after it; equal outputs from
    equal weights."""
    port, ref = _dense_pair(mx), _dense_pair(jmx)
    port.initialize()
    ref.initialize(ctx=jmx.cpu())

    def shapes(net):
        return {k: tuple(v.shape) for k, v in net.collect_params().items()}

    assert shapes(port) == shapes(ref) == {
        "mlp_dense0_weight": (8, 0), "mlp_dense0_bias": (8,),
        "mlp_dense1_weight": (4, 0), "mlp_dense1_bias": (4,)}
    with pytest.raises(gluon.DeferredInitializationError):
        port[0].weight.data()
    x = onp.random.RandomState(3).randn(2, 5).astype("float32")
    want = ref(jmx.nd.array(x))
    port(nd.array(x))
    assert shapes(port) == shapes(ref)
    assert list(port._collect_params_with_prefix()) == list(
        ref._collect_params_with_prefix())
    for k, p in port.collect_params().items():
        p.set_data(nd.array(ref.collect_params()[k].data().asnumpy()))
    got = port(nd.array(x))
    assert isinstance(got, nd.NDArray) and len(port) == 2
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                                atol=1e-6)


def _sgd_losses(pkg):
    """``tests/test_gluon.py:148-163``: ``Dense(1, in_units=4)`` from zeros,
    SGD lr 0.5, ``L2Loss``, 30 steps."""
    net = pkg.gluon.nn.Dense(1, in_units=4, prefix="lin_")
    net.initialize(init="zeros", ctx=pkg.cpu())
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.5})
    loss_fn = pkg.gluon.loss.L2Loss()
    rng = onp.random.RandomState(0)
    x = rng.randn(16, 4).astype("float32")
    w_true = onp.array([[1.0, -2.0, 3.0, 0.5]], dtype="float32")
    xs, ys = pkg.nd.array(x), pkg.nd.array(x @ w_true.T)
    losses = []
    for _ in range(30):
        with pkg.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(16)
        losses.append(float(loss.asnumpy().mean()))
    return losses, net


def test_trainer_sgd_losses_match_jax():
    got, net = _sgd_losses(mx)
    want, _ = _sgd_losses(jmx)
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert got[-1] < got[0] * 0.05
    assert isinstance(net.weight, gluon.Parameter)


def test_trainer_states_and_stale_gradients(tmp_path):
    """``save_states``/``load_states`` restore ``num_update``; a gradient
    no backward wrote since the last step raises ``UserWarning`` in both
    packages, and ``ignore_stale_grad`` skips its update."""
    for pkg in (mx, jmx):
        net = pkg.gluon.nn.Dense(2, in_units=3, prefix="st_")
        net.initialize(ctx=pkg.cpu())
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.1})
        x = pkg.nd.ones((4, 3))
        for _ in range(3):
            with pkg.autograd.record():
                loss = (net(x) * net(x)).sum()
            loss.backward()
            trainer.step(4)
        sfile = str(tmp_path / f"{pkg.__name__}.states")
        trainer.save_states(sfile)
        fresh = pkg.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 0.1})
        fresh.load_states(sfile)
        assert fresh.optimizer.num_update == trainer.optimizer.num_update \
            == 3
        with pytest.raises(UserWarning, match="has not been updated"):
            trainer.step(4)
        before = net.weight.data().asnumpy()
        trainer.step(4, ignore_stale_grad=True)
        onp.testing.assert_array_equal(net.weight.data().asnumpy(), before)
    trainer.set_learning_rate(0.5)
    assert trainer.learning_rate == 0.5


def test_block_surface():
    """Prefix counters, initialize without and with ``force_reinit``,
    ``cast`` keeping LayerNorm in float32, forward hooks, ``hybridize``,
    ``collect_params(select)``, ``zero_grad`` and losses on NDArrays."""
    net = gluon.nn.HybridSequential(prefix="s_")
    with net.name_scope():
        net.add(gluon.nn.Dense(3, in_units=2), gluon.nn.Dense(3, in_units=3),
                gluon.nn.LayerNorm(in_channels=3))
    assert list(net.collect_params(".*gamma")) == ["s_layernorm0_gamma"]
    assert [b.prefix for b in net] == ["s_dense0_", "s_dense1_",
                                       "s_layernorm0_"]
    net.initialize()
    w = net[0].weight.data().asnumpy()
    net.initialize()
    onp.testing.assert_array_equal(net[0].weight.data().asnumpy(), w)
    seen = []
    h = net.register_forward_hook(lambda blk, args, out: seen.append(
        out.shape))
    net.hybridize()
    assert all(b._active for b in net)
    x = nd.array(onp.ones((2, 2), "float32"))
    with autograd.record():
        out = net(x)
    h.detach()
    net(x)
    assert seen == [(2, 3)]
    out.backward(nd.array(onp.random.RandomState(5).randn(2, 3)))
    assert net[0].weight.grad().asnumpy().any()
    net.zero_grad()
    assert not net[0].weight.grad().asnumpy().any()
    net.initialize(mx.init.Constant(0.25), force_reinit=True)
    assert (net[0].weight.data().asnumpy() == 0.25).all()
    net.cast("bfloat16")
    assert str(net[0].weight.data().dtype) == "bfloat16"
    assert str(net[2].gamma.data().dtype) == "float32"
    for kind in ("L1Loss", "L2Loss"):
        a, b = onp.random.RandomState(4).randn(2, 2, 3).astype("float32"), \
            onp.zeros((2, 6), "float32")
        got = getattr(gluon.loss, kind)()(nd.array(a), nd.array(b))
        want = getattr(jmx.gluon.loss, kind)()(jmx.nd.array(a),
                                               jmx.nd.array(b))
        assert isinstance(got, nd.NDArray)
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    rtol=1e-5)


def test_gluon_entry_points_need_a_card(monkeypatch):
    """Without a card, the Gluon entry points without ``ctx`` raise instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with mx.gpu(0):
        net = gluon.nn.Dense(2, in_units=2, prefix="g_")
        with pytest.raises(MXNetError, match="no CUDA device"):
            net.initialize()
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.ones((2, 2))
    net.initialize(ctx=mx.cpu())
    assert net.weight.list_ctx() == [mx.cpu()]


def test_training_flag_drives_dropout():
    """``autograd.is_training()`` is the one training flag: Dropout fires
    under ``record()`` and ``ShardedTrainer.step`` (which runs its forward
    under ``train_mode()``), and not in a forward outside them, whatever
    ``Module.train()`` says."""
    drop = gluon.nn.Dropout(0.5, prefix="dr_")
    x = nd.ones((1000,))
    with autograd.record():
        assert (drop(x).asnumpy() == 0).any()
    assert (drop.train()(x).asnumpy() == 1).all()
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                          dropout=0.5, device="cpu")
    flags = []
    net.register_forward_hook(lambda *a: flags.append(autograd.is_training()))
    tr = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adamw",
                                 device="cpu", n_labels=3)
    tr.step(*_batch())
    ids = torch.from_numpy(_batch()[0])
    with torch.inference_mode():
        a, b = net(ids), net(ids)
    assert flags == [True, False, False] and torch.equal(a[0], b[0])
