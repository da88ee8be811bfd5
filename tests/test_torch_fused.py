"""PyTorch port: the fused training step and the hybridized Gluon loop held
against the JAX package on the CPU.

The fused ``ShardedTrainer`` step is one function over static buffers; on
the card it is captured into a CUDA graph (``tests/test_torch_cuda.py``),
here it runs uncaptured (``_fused_step(..., capture=False)``), the same
function. Held against the port's eager step and against the JAX
``ShardedTrainer(fused=True)`` at ``bert_2_128_2``, dropout 0, float32,
the same weights (``convert.params_from_jax``), 3 steps of AdamW and of SGD
with momentum: losses and gradient norms rtol 1e-6, ``last_path``,
``num_update`` and the finite verdict; every parameter after the steps
atol 1e-5 against the eager step (AdamW and SGD) and, after the SGD steps,
against JAX (GEMM and attention summation order through 3 updates). After
AdamW steps the weights are not compared across the two packages: the key
bias's gradient is zero in exact arithmetic (a softmax does not see a
constant added to a row), so each package's is rounding noise, and Adam
turns noise of either sign into a full step of ``lr`` (up to 8e-4 here); an
SGD update is proportional to its gradient. On the card the fused and
eager AdamW steps give the same bits (``tests/test_torch_cuda.py``). A
hybridized port BERT (its eager forward on the CPU: the same function as
its graphs on the card) against the JAX package's hybridized (jitted)
BERT: outputs and one ``loss.backward()``'s gradients atol 1e-5, then two
``Trainer.step``s on the multi-tensor update, losses atol 1e-4 (as
``tests/test_torch_gluon.py``). Each JAX trainer is built once (a module
fixture, one per optimizer).
"""
import jax
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import models as jax_models
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.fault.guards import StepGuard
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import lr_scheduler, models, parallel
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import jax_suffixes, params_from_jax

VOCAB, L, B, P = 400, 32, 4, 5
LR, STEPS = 1e-3, 3
#: optimizer -> its parameters, in both packages
OPTIMIZERS = {"adamw": {"learning_rate": LR},
              "sgd": {"learning_rate": 0.05, "momentum": 0.9}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = onp.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, L)).astype("int32")
    tt = rng.randint(0, 2, (B, L)).astype("int32")
    vl = onp.array([L, 20, 7, 1], "float32")
    pos = rng.randint(0, L, (B, P)).astype("int32")
    lab = rng.randint(0, VOCAB, (B, P)).astype("float32")
    w = onp.ones((B, P), "float32")
    w[1, -1] = 0.0
    nsp = rng.randint(0, 2, (B,)).astype("float32")
    return ids, tt, vl, pos, lab, w, nsp


@pytest.fixture(scope="module", params=sorted(OPTIMIZERS))
def jax_fused(request):
    """The JAX ``ShardedTrainer(fused=True)`` with ``request.param``:
    initial weights, then per step the loss and gradient norm (a ``warn``
    guard reads them), and the weights after ``STEPS`` steps."""
    name = request.param
    batch = _batch()
    net = jax_models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                              dropout=0.0, dtype="float32")
    jmx.random.seed(0)
    net.initialize()
    net(*(jmx.nd.array(x) for x in batch[:4]))
    arrays = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    guard = StepGuard("warn")
    tr = jax_parallel.ShardedTrainer(
        net, jax_models.bert_pretrain_loss, name, OPTIMIZERS[name],
        mesh=jax_parallel.make_mesh(devices=jax.devices()[:1]), n_labels=3,
        fused=True, guard=guard)
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(tr.step(*batch).asnumpy()))
        norms.append(tr.last_grad_norm)
    tr.sync_to_block()
    return {"optimizer": name, "batch": batch, "arrays": arrays,
            "losses": losses,
            "norms": norms, "tripped": guard.tripped,
            "num_update": tr.num_update, "graphs": tr.last_step_graphs,
            "weights": {k: p.data().asnumpy()
                        for k, p in net.collect_params().items()}}


def _port(jax_run, fused: bool, **opt):
    """The port's trainer from the JAX run's weights and optimizer: per
    step the loss and gradient norm, through the fused function
    (uncaptured) or the eager step."""
    arrays, batch = jax_run["arrays"], jax_run["batch"]
    name = jax_run["optimizer"]
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                          dropout=0.0, device="cpu")
    params_from_jax(net, arrays)
    tr = parallel.ShardedTrainer(net, models.bert_pretrain_loss, name,
                                 dict(OPTIMIZERS[name], **opt),
                                 device="cpu", n_labels=3)
    losses, norms, finite = [], [], []
    for _ in range(STEPS):
        if fused:
            if tr._params is None:
                tr._init_state()
            loss = tr._fused_step(tr.place(*batch), capture=False)
        else:
            loss = tr.step(*batch)
        losses.append(float(loss))
        norms.append(tr.last_grad_norm)
        finite.append(tr.last_finite)
    return {"net": net, "trainer": tr, "losses": losses, "norms": norms,
            "finite": finite}


@pytest.fixture(scope="module")
def port_runs(jax_fused):
    return {fused: _port(jax_fused, fused) for fused in (True, False)}


def test_fused_function_matches_eager_step(port_runs):
    f, e = port_runs[True], port_runs[False]
    assert f["trainer"].last_path == "fused"
    assert e["trainer"].last_path == "eager"
    assert f["trainer"].last_step_graphs == e["trainer"].last_step_graphs \
        == 0
    onp.testing.assert_allclose(f["losses"], e["losses"], rtol=1e-6)
    onp.testing.assert_allclose(f["norms"], e["norms"], rtol=1e-6)
    assert f["finite"] == e["finite"] == [True] * STEPS
    ep = dict(e["net"].named_parameters())
    for name, p in f["net"].named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(),
                                    ep[name].detach().numpy(), atol=1e-5,
                                    err_msg=name)
        torch.testing.assert_close(p.grad, ep[name].grad, atol=1e-5,
                                   rtol=1e-5)
    for tr in (f["trainer"], e["trainer"]):
        assert tr.num_update == STEPS and tr._optimizer.num_update == STEPS


def test_fused_function_matches_jax_fused(jax_fused, port_runs):
    f = port_runs[True]
    onp.testing.assert_allclose(f["losses"], jax_fused["losses"], rtol=1e-6)
    onp.testing.assert_allclose(f["norms"], jax_fused["norms"], rtol=1e-6)
    assert jax_fused["tripped"] == 0 and f["finite"] == [True] * STEPS
    assert f["trainer"].num_update == jax_fused["num_update"] == STEPS
    assert jax_fused["graphs"] == 1
    if jax_fused["optimizer"] != "sgd":
        return
    suffix = jax_suffixes(f["net"])
    got = {suffix[n]: p.detach().numpy() for n, p in
           f["net"].named_parameters()}
    assert len(got) == len(jax_fused["weights"])
    for name, want in jax_fused["weights"].items():
        key = next(s for s in got if name.endswith("_" + s))
        onp.testing.assert_allclose(got[key], want, atol=1e-5, err_msg=name)


def test_fused_function_folds_the_schedule(jax_fused):
    """With a scheduler the fused function reads it on the device at
    position t-1 (``torch_lr``), the eager step on the host: one result."""
    runs = [_port(jax_fused, fused,
                  lr_scheduler=lr_scheduler.FactorScheduler(1, 0.5))
            for fused in (True, False)]
    assert runs[0]["trainer"]._lr_fold
    onp.testing.assert_allclose(runs[0]["losses"], runs[1]["losses"],
                                rtol=1e-6)
    plain = _port(jax_fused, True)
    assert runs[0]["losses"][0] == plain["losses"][0]
    assert runs[0]["losses"][2] != plain["losses"][2]


def test_fused_needs_a_card(monkeypatch):
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                          dropout=0.0, device="cpu")
    with pytest.raises(MXNetError, match="fused=True"):
        parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adamw",
                                device="cpu", n_labels=3, fused=True)
    for env in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_STEP", env)
        tr = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adamw",
                                     device="cpu", n_labels=3)
        assert not tr.fused
        tr.step(*_batch())
        assert tr.last_path == "eager" and tr.captures == 0


def _gluon_bert(pkg, **kw):
    zoo = jax_models if pkg is jmx else models
    if pkg is mx:
        kw.setdefault("device", "cpu")
    return zoo.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                        dropout=0.0, prefix="hyb_", **kw)


def _hybrid_loop(pkg, net, batch):
    """``net.hybridize()``; the outputs and gradients of the third recorded
    forward and backward (the JAX package's cached op replays from its
    second call), then 2 ``Trainer.step``s: ``(outputs, grads by
    structural name, losses)``."""
    zoo = jax_models if pkg is jmx else models
    net.hybridize()
    arrays = [pkg.nd.array(a, ctx=pkg.cpu()) for a in batch]
    for _ in range(3):
        with pkg.autograd.record():
            out = net(*arrays[:4])
            loss = zoo.bert_pretrain_loss(out, *arrays[4:])
        loss.backward()
    outs = [o.asnumpy() for o in out]
    grads = {k: p.grad().asnumpy() for k, p in
             net._collect_params_with_prefix().items()}
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": LR})
    losses = []
    for _ in range(2):
        with pkg.autograd.record():
            loss = zoo.bert_pretrain_loss(net(*arrays[:4]), *arrays[4:])
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    return outs, grads, losses


def test_hybridized_gluon_bert_matches_jax():
    batch = _batch()
    jnet = _gluon_bert(jmx)
    jmx.random.seed(0)
    jnet.initialize(ctx=jmx.cpu())
    jnet(*(jmx.nd.array(a) for a in batch[:4]))
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    with mx.cpu():
        pnet = _gluon_bert(mx)
        params_from_jax(pnet, arrays)
        got = _hybrid_loop(mx, pnet, batch)
    want = _hybrid_loop(jmx, jnet, batch)
    for g, w in zip(got[0], want[0]):
        onp.testing.assert_allclose(g, w, atol=1e-5)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        onp.testing.assert_allclose(got[1][k], want[1][k], atol=1e-5,
                                    err_msg=k)
    onp.testing.assert_allclose(got[2], want[2], atol=1e-4)
    # on CPU arrays the hybridized block runs its eager forward: no graph
    assert pnet._active and not pnet._cached_ops
