"""PyTorch port: the BERT pretraining step held against the JAX package on
the CPU.

The losses, one AdamW step, and the port's ``parallel.ShardedTrainer``
against the JAX ``ShardedTrainer`` on a one-device CPU mesh
(``bench.py:941``), at ``bert_2_128_2`` with dropout 0 and the same weights
(``convert.params_from_jax``). Each JAX trainer is built once per dtype.

Tolerances, float32: the first-step loss and gradient norm rtol 1e-6,
every parameter gradient atol 1e-5 (summation order of the GEMMs and the
attention backward; observed ~4e-7), the first 6 losses atol 1e-4 (the
same, compounded through 5 AdamW steps at lr 1e-3; observed ~1e-6).
bfloat16 with ``multi_precision``: first-step loss and norm rtol 1e-3,
losses atol 5e-3, and every gradient within 2e-2 of its parameter's
largest gradient (about 5 bf16 ulps). The embedding LayerNorm rounds its
output to bf16 on both sides from float32 statistics that may differ in
the last bit, and the JAX step is one jitted graph whose fusions round
elsewhere than an eager forward, which the port follows (observed over
four weight seeds: losses within 1.8e-3, gradients within 1e-2 of the
largest).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import models as jax_models
from incubator_mxnet_tpu import optimizer as jax_optimizer
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu_torch import bench, models, optimizer, parallel
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import jax_suffixes, params_from_jax
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.nn import Dropout, set_dropout_generator

VOCAB, L, B, P = 400, 32, 4, 5
LR = 1e-3


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
    w[1, -1] = 0.0                      # a padding position
    nsp = rng.randint(0, 2, (B,)).astype("float32")
    return ids, tt, vl, pos, lab, w, nsp


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_run(request):
    """The JAX side, once per dtype: initial weights, the first step's loss,
    gradient norm and gradients, and the first 6 losses of its
    ``ShardedTrainer``."""
    dtype = request.param
    batch = _batch()
    net = jax_models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                              dropout=0.0, dtype=dtype)
    mx.random.seed(0)                   # the same weights in every run
    net.initialize()
    net(*(mx.nd.array(x) for x in batch[:4]))
    arrays = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    tr = jax_parallel.ShardedTrainer(
        net, jax_models.bert_pretrain_loss, "adamw",
        {"learning_rate": LR, "multi_precision": dtype == "bfloat16"},
        mesh=jax_parallel.make_mesh(devices=jax.devices()[:1]), n_labels=3)
    tr.prepare(*batch)
    # the trainer's own forward + backward, jitted as its step jits it
    loss, gnorm, grads, _, _ = jax.jit(tr._make_loss_grads(4))(
        tr._param_vals, tr._base_key, jnp.int32(1), *tr.place(*batch))
    names = [n for n, _ in sorted(net.collect_params().items())]
    losses = [float(tr.step(*batch).asnumpy()) for _ in range(6)]
    return {"dtype": dtype, "batch": batch, "arrays": arrays,
            "loss": float(loss), "grad_norm": float(gnorm),
            "grads": {n: onp.asarray(g.astype(jnp.float32))
                      for n, g in zip(names, grads)},
            "losses": losses}


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's trainer from the same weights: first-step gradients and
    norm, and the first 6 losses."""
    dtype = jax_run["dtype"]
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                          dropout=0.0, dtype=dtype, device="cpu")
    params_from_jax(net, jax_run["arrays"])
    tr = parallel.ShardedTrainer(
        net, models.bert_pretrain_loss, "adamw",
        {"learning_rate": LR, "multi_precision": dtype == "bfloat16"},
        device="cpu", n_labels=3)
    losses = [float(tr.step(*jax_run["batch"]))]
    suffix = jax_suffixes(net)
    grads = {suffix[n]: p.grad.float().numpy().copy()
             for n, p in net.named_parameters()}
    out = {"grads": grads, "grad_norm": tr.last_grad_norm,
           "finite": tr.last_finite, "net": net, "trainer": tr}
    losses += [float(tr.step(*jax_run["batch"])) for _ in range(5)]
    out["losses"] = losses
    return out


def test_trainer_first_step_loss_and_norm_match_jax(jax_run, port_run):
    rtol = 1e-6 if jax_run["dtype"] == "float32" else 1e-3
    onp.testing.assert_allclose(port_run["losses"][0], jax_run["loss"],
                                rtol=rtol)
    onp.testing.assert_allclose(port_run["grad_norm"], jax_run["grad_norm"],
                                rtol=rtol)
    assert port_run["finite"] is True


def test_trainer_gradients_match_jax(jax_run, port_run):
    got = port_run["grads"]
    assert len(got) == len(jax_run["grads"])
    for name, want in jax_run["grads"].items():
        suffix = next(s for s in got if name.endswith("_" + s))
        if jax_run["dtype"] == "float32":
            onp.testing.assert_allclose(got[suffix], want, atol=1e-5,
                                        err_msg=name)
        else:
            err = onp.abs(got[suffix] - want).max()
            assert err <= 2e-2 * onp.abs(want).max(), (name, err)


def test_trainer_losses_match_jax(jax_run, port_run):
    atol = 1e-4 if jax_run["dtype"] == "float32" else 5e-3
    onp.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                                atol=atol)
    assert port_run["losses"][-1] < port_run["losses"][0]
    tr = port_run["trainer"]
    assert tr.num_update == 6 and tr._optimizer.num_update == 6
    # bench.py's FLOP formula counts the tied decoder weight once, as JAX
    assert sum(p.numel() for p in port_run["net"].parameters()) == sum(
        int(onp.prod(a.shape)) for a in jax_run["arrays"].values())
    # multi_precision: fp32 master and moments for the bf16 weights
    bf16 = [i for i, p in enumerate(tr._params) if p.dtype == torch.bfloat16]
    assert bool(bf16) == (jax_run["dtype"] == "bfloat16")
    for i in bf16:
        assert tr._mp[i]
        assert all(s.dtype == torch.float32 for s in tr._states[i])
        assert torch.equal(tr._params[i], tr._states[i][0].to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_ce_and_pretrain_loss_match_jax(dtype):
    rng = onp.random.RandomState(1)
    pred = rng.randn(3, 4, 50).astype("float32")
    label = rng.randint(0, 50, (3, 4)).astype("float32")
    label[0, 0] = 57.0                  # out of range: clipped as pick does
    sw = rng.rand(3, 4, 1).astype("float32")
    want = jax_gluon.loss.SoftmaxCrossEntropyLoss()(
        mx.nd.array(pred, dtype=dtype), mx.nd.array(label),
        mx.nd.array(sw)).asnumpy()
    got = SoftmaxCrossEntropyLoss()(
        torch.from_numpy(pred).to(getattr(torch, dtype)),
        torch.from_numpy(label), torch.from_numpy(sw))
    assert got.dtype == torch.float32 and got.shape == (3,)
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    nsp = rng.randn(3, 2).astype("float32")
    nsp_lab = rng.randint(0, 2, (3,)).astype("float32")
    w = onp.ones((3, 4), "float32")
    w[2, 1:] = 0.0
    jout = (None, None, mx.nd.array(nsp, dtype=dtype),
            mx.nd.array(pred, dtype=dtype))
    want = jax_models.bert_pretrain_loss(
        jout, mx.nd.array(label), mx.nd.array(w),
        mx.nd.array(nsp_lab)).asnumpy()
    tout = (None, None) + tuple(torch.from_numpy(x).to(getattr(torch, dtype))
                                for x in (nsp, pred))
    got = models.bert_pretrain_loss(tout, torch.from_numpy(label),
                                    torch.from_numpy(w),
                                    torch.from_numpy(nsp_lab))
    onp.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_steps_match_jax(name, dtype):
    """Two Adam/AdamW steps, JAX's pure ``step`` vs the port's. In bfloat16
    with ``multi_precision`` JAX starts the moments in bf16 and its first
    step promotes them to float32; the port's are float32 from the start.
    Both give the same numbers (float32: rtol 1e-6)."""
    rng = onp.random.RandomState(2)
    w0 = rng.randn(6, 5).astype("float32")
    gs = [rng.randn(6, 5).astype("float32") for _ in range(2)]
    kw = dict(learning_rate=1e-2, wd=0.01,
              multi_precision=dtype == "bfloat16")
    jopt, topt = jax_optimizer.create(name, **kw), optimizer.create(
        name.upper(), **kw)
    jw = mx.nd.array(w0, dtype=dtype)
    tw = torch.from_numpy(w0).to(getattr(torch, dtype))
    jst = jopt.create_state_multi_precision(0, jw)
    tst = topt.create_state_multi_precision(0, tw)
    assert len(jst) == len(tst) == (3 if dtype == "bfloat16" else 2)
    if dtype == "bfloat16":
        assert str(jst[1].dtype) == "bfloat16"
        assert tst[1].dtype == torch.float32
    jv, tv = (jst[0], tst[0]) if dtype == "bfloat16" else (jw._data, tw)
    jst, tst = jst[-2:], tst[-2:]
    for t, g in enumerate(gs, start=1):
        jv, jst = jopt.step(jv, jnp.asarray(g).astype(jv.dtype), jst, 1e-2,
                            0.01, jnp.int32(t))
        tv, tst = topt.step(tv, torch.from_numpy(g).to(tv.dtype), tst, 1e-2,
                            0.01, t)
    for a, b in zip((tv,) + tuple(tst), (jv,) + tuple(jst)):
        assert a.dtype == torch.float32 and str(b.dtype) == "float32"
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b), rtol=1e-6,
                                    atol=1e-7)
    with pytest.raises(MXNetError, match="no entry"):
        optimizer.create("no_such_optimizer")


def test_trainer_and_bench_need_a_device():
    """No card: the trainer and the port bench raise instead of running on
    the CPU; with device="cpu" the bench runs bench.py's schema."""
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                          dropout=0.1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adamw")
        with pytest.raises(MXNetError, match="no CUDA device"):
            bench.run()


def test_port_bench_on_cpu(monkeypatch):
    for name, value in (("MODEL", "bert_2_128_2"), ("BATCH", "2"),
                        ("SEQ", "16"), ("STEPS", "2")):
        monkeypatch.setenv(f"MXTPU_BENCH_{name}", value)
    record, losses = bench.run(device="cpu")
    assert set(record) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert record["metric"] == "bert_2_128_2_pretrain_tokens_per_sec_per_chip"
    assert set(record["extra"]) == {"step_ms", "mfu", "batch", "seq", "remat",
                                    "params", "backend", "loss"}
    assert record["extra"]["backend"] == "cpu"
    assert (record["extra"]["batch"], record["extra"]["seq"]) == (2, 16)
    assert len(losses) == 4 and all(onp.isfinite(losses))
    assert record["extra"]["loss"] == losses[-1]
    ids, tt, vl, pos, lab, w, nsp = bench.make_batch(2, 16)
    assert pos.shape == (2, 2) and (vl == 16).all() and lab.max() < 30522


def test_trainer_seeds_every_dropout():
    """The trainer gives every Dropout one generator on its device, seeded
    by ``seed``: the same seed gives the same step, another seed another."""
    def first_loss(seed):
        net = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                              dropout=0.3, device="cpu")
        tr = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adamw",
                                     device="cpu", n_labels=3, seed=seed)
        drops = [m for m in net.modules() if isinstance(m, Dropout)]
        assert drops and all(m.generator is tr.generator for m in drops)
        return float(tr.step(*_batch(3)))

    assert first_loss(5) == first_loss(5) != first_loss(6)
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                          dropout=0.3, device="cpu")
    assert set_dropout_generator(net, None) == 1 + 2 * 2   # embed + 2/layer
