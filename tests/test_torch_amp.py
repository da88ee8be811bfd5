"""PyTorch port: mixed precision (``amp``) held against the JAX package on
the CPU.

Both packages in one process, the same weights (a ``.params`` file the
port writes and the JAX package reads) and the same numpy batches:

- ``amp.init`` casts the matmul-class ops and leaves the float32 ones
  (the JAX package's ``tests/test_aux.py:43-63``), for NDArrays and, in the
  port, for the tensors ``hybrid_forward`` passes; ``reset`` restores;
- ``bert_2_128_2`` under ``amp.init("bfloat16")``: loss and gradients of
  the pretraining loss (the JAX side one jitted program, the weights as
  trace proxies), and the dtype that reaches attention and the MLM
  decoder, bfloat16 in both (the port routes both through ``F``);
- ``LossScaler`` through one overflow sequence, and ``scale_loss`` /
  ``unscale`` on ``gluon.Trainer`` under ``amp.init("float16")``;
- the image-classification example loop with ``--amp`` at a tiny size
  (a one-conv net swapped in for the zoo model in both examples; the
  ResNet-18 gate runs on the card in ``chip_smoke.py``) against the JAX
  example's losses;
- the port's fused step function against its eager step under AMP.

Tolerances: bfloat16 keeps 8 significant bits (one rounding is up to
2**-9 relative), and the two packages round GEMM outputs, GELU and the
attention probabilities to bfloat16 at the same places but from float32
values that differ in the last bits (another summation order), so a
value may round to the neighbouring bfloat16 on one side: the loss within
1e-2 relative, each parameter's gradient within 5e-2 of its largest value
(a few such flips compound through two layers forward and back); the
example's losses within 1e-3 relative (one conv over 27 inputs).
At most 8 tests (see ``tests/test_torch_quantization.py``).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import ndarray as jnd
from incubator_mxnet_tpu.gluon import _trace
from incubator_mxnet_tpu.gluon.block import _TRACING
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import (amp, autograd, fault, gluon, models,
                                       nd, parallel)
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.models import image_classification


def _jax_example():
    """The JAX package's ``examples/image_classification.py`` as a module
    (loaded from its file, as ``tests/test_examples.py`` loads it)."""
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "image_classification.py")
    spec = importlib.util.spec_from_file_location("jax_image_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VOCAB, B, L, P = 100, 4, 24, 4
LOSS_RTOL, GRAD_RTOL = 1e-2, 5e-2
#: XLA:CPU's cheapest compile (the reference runs once)
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
    amp.reset()
    jamp.reset()


def test_amp_init_casts_matmul_ops():
    """The JAX package's ``tests/test_aux.py:43-63`` in both packages:
    ``dot`` goes to bfloat16, ``softmax`` stays float32, ``reset``
    restores float32; in the port also for tensors and for the ops of
    the list it has (``batch_dot``, ``linalg_gemm2``,
    ``FullyConnected``); a second ``init`` changes nothing; other targets
    raise; ``convert_hybrid_block`` and ``convert_model`` cast."""
    for pkg, mod in ((jmx, jamp), (mx, amp)):
        mod.init("bfloat16")
        try:
            a, b = pkg.nd.ones((4, 4)), pkg.nd.ones((4, 4))
            assert str(pkg.nd.dot(a, b).dtype) == "bfloat16"
            assert str(pkg.nd.softmax(a).dtype) == "float32"
        finally:
            mod.reset()
        assert str(pkg.nd.dot(pkg.nd.ones((2, 2)),
                              pkg.nd.ones((2, 2))).dtype) == "float32"
    amp.init("bfloat16")
    amp.init("float16")                         # ignored: already on
    t = torch.ones(2, 3, 4)
    assert nd.batch_dot(t, t, transpose_b=True).dtype == torch.bfloat16
    assert nd.linalg_gemm2(t, t, transpose_a=True).dtype == torch.bfloat16
    assert nd.FullyConnected(t, torch.ones(5, 4), flatten=False).dtype \
        == torch.bfloat16
    assert nd.LayerNorm(t, torch.ones(4), torch.zeros(4)).dtype \
        == torch.float32
    assert nd.dot(torch.ones(2, 2, dtype=torch.int32),
                  torch.ones(2, 2, dtype=torch.int32)).dtype == torch.int32
    amp.reset()
    with pytest.raises(mx.MXNetError, match="bfloat16 or float16"):
        amp.init("float64")
    net = gluon.nn.Dense(4, in_units=4)
    net.initialize()
    assert amp.convert_hybrid_block(net, "bfloat16") is net
    assert str(net.weight.data().dtype) == "bfloat16"
    sym, args, aux = amp.convert_model(None, {"w": nd.ones((2,))},
                                       {"m": nd.ones((2,))})
    assert str(args["w"].dtype) == "bfloat16" \
        and str(aux["m"].dtype) == "float32"


def _batch(seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, VOCAB, (B, L)).astype("int32"),
            rng.randint(0, 2, (B, L)).astype("int32"),
            onp.array([L, 20, 7, 1], "float32"),
            rng.randint(0, L, (B, P)).astype("int32"),
            rng.randint(0, VOCAB, (B, P)).astype("float32"),
            onp.ones((B, P), "float32"),
            rng.randint(0, 2, (B,)).astype("float32"))


def _recorder(fn, seen):
    """``fn`` noting the dtype of its first argument."""
    def rec(*args, **kwargs):
        seen.append(str(args[0].dtype).replace("torch.", ""))
        return fn(*args, **kwargs)
    return rec


def _jax_amp_step(jnet, batch, seen):
    """Loss, outputs and gradients of the JAX BERT under AMP, one jitted
    program over the weights as trace proxies (as the JAX trainer traces
    its step)."""
    names = sorted(jnet.collect_params().keys())
    params = [jnet.collect_params()[n] for n in names]
    vals = [p.data()._data for p in params]

    def run(pvals, *ins):
        proxies = {id(p): jnd.NDArray(v) for p, v in zip(params, pvals)}
        _TRACING.flag = True
        try:
            with jmx.autograd.pause(train_mode=True), \
                    _trace.TraceScope(proxies):
                args = [jnd.NDArray(v) for v in ins]
                outs = jnet(*args[:4])
                loss = jmodels.bert_pretrain_loss(outs, *args[4:])
        finally:
            _TRACING.flag = False
        return jnp.mean(loss._data), [o._data for o in outs]

    jamp.init("bfloat16")
    fn = jax.value_and_grad(run, has_aux=True)
    args = [jnp.asarray(a) for a in batch]
    (loss, outs), grads = jax.jit(fn).lower(vals, *args).compile(
        FAST_COMPILE)(vals, *args)
    jamp.reset()
    n = len(jnet.prefix)
    return (float(loss), [str(o.dtype) for o in outs],
            {k[n:]: onp.asarray(g.astype(jnp.float32))
             for k, g in zip(names, grads)})


@pytest.fixture(scope="module")
def amp_bert(tmp_path_factory):
    """One AMP step of ``bert_2_128_2`` (dropout 0, float32 weights) in
    each package from the same weights, with the dtypes that reached
    ``dot_product_attention`` on each side."""
    batch = _batch()
    port = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                           dropout=0.0, device="cpu")
    f = str(tmp_path_factory.mktemp("amp") / "bert.params")
    port.save_parameters(f)
    jnet = jmodels.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                            dropout=0.0)
    jnet.load_parameters(f)
    out = {"jax_seen": [], "port_seen": []}
    orig = jnd.dot_product_attention
    jnd.dot_product_attention = _recorder(orig, out["jax_seen"])
    try:
        out["jax"] = _jax_amp_step(jnet, batch, out["jax_seen"])
    finally:
        jnd.dot_product_attention = orig
    porig = nd.dot_product_attention
    nd.dot_product_attention = _recorder(porig, out["port_seen"])
    amp.init("bfloat16")
    try:
        with autograd.train_mode():
            outs = port(*(torch.from_numpy(a) for a in batch[:4]))
            loss = models.bert_pretrain_loss(
                outs, *(torch.from_numpy(a) for a in batch[4:]))
        loss.backward()
    finally:
        amp.reset()
        nd.dot_product_attention = porig
    n = len(port.prefix)
    out["port"] = (loss.item(), [str(o.dtype).replace("torch.", "")
                                 for o in outs],
                   {k[n:]: p._var.grad.float().numpy()
                    for k, p in port.collect_params().items()})
    return out


def test_bert_amp_loss_and_grads_match_jax(amp_bert):
    """The pretraining loss within 1e-2 relative and every parameter's
    gradient within 5e-2 of its largest value (module docstring); the
    gradients reach the float32 weights in float32."""
    jloss, _, jgrads = amp_bert["jax"]
    ploss, _, pgrads = amp_bert["port"]
    assert abs(ploss - jloss) <= LOSS_RTOL * abs(jloss), (ploss, jloss)
    assert sorted(pgrads) == sorted(jgrads)
    for k, g in jgrads.items():
        err = onp.abs(pgrads[k] - g).max()
        assert err <= GRAD_RTOL * max(onp.abs(g).max(), 1e-30), (k, err)


def test_amp_dtype_reaching_attention_and_mlm_decoder(amp_bert):
    """Under ``amp.init("bfloat16")`` the query reaching
    ``dot_product_attention`` is bfloat16 in every layer of both
    packages, and so is the MLM decoder's output (the port routes the
    decoder's ``FullyConnected`` and the attention call through ``F``);
    the sequence output after the LayerNorm stays float32."""
    for side in ("jax", "port"):
        seen = amp_bert[f"{side}_seen"]
        assert seen == ["bfloat16"] * 2, (side, seen)
        dtypes = amp_bert[side][1]
        assert dtypes[0] == "float32" and dtypes[3] == "bfloat16", \
            (side, dtypes)


def _dense_net(pkg, prefix):
    net = pkg.gluon.nn.Dense(2, in_units=3, prefix=prefix)
    net.initialize(pkg.init.One())
    return net


def _grads_with(pkg, net, x):
    with pkg.autograd.record():
        loss = (net(pkg.nd.array(x)) * 1.0).sum()
    loss.backward()


def test_loss_scaler_matches_jax():
    """``LossScaler`` in both packages: the overflow check on finite and on
    non-finite gradients, and one sequence of overflow and clean steps
    (halving, the floor at 1, doubling after the window) leaving the same
    scale, counts and window position; with ``guard=`` a ``halt`` guard
    raises at an overflow step in both (the guard's other policies are
    held against the JAX scaler in ``tests/test_torch_fault.py``)."""
    scalers = [jamp.LossScaler(init_scale=8.0, scale_window=3),
               amp.LossScaler(init_scale=8.0, scale_window=3)]
    seq = [True, False, False, False, True, True, True, True, False] \
        + [False] * 7
    for overflow in seq:
        for s in scalers:
            s.update_scale(overflow)
        assert scalers[0].loss_scale == scalers[1].loss_scale
        assert scalers[0]._unskipped == scalers[1]._unskipped
    assert (scalers[1].overflows, scalers[1].steps) == \
        (scalers[0].overflows, scalers[0].steps) == (5, len(seq))
    for x in (onp.ones((2, 3), "float32"),
              onp.array([[1, onp.inf, 1], [1, 1, 1]], "float32"),
              onp.array([[onp.nan, 1, 1], [1, 1, 1]], "float32")):
        verdicts = []
        for pkg, s in ((jmx, scalers[0]), (mx, scalers[1])):
            net = _dense_net(pkg, "scaler_")
            _grads_with(pkg, net, x)
            verdicts.append(s.has_overflow(
                list(net.collect_params().values())))
        assert verdicts[0] == verdicts[1] == (not onp.isfinite(x).all())
    for pkg_fault, scaler_cls in ((jfault, jamp.LossScaler),
                                  (fault, amp.LossScaler)):
        s = scaler_cls(guard=pkg_fault.StepGuard("halt"))
        s.update_scale(False)
        with pytest.raises(pkg_fault.NonFiniteError, match="overflow"):
            s.update_scale(True)


def _scaled_backward(pkg, mod, net, tr, x):
    with pkg.autograd.record():
        loss = pkg.nd.mean(net(pkg.nd.array(x)).astype("float32"))
        with mod.scale_loss(loss, tr) as scaled:
            scaled.backward()


def test_scale_loss_and_unscale_on_trainer_match_jax():
    """``amp.init("float16")`` + ``init_trainer`` in both packages: under
    ``scale_loss`` the backward sees the loss times 2**16, the trainer's
    scale becomes its inverse and ``trainer.step`` moves the weights as
    the JAX package's; ``unscale`` divides the gradients by the scale in
    place; a step whose fp16 gradients overflow sets the trainer's scale
    to 0 and halves the loss scale; under bfloat16 ``init_trainer``
    attaches no scaler. fp16 GEMMs on both sides: within 1e-3 relative."""
    rng = onp.random.RandomState(5)
    x = (0.1 * rng.randn(4, 3)).astype("float32")
    w0 = rng.randn(2, 3).astype("float32")
    got = {}
    for name, pkg, mod in (("jax", jmx, jamp), ("port", mx, amp)):
        mod.init("float16")
        try:
            net = pkg.gluon.nn.Dense(2, in_units=3)
            net.initialize()
            net.weight.set_data(pkg.nd.array(w0))
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
            mod.init_trainer(tr)
            scaler = tr._amp_loss_scaler
            assert scaler.loss_scale == 2 ** 16
            _scaled_backward(pkg, mod, net, tr, x)
            assert tr._scale == 2.0 ** -16 and scaler.overflows == 0
            grad = net.weight.grad().asnumpy().astype("float32").copy()
            tr.step(1)
            mod.unscale(tr)
            got[name] = (grad, net.weight.data().asnumpy().astype("float32"),
                         net.weight.grad().asnumpy().astype("float32"))
            scaler.loss_scale = 2.0 ** 40
            _scaled_backward(pkg, mod, net, tr, x)
            assert tr._scale == 0.0 and scaler.overflows == 1 \
                and scaler.loss_scale == 2.0 ** 39, name
        finally:
            mod.reset()
    for a, b in zip(got["port"], got["jax"]):
        onp.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    onp.testing.assert_allclose(got["port"][2], got["port"][0] * 2.0 ** -16,
                                rtol=1e-6)
    amp.init("bfloat16")
    tr = gluon.Trainer(_dense_net(mx, "bf16_").collect_params(), "sgd")
    amp.init_trainer(tr)
    assert tr._amp_loss_scaler is None


def _tiny(g, classes):
    """The stand-in for the zoo model: conv, BatchNorm, relu, global
    pool, Dense; every shape given, so weights exist before the loop."""
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Conv2D(4, 3, in_channels=3),
                g.nn.BatchNorm(in_channels=4), g.nn.Activation("relu"),
                g.nn.GlobalAvgPool2D(), g.nn.Dense(classes, in_units=4))
    return net


def test_example_loop_matches_jax_first_losses(monkeypatch, tmp_path):
    """The image-classification example with ``--amp`` in both packages on
    the same weights and synthetic set (4 classes, 8x8, batch 128: four
    steps of one epoch, shuffled by numpy's global stream seeded alike):
    every step's loss within 1e-3 relative and the epoch accuracy within
    1%;
    ``--rec`` reads the file it names, so a missing one raises (its
    training: ``tests/test_torch_gluon_data.py``; ``--ckpt-dir`` saves:
    ``tests/test_torch_stacked_encoder.py``)."""
    classes = 4
    pnet = _tiny(gluon, classes)
    pnet.initialize(mx.init.Xavier(magnitude=2.0))
    f = str(tmp_path / "tiny.params")
    pnet.save_parameters(f)
    jnet = _tiny(jgluon, classes)
    jnet.load_parameters(f)
    losses = []

    class Spy(jgluon.loss.SoftmaxCrossEntropyLoss):
        def __call__(self, *args, **kwargs):
            out = super().__call__(*args, **kwargs)
            losses.append(float(out.asnumpy().mean()))
            return out

    monkeypatch.setattr(jgluon.loss, "SoftmaxCrossEntropyLoss", Spy)
    monkeypatch.setattr(jvision, "get_model", lambda name, **kw: jnet)
    monkeypatch.setattr(vision, "get_model", lambda name, **kw: pnet)
    flags = dict(classes=classes, image_size=8, epochs=1, batch_size=128)
    onp.random.seed(0)
    jacc = _jax_example().main([f"--{k.replace('_', '-')}={v}"
                          for k, v in flags.items()] + ["--amp"])
    jamp.reset()
    onp.random.seed(0)
    out = image_classification.image_classification_example(
        amp=True, ctx=mx.cpu(), **flags)
    assert len(out["losses"]) == len(losses) == 4
    onp.testing.assert_allclose(out["losses"], losses, rtol=1e-3)
    # a prediction whose two best logits are within bf16 rounding may
    # differ: at most 1% of the 512 images
    assert abs(out["accuracy"] - jacc) <= 0.01, (out["accuracy"], jacc)
    with pytest.raises((mx.MXNetError, OSError)):
        image_classification.image_classification_example(
            rec=str(tmp_path / "missing.rec"), ctx=mx.cpu(), **flags)


def test_amp_fused_step_function_matches_eager():
    """``ShardedTrainer`` under ``amp.init("bfloat16")`` (float32 weights,
    AdamW): the fused step's function, run uncaptured as on the CPU,
    against the eager step over two steps: the same losses and weights
    (the same operations in another arrangement), the gradients float32."""
    batch = _batch(1)
    nets, trainers = [], []
    amp.init("bfloat16")
    for _ in range(2):
        net = models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                              max_length=L, dropout=0.0, device="cpu")
        nets.append(net)
        trainers.append(parallel.ShardedTrainer(
            net, models.bert_pretrain_loss, "adamw",
            {"learning_rate": 1e-3}, device="cpu", n_labels=3))
    losses = [[], []]
    for _ in range(2):
        losses[0].append(float(trainers[0].step(*batch)))
        tr = trainers[1]
        if tr._params is None:
            tr._init_state(tr.place(*batch[:4]))
        losses[1].append(float(tr._fused_step(tr.place(*batch),
                                              capture=False)))
    onp.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    for (k, a), b in zip(nets[0].named_parameters(), nets[1].parameters()):
        assert a.grad.dtype == torch.float32, k
        torch.testing.assert_close(b.detach(), a.detach(), rtol=1e-5,
                                   atol=1e-6)
