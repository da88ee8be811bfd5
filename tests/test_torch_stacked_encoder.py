"""PyTorch port: ``models.StackedTransformerEncoder``, the decode pool's
``decode_block_exhaustion`` chaos site, and ``--ckpt-dir`` in the example
loops, on the CPU.

- The encoder (2 layers, 32 units, 64 hidden, 2 heads, float32) against
  the JAX block on the same weights: the output, and the gradients of
  ``sum(out * cot)`` for the input and every stacked parameter, within
  1e-5 (atol and rtol); its ``transformer_encoder`` serving family through
  ``serve.CompiledModel`` equal to the block's own forward (exactly), with
  the JAX package's serving spec; a ``ShardedTrainer`` step on it with a
  finite loss.
- ``decode_block_exhaustion``: the admission bounces back to the queue
  ``max_requeues`` times, then the stream fails with ``CacheExhausted``
  (JAX ``tests/test_decode.py``
  ``TestDecodeChaos::test_block_exhaustion_requeues_then_sheds``).
- ``--ckpt-dir`` in the image-classification, word-LM and DCGAN loops at
  their tier-1 sizes saves where the JAX examples save; each newest
  checkpoint loads in the JAX package with the same arrays, and a fresh
  port trainer resumes from it with those parameters. The BERT
  pretraining entry point resumes a killed run: the resumed run's last
  loss equals an uninterrupted run's (exactly).
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu import models as jax_models
from incubator_mxnet_tpu.fault import inject as jinject
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import fault, gluon, models, parallel, serve
from incubator_mxnet_tpu_torch.fault import inject
from incubator_mxnet_tpu_torch.models import (
    bert_pretraining, dcgan, image_classification, word_language_model)
from incubator_mxnet_tpu_torch.serve.decode import CacheExhausted

from test_torch_nmt_common import (  # noqa: F401  (fixtures)
    engine, one_torch_thread)

N, C, H, HEADS = 2, 32, 64, 2


@pytest.fixture(autouse=True)
def _no_chaos():
    inject.disable()
    jinject.disable()
    yield
    inject.disable()
    jinject.disable()


def _encoder():
    with mx.cpu():
        net = models.StackedTransformerEncoder(N, C, H, HEADS)
        net.initialize(mx.init.Xavier(
            generator=torch.Generator().manual_seed(0)))
    return net


def test_stacked_encoder_matches_jax():
    net = _encoder()
    names = [n for n in net._reg_params]
    assert sorted(p.name.split("_", 1)[1] for p in
                  net.collect_params().values()) == sorted(
        p.name.split("_", 1)[1] for p in jax_models.transformer.
        StackedTransformerEncoder(N, C, H, HEADS).collect_params().values())
    rng = onp.random.RandomState(0)
    x = rng.randn(3, 7, C).astype("float32")
    cot = rng.randn(3, 7, C).astype("float32")
    jnet = jax_models.transformer.StackedTransformerEncoder(N, C, H, HEADS)
    tree = {n: jnp.asarray(net._reg_params[n].data().asnumpy())
            for n in names}

    @jax.jit
    def ref(tree, x):
        def f(tree, x):
            out = jnet.hybrid_forward(None, x, **tree)
            return jnp.sum(out * cot), out
        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(tree, x)
        return out, grads

    want, (wtree, wx) = ref(tree, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = net(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(out.detach().numpy(), onp.asarray(want),
                                **tol)
    onp.testing.assert_allclose(xt.grad.numpy(), onp.asarray(wx), **tol)
    for n in names:
        onp.testing.assert_allclose(net._reg_params[n]._var.grad.numpy(),
                                    onp.asarray(wtree[n]), err_msg=n, **tol)

    # the serving family: the JAX spec, the compiled model = the block
    from incubator_mxnet_tpu.models import serve_spec as jax_spec
    assert models.serve_spec("transformer_encoder") == \
        jax_spec("transformer_encoder")
    sm = models.hlo_smoke("transformer_encoder", device="cpu")
    cm = sm["compiled"]
    cm.warmup()
    # at a bucket's own shape: the encoder attends over every key, so a
    # padded request would see the padding (served unmasked, as in JAX)
    xs = mx.nd.array(rng.randn(4, 16, C).astype("float32"), ctx=mx.cpu())
    got = cm.predict(xs)
    got = got[0] if isinstance(got, (list, tuple)) else got
    with mx.autograd.predict_mode():
        plain = sm["block"](xs._data)
    assert torch.equal(getattr(got, "_data", got), plain)

    # a training step through ShardedTrainer
    tr = parallel.ShardedTrainer(net, lambda o, y: ((o - y) ** 2).mean(-1),
                                 "adamw", {"learning_rate": 1e-3},
                                 device="cpu")
    y = onp.zeros((3, 7, C), "float32")
    loss = float(tr.step(x, y))
    assert onp.isfinite(loss) and tr.last_finite


@pytest.mark.chaos
def test_block_exhaustion_requeues_then_sheds(engine):
    """Seeded cache pressure: the admission goes back to the queue a
    bounded number of times, then the stream fails loudly."""
    inject.enable(seed=7, decode_block_exhaustion=1.0)
    batcher = serve.DecodeBatcher(engine, max_requeues=2).start()
    try:
        s = batcher.submit(onp.arange(3, 8).astype("int32"),
                           max_new_tokens=4)
        with pytest.raises(CacheExhausted, match="chaos"):
            s.result(timeout=30)
        m = batcher.metrics.snapshot()
        assert m["requeued"] == 2 and m["shed"] == 1
    finally:
        batcher.stop()
        inject.disable()


def _newest(root):
    return fault.list_checkpoints(root)[-1]


def _restore_matches(net, trainer, root):
    """A fresh trainer over ``net`` restores the newest checkpoint under
    ``root``; the JAX package loads the same arrays."""
    arrays, meta, step = jfault.load_latest(root)
    assert trainer.restore_checkpoint(root) == step == _newest(root)
    assert trainer.optimizer.num_update == meta["num_update"]
    for i, p in enumerate(trainer._params):
        onp.testing.assert_array_equal(p.data().asnumpy(),
                                       arrays[f"param:{i:04d}"], p.name)
        for j, s in enumerate(trainer._states.get(i, ())):
            onp.testing.assert_array_equal(s.numpy(),
                                           arrays[f"opt:{i:04d}:{j}"])


@pytest.mark.chaos
def test_example_loops_save_and_resume(tmp_path):
    def image(root):
        kw = dict(model="resnet18_v1", classes=4, image_size=8, epochs=2,
                  batch_size=128)
        image_classification.image_classification_example(
            ckpt_dir=root, ctx=mx.cpu(), **kw)
        assert fault.list_checkpoints(root) == [4, 8]  # every epoch
        with mx.cpu():
            from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
            net = vision.get_model("resnet18_v1", classes=4, thumbnail=True)
            net.initialize()
            net(mx.nd.zeros((1, 3, 8, 8)))
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
            _restore_matches(net, tr, root)

    def lm(root):
        kw = dict(vocab=50, emsize=16, nhid=16, nlayers=2, bptt=8,
                  batch_size=4, steps=3, epochs=2, dropout=0.0)
        word_language_model.lm_example(ckpt_dir=root, seed=0, ctx=mx.cpu(),
                                       **kw)
        assert fault.list_checkpoints(root) == [3, 6]
        with mx.cpu():
            net = word_language_model.RNNModel(50, 16, 16, 2, dropout=0.0)
            net.initialize()
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 5.0})
            _restore_matches(net, tr, root)

    def gan(root):
        dcgan.dcgan_example(latent=8, batch_size=6, steps=3, ckpt_dir=root,
                            ctx=mx.cpu())
        for sub, build, shape in (
                ("D", dcgan.build_discriminator, (1, 1, 16, 16)),
                ("G", lambda: dcgan.build_generator(8), (1, 8))):
            path = os.path.join(root, sub)
            assert fault.list_checkpoints(path) == [1, 3]   # 0 and last
            with mx.cpu():
                net = build()
                net.initialize()
                net(mx.nd.zeros(shape))
                tr = gluon.Trainer(net.collect_params(), "adam")
                _restore_matches(net, tr, path)

    def bert(root):
        flags = ["--seq-len", "16", "--batch-size", "2", "--dtype",
                 "float32", "--ckpt-every", "2"]
        for bad in ("--dp", "--tp", "--sp"):
            # a mesh of two ranks in one process: no process group
            with pytest.raises(mx.MXNetError, match="process group"):
                bert_pretraining.main(flags + [bad, "2"], device="cpu")
        with pytest.raises(mx.MXNetError, match="remat"):
            bert_pretraining.main(flags + ["--remat"], device="cpu")
        whole = bert_pretraining.main(flags + ["--steps", "5"], device="cpu")
        ckpt = ["--ckpt-dir", root]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # Gluon prefixes differ
            # a run of 3 steps saves after the set-up step and steps 0, 2
            bert_pretraining.main(flags + ckpt + ["--steps", "3"],
                                  device="cpu")
            assert fault.list_checkpoints(root) == [2, 4]
            # the run of 5 resumes at t 4, then dies saving its last step
            with inject.chaos(seed=0, crash_sites=["checkpoint.arrays"]):
                with pytest.raises(inject.ChaosCrash):
                    bert_pretraining.main(flags + ckpt + ["--steps", "5"],
                                          device="cpu")
            assert fault.list_checkpoints(root) == [2, 4]
            resumed = bert_pretraining.main(flags + ckpt + ["--steps", "5"],
                                            device="cpu")
        assert resumed == whole
        assert fault.list_checkpoints(root) == [2, 4, 6]

    for case in (image, lm, gan, bert):
        case(str(tmp_path / case.__name__))
