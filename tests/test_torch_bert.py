"""PyTorch port: BERT held against the JAX package on the CPU.

The same ``bert_2_128_2`` weights go into both packages through
``convert.params_from_jax`` (dropout 0). Tolerances: float32 atol 1e-4
(summation order of the GEMMs and softmax through two layers, outputs up
to ~5 in magnitude; observed ~2e-6); bfloat16 atol 2e-2 (the two sides
round the normalised embedding to bfloat16 from float32 statistics that
may differ in the last bit, one bfloat16 ulp is 2**-8 relative; everything
after the embedding LayerNorm is float32 on both sides).

Rows with ``valid_length == 0`` see no key. Both packages give the mean of
V there: the port's flash path writes it out, the JAX XLA path (which JAX
takes on the CPU) gets it as a uniform softmax over scores all filled with
-1e30. Every row is compared, those too.
"""
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import models as jax_models
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu_torch import models
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import params_from_jax

VOCAB, MAXLEN = 100, 64
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, B=4, L=24):
    rng = onp.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, L)).astype("int32")
    tt = rng.randint(0, 2, (B, L)).astype("int32")
    vl = onp.array([L, 9, 0, 1], "float32")[:B]
    pos = rng.randint(0, L, (B, 3)).astype("int32")
    return ids, tt, vl, pos


def _pair(dtype, inputs, **kw):
    """A JAX BERT run once on ``inputs`` (which finishes its deferred
    parameter init) and a port BERT holding the same weights."""
    net = jax_models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                              max_length=MAXLEN, dropout=0.0, dtype=dtype,
                              **kw)
    net.initialize()
    want = net(*(nd.array(x) for x in inputs))
    arrays = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    port = models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                           max_length=MAXLEN, dropout=0.0, dtype=dtype,
                           device="cpu", **kw)
    params_from_jax(port, arrays)
    return want, port, arrays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_matches_jax(dtype):
    ids, tt, vl, pos = _inputs()
    want, port, _ = _pair(dtype, (ids, tt, vl, pos))
    with torch.inference_mode():
        got = port(*(torch.from_numpy(x) for x in (ids, tt, vl, pos)))
    assert len(got) == len(want) == 4          # seq, pooled, nsp, mlm
    for name, w, g in zip(("seq", "pooled", "nsp", "mlm"), want, got):
        w = w.asnumpy()
        # the JAX LayerNorm promotes a bfloat16 model's activations to
        # float32; the port writes that promotion out
        assert str(w.dtype) == "float32" and g.dtype == torch.float32, name
        assert tuple(g.shape) == w.shape, name
        onp.testing.assert_allclose(g.numpy(), w,
                                    atol=ATOL[dtype], err_msg=name)


def test_bert_encoder_family_and_mask():
    """The serving family (no decoder, no classifier) returns (seq, pooled);
    the mask is arange(L) < valid_length in float32, shape (B,1,1,L)."""
    ids, tt, vl, _ = _inputs(seed=1, B=2, L=11)
    want, port, _ = _pair("float32", (ids, tt, vl), use_decoder=False,
                          use_classifier=False)
    with torch.inference_mode():
        got = port(*(torch.from_numpy(x) for x in (ids, tt, vl)))
    assert len(got) == 2
    for w, g in zip(want, got):
        onp.testing.assert_allclose(g.numpy(), w.asnumpy(), atol=ATOL[
            "float32"])
    mask = port._attn_mask(torch.tensor([2.5, 0.0]), 2, 4)
    assert mask.shape == (2, 1, 1, 4)
    assert mask[0, 0, 0].tolist() == [True, True, True, False]
    assert not mask[1].any()


def test_params_from_jax_refuses_mismatches():
    _, port, arrays = _pair("float32", _inputs(seed=2)[:3])
    # the decoder's output weight is tied to the word embedding: one array
    assert not any(k.endswith("decoder_tied_weight") for k in arrays)
    word = next(v for k, v in arrays.items() if k.endswith("_word_embed_"
                                                          "weight"))
    onp.testing.assert_array_equal(port.word_embed.weight.data().asnumpy(),
                                   word)
    # another instance prefix (the JAX global counter) pairs the same way
    prefix = next(iter(arrays)).split("_")[0] + "_"
    renamed = {"bertmodel77_" + k[len(prefix):]: v for k, v in arrays.items()}
    params_from_jax(port, renamed)
    missing = dict(arrays)
    missing.pop(next(k for k in arrays if k.endswith("pooler_bias")))
    with pytest.raises(MXNetError, match="missing"):
        params_from_jax(port, missing)
    extra = dict(arrays)
    extra[prefix + "encoder_layer9_ln1_gamma"] = onp.ones(128, "float32")
    with pytest.raises(MXNetError, match="no port counterpart"):
        params_from_jax(port, extra)
    bad = dict(arrays)
    k = next(k for k in arrays if k.endswith("nsp_weight"))
    bad[k] = onp.zeros((3, 128), "float32")
    with pytest.raises(MXNetError, match="shape"):
        params_from_jax(port, bad)


def test_dropout_and_layers():
    """Dropout draws from an explicit generator in train mode and is the
    identity outside it (``autograd.is_training()`` is the one flag, as in
    JAX; ``eval()`` does not turn it on); Dense promotes float32 x bfloat16
    to float32 like JAX."""
    from incubator_mxnet_tpu_torch import autograd, cpu
    from incubator_mxnet_tpu_torch.nn import Dense, Dropout
    x = torch.ones(1000)
    d = Dropout(0.5, generator=torch.Generator().manual_seed(3))
    with autograd.train_mode():
        y1 = d(x)
        d.generator.manual_seed(3)
        assert torch.equal(d(x), y1)
    assert set(y1.unique().tolist()) <= {0.0, 2.0}
    assert 400 < int((y1 == 0).sum()) < 600
    assert torch.equal(d(x), x) and torch.equal(d.train()(x), x)
    with autograd.predict_mode():
        assert torch.equal(d(x), x)
    dense = Dense(4, in_units=3, dtype="bfloat16", activation="tanh")
    dense.initialize(ctx=cpu())
    out = dense(torch.ones(2, 3))
    assert out.dtype == torch.float32 and out.shape == (2, 4)
