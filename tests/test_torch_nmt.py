"""PyTorch port: Transformer NMT held against the JAX package on the CPU.

Both packages in one process, the same weights (``convert.params_from_jax``
or ``.params`` files), dropout 0, float32: the position table, multi-head
attention (causal self-attention, cross-attention over a memory of another
length under a key mask), the model's logits with a ragged
``src_valid_length``, the ``F`` ops and serving entry NMT adds, the tied
output projection as one parameter, the label-smoothed loss, one
``ShardedTrainer`` step, the incremental decode steps (contiguous and
paged caches), ``beam_search`` (KV cache) and ``beam_search_reference``
(full re-decode) against the JAX ``beam_search`` at K = 1 and 3, the
top-k tie order of ``jax.lax.top_k``, a model whose every candidate score
ties, and the first 3 losses of the machine-translation example's loop.
The set-up is shared with ``tests/test_torch_decode.py``
(``tests/test_torch_nmt_common.py``).

Tolerances, float32: activations and logits atol 1e-5 (GEMM and
attention summation order; observed ~1e-6); gradients within 1e-5 of each
parameter's largest; beam sequences equal and scores rtol 1e-5 (float32
log-softmax sums in another order); the example's losses atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jax_gluon
from incubator_mxnet_tpu import models as jax_models
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.models import nmt as jax_nmt
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import models, parallel
from incubator_mxnet_tpu_torch.convert import jax_suffixes, params_from_jax
from incubator_mxnet_tpu_torch.models import nmt
from incubator_mxnet_tpu_torch.models.transformer import MultiHeadAttention

from test_torch_nmt_common import (  # noqa: F401  (fixtures)
    HEADS, HIDDEN, LAYERS, MAX_LEN, UNITS, VOCAB, batch, one_torch_thread,
    port_model, ref)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def test_position_encoding_is_the_jax_table():
    want = onp.asarray(jax_nmt._position_encoding(MAX_LEN, UNITS))
    assert onp.array_equal(nmt.position_encoding(MAX_LEN, UNITS), want)


def test_multi_head_attention_causal_and_cross_match_jax(ref):
    """The decoder's causal self-attention cell, and its cross-attention
    cell from 6 queries over a memory of 5 under a key mask with an empty
    row, against the JAX cells with the same weights."""
    src, tgt, valid, _ = batch()
    rng = onp.random.RandomState(3)
    x = rng.randn(*tgt.shape, UNITS).astype("float32")
    mem = rng.randn(*src.shape, UNITS).astype("float32")
    valid[-1] = 0.0
    mask = (onp.arange(src.shape[1])[None] < valid[:, None]).astype(
        "float32").reshape(len(valid), 1, 1, -1)
    jlayer = ref["net"].decoder.layers[0]
    layer = ref["port"].decoder.layers[0]
    assert isinstance(layer.self_attn, MultiHeadAttention)
    assert layer.self_attn._causal and layer.cross_attn._cross
    assert not hasattr(layer.cross_attn, "qkv")
    assert not hasattr(layer.self_attn, "kv_proj")
    for kind, args in (("self_attn", (x,)), ("cross_attn", (x, mem, mask))):
        want = getattr(jlayer, kind)(*(jnd.array(a) for a in args))
        with torch.no_grad():
            got = getattr(layer, kind)(*(torch.from_numpy(a) for a in args))
        onp.testing.assert_allclose(got.numpy(), want.asnumpy(), atol=1e-5,
                                    err_msg=kind)
    with pytest.raises(ValueError, match="cross_attention=True"):
        layer.self_attn(torch.from_numpy(x), torch.from_numpy(mem))


def test_nmt_forward_matches_jax(ref):
    src, tgt, valid, _ = batch()
    net = ref["port"]
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (src, tgt, valid)))
    assert got.shape == (32, 6, VOCAB)
    onp.testing.assert_allclose(got.numpy(), ref["logits"], atol=1e-5)
    # the same call on NDArrays, and encode's mask
    with mx.cpu():
        out = net(*(mx.nd.array(a) for a in (src, tgt, valid)))
        mem, mask = net.encode(mx.nd.array(src), mx.nd.array(valid))
    onp.testing.assert_allclose(out.asnumpy(), ref["logits"], atol=1e-5)
    jmem, jmask = ref["net"].encode(jnd.array(src), jnd.array(valid))
    onp.testing.assert_allclose(mem.asnumpy(), jmem.asnumpy(), atol=1e-5)
    assert onp.array_equal(mask.asnumpy(), jmask.asnumpy())


def test_f_ops_and_nmt_encoder_entry_match_jax(ref):
    """``F.split``/``F.broadcast_lesser`` (the names the NMT blocks call)
    against the JAX ops, and the ``nmt_encoder`` serving entry and spec
    against the JAX package's on the same weights."""
    rng = onp.random.RandomState(7)
    x = rng.randn(2, 3, 6).astype("float32")
    for got, want in zip(mx.nd.split(mx.nd.array(x, ctx=mx.cpu()), 3, 2),
                         jnd.split(jnd.array(x), num_outputs=3, axis=2)):
        assert onp.array_equal(got.asnumpy(), want.asnumpy())
    a, b = onp.arange(5.0).reshape(1, 5), onp.array([[2.0], [4.0]])
    got = mx.nd.broadcast_lesser(mx.nd.array(a, ctx=mx.cpu()),
                                 mx.nd.array(b, ctx=mx.cpu()))
    want = jnd.broadcast_lesser(jnd.array(a), jnd.array(b))
    assert got.asnumpy().dtype == want.asnumpy().dtype
    assert onp.array_equal(got.asnumpy(), want.asnumpy())
    assert models.serve_spec("nmt_encoder") == \
        jax_models.serve_spec("nmt_encoder")
    kw = dict(src_vocab=VOCAB, units=UNITS, hidden_size=HIDDEN,
              num_layers=LAYERS, num_heads=HEADS, max_length=MAX_LEN)
    jentry = jax_models._NMTEncodeEntry(prefix="enc_entry_", **kw)
    jentry.initialize(jmx.init.Xavier())
    src, _, valid, _ = batch()
    want = jentry(jnd.array(src), jnd.array(valid)).asnumpy()
    with mx.cpu():
        entry = models._NMTEncodeEntry(prefix="enc_entry_", **kw)
        entry.initialize()
    params_from_jax(entry, {k: p.data().asnumpy()
                            for k, p in jentry.collect_params().items()})
    with torch.no_grad():
        got = entry(torch.from_numpy(src), torch.from_numpy(valid))
    onp.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_tied_weight_is_one_parameter(ref, tmp_path):
    """``proj_weight`` is ``tgt_embed.weight`` in ``collect_params``,
    torch's parameters, ``ShardedTrainer``'s optimizer, ``.params`` files
    (both ways) and ``params_from_jax``."""
    net = port_model(ref["arrays"])
    assert net.proj_weight is net.tgt_embed.weight
    names = list(net.collect_params())
    assert len(names) == len(ref["arrays"]) == len(set(names))
    assert net.prefix + "proj_weight" not in names
    assert len(list(net.parameters())) == len(names)
    tr = parallel.ShardedTrainer(net, nmt.label_smoothed_ce, "adam",
                                 device="cpu")
    tr.step(*batch())
    assert len(tr._params) == len(names) == len(tr._states)
    assert sum(p is net.tgt_embed.weight._var for p in tr._params) == 1
    # .params files: the port's (after the step) into the JAX model, the
    # JAX model's (restored) into a zeroed port model
    src, tgt, valid, _ = batch()
    f = str(tmp_path / "port.params")
    net.save_parameters(f)
    jnet = ref["net"]
    try:
        jnet.load_parameters(f)
        want = jnet(jnd.array(src), jnd.array(tgt),
                    jnd.array(valid)).asnumpy()
    finally:
        for k, p in jnet.collect_params().items():
            p.set_data(jnd.array(ref["arrays"][k]))
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (src, tgt, valid)))
    onp.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    f2 = str(tmp_path / "jax.params")
    jnet.save_parameters(f2)
    back = port_model(ref["arrays"])
    with torch.no_grad():
        for p in back.parameters():
            p.zero_()
    back.load_parameters(f2)
    assert back.proj_weight is back.tgt_embed.weight
    with torch.no_grad():
        got = back(*(torch.from_numpy(a) for a in (src, tgt, valid)))
    onp.testing.assert_allclose(got.numpy(), ref["logits"], atol=1e-5)


def test_label_smoothed_ce_is_the_examples_dense_loss():
    rng = onp.random.RandomState(5)
    logits = rng.randn(6, VOCAB).astype("float32")
    label = rng.randint(0, VOCAB, 6)
    dense = onp.full((6, VOCAB), 0.1 / VOCAB, "float32")
    dense[onp.arange(6), label] += 0.9
    want = jax_gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)(
        jnd.array(logits), jnd.array(dense)).asnumpy()
    got = nmt.label_smoothed_ce(torch.from_numpy(logits),
                                torch.from_numpy(label))
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _jax_smoothed_ce(out, label, eps=0.1):
    logp = jnd.log_softmax(out, axis=-1)
    return -((1 - eps) * jnd.pick(logp, label, axis=-1)
             + (eps / VOCAB) * jnd.sum(logp, axis=-1))


def test_sharded_trainer_step_matches_jax(ref):
    """One Adam step: the loss, the gradient norm and every gradient against
    the JAX ``ShardedTrainer``'s forward and backward; the tied weight
    takes one update: Adam's first step moves each weight by ``lr * g /
    (|g| + eps)``, from the JAX gradients, within 1e-5 (where ``|g|`` is
    near ``eps`` the gradients' rounding moves the step by ~3e-6; a second
    update would add up to ``lr`` = 1e-3)."""
    b = batch(1)
    lr = 1e-3
    tr = jax_parallel.ShardedTrainer(
        ref["net"], _jax_smoothed_ce, "adam", {"learning_rate": lr},
        mesh=jax_parallel.make_mesh(devices=jax.devices()[:1]), n_labels=1)
    tr.prepare(*b)
    loss, gnorm, grads, _, _ = jax.jit(tr._make_loss_grads(3))(
        tr._param_vals, tr._base_key, jnp.int32(1), *tr.place(*b))
    names = [n for n, _ in sorted(ref["net"].collect_params().items())]
    jgrads = {n: onp.asarray(g) for n, g in zip(names, grads)}

    net = port_model(ref["arrays"])
    port = parallel.ShardedTrainer(net, nmt.label_smoothed_ce, "adam",
                                   {"learning_rate": lr}, device="cpu")
    got_loss = float(port.step(*b))
    onp.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    onp.testing.assert_allclose(port.last_grad_norm, float(gnorm),
                                rtol=1e-5)
    suffix = jax_suffixes(net)
    got = {suffix[n]: p.grad.numpy() for n, p in net.named_parameters()}
    assert len(got) == len(jgrads)
    for name, want in jgrads.items():
        g = got[name[len("nmtref_"):]]
        assert onp.abs(g - want).max() <= 1e-5 * onp.abs(want).max(), name
    w0 = ref["arrays"]["nmtref_tgt_embed_weight"]
    g = jgrads["nmtref_tgt_embed_weight"]
    once = w0 - lr * g / (onp.abs(g) + 1e-8)
    onp.testing.assert_allclose(net.tgt_embed.weight.data().asnumpy(), once,
                                atol=1e-5)


# ---------------------------------------------------------------------------
# incremental decode
# ---------------------------------------------------------------------------
def test_decode_steps_match_jax(ref):
    """Four steps of ``nmt_step`` (contiguous cache) and ``nmt_paged_step``
    (pages scattered over a pool, the last row on the scratch page) at
    ragged per-row positions: logits and caches against the JAX
    functions."""
    src, _, valid, _ = batch()
    B, T, bs = 32, 12, 4
    jparams = jax_nmt.incremental_decode_params(ref["net"])
    jmem, jmask = ref["net"].encode(jnd.array(src), jnd.array(valid))
    jcross = jax_nmt.cross_attention_kv(jparams, jmem._data)
    key_mask = jmask._data[:, 0, 0, :] > 0
    net = ref["port"]
    params = nmt.incremental_decode_params(net)
    with torch.no_grad():
        mem, mask = net.encode(torch.from_numpy(src),
                               torch.from_numpy(valid))
        cross = nmt.cross_attention_kv(params, mem)
    onp.testing.assert_allclose(cross.numpy(), onp.asarray(jcross),
                                atol=1e-5)
    tmask = mask[:, 0, 0, :] > 0
    shape = (LAYERS, B, T, UNITS)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    # rows 0-30 own 3 pages each, scattered over the pool; row 31 parks
    # its writes on the scratch page 0
    tables = onp.random.RandomState(5).permutation(
        onp.arange(1, 94)).astype("int32").reshape(31, 3)
    tables = onp.concatenate([tables, onp.zeros((1, 3), "int32")])
    pool = (94, LAYERS, bs, UNITS)
    jpk, jpv = jnp.zeros(pool), jnp.zeros(pool)
    pk, pv = torch.zeros(pool), torch.zeros(pool)
    jstep = jax_nmt._nmt_step_jit
    jpaged = jax.jit(jax_nmt.nmt_paged_step, static_argnums=(1, 2))
    rng = onp.random.RandomState(4)
    for t in range(4):
        pos = (onp.arange(B) % 5 + t).astype("int32")
        pos[-1] = 0
        tok = rng.randint(0, VOCAB, B).astype("int32")
        jl, jk, jv = jstep(jparams, HEADS, jk, jv, jcross, key_mask,
                           jnp.asarray(tok), jnp.asarray(pos))
        jpl, jpk, jpv = jpaged(jparams, HEADS, bs, jpk, jpv,
                               jnp.asarray(tables), jnp.asarray(pos),
                               jnp.asarray(tok), jcross, key_mask)
        with torch.no_grad():
            lg, k2, _ = nmt.nmt_step(params, ck, cv, cross, tmask,
                                     torch.from_numpy(tok),
                                     torch.from_numpy(pos))
            plg, pk2, _ = nmt.nmt_paged_step(
                params, bs, pk, pv, torch.from_numpy(tables),
                torch.from_numpy(pos), torch.from_numpy(tok), cross, tmask)
        assert k2 is ck and pk2 is pk          # written in place
        onp.testing.assert_allclose(lg.numpy(), onp.asarray(jl), atol=1e-5)
        onp.testing.assert_allclose(plg[:-1].numpy(), onp.asarray(jpl)[:-1],
                                    atol=1e-5)
    onp.testing.assert_allclose(ck.numpy(), onp.asarray(jk), atol=1e-5)
    onp.testing.assert_allclose(cv.numpy(), onp.asarray(jv), atol=1e-5)
    # every page but the scratch page 0 (the last row's writes land there)
    onp.testing.assert_allclose(pk[1:].numpy(), onp.asarray(jpk)[1:],
                                atol=1e-5)
    onp.testing.assert_allclose(pv[1:].numpy(), onp.asarray(jpv)[1:],
                                atol=1e-5)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("beam", [1, 3])
def test_beam_search_matches_jax(ref, beam):
    """``beam_search`` and ``beam_search_reference`` against the JAX
    package's ``beam_search`` (which its own tests hold equal to its
    reference): sequences equal, scores rtol 1e-5."""
    src, _, valid, _ = batch()
    want_s, want_sc = jax_nmt.beam_search(ref["net"], jnd.array(src),
                                          jnd.array(valid), beam_size=beam,
                                          max_length=12)
    for fn in (nmt.beam_search, nmt.beam_search_reference):
        seqs, scores = fn(ref["port"], src, valid, beam_size=beam,
                          max_length=12)
        assert seqs.shape == (32, beam, 12) and seqs.dtype == torch.int32
        onp.testing.assert_array_equal(seqs.numpy(), onp.asarray(want_s))
        onp.testing.assert_allclose(scores.numpy(), onp.asarray(want_sc),
                                    rtol=1e-5)


def test_top_k_orders_ties_as_jax():
    cand = onp.array([[0.0, 1.0, 1.0, -1e9, 1.0, -1e9],
                      [-1e9, -1e9, -1e9, -1e9, -1e9, -1e9]], "float32")
    vals, idx = nmt._top_k(torch.from_numpy(cand), 4)
    jvals, jidx = jax.lax.top_k(jnp.asarray(cand), 4)
    onp.testing.assert_array_equal(idx.numpy(), onp.asarray(jidx))
    onp.testing.assert_array_equal(vals.numpy(), onp.asarray(jvals))


def test_beam_search_with_tied_scores_matches_jax(ref):
    """The reference model with its tied embedding and projection zeroed
    and a bias with three equal maxima: every step's logits are the bias,
    so candidate scores tie at every step (and the initial ``[0, -1e9,
    ...]`` beams tie among themselves); the sequences are decided by the
    tie rule alone."""
    arrays = dict(ref["arrays"])
    arrays["nmtref_tgt_embed_weight"] = onp.zeros((VOCAB, UNITS), "float32")
    bias = onp.zeros(VOCAB, "float32")
    bias[[4, 7, 9]] = 1.0
    arrays["nmtref_proj_bias"] = bias
    jparams = ref["net"].collect_params()
    src, _, valid, _ = batch()
    try:
        for k in ("nmtref_tgt_embed_weight", "nmtref_proj_bias"):
            jparams[k].set_data(jnd.array(arrays[k]))
        want_s, want_sc = jax_nmt.beam_search(
            ref["net"], jnd.array(src), jnd.array(valid), beam_size=3,
            max_length=12)
    finally:
        for k in ("nmtref_tgt_embed_weight", "nmtref_proj_bias"):
            jparams[k].set_data(jnd.array(ref["arrays"][k]))
    net = port_model(arrays)
    for fn in (nmt.beam_search, nmt.beam_search_reference):
        seqs, scores = fn(net, src, valid, beam_size=3, max_length=12)
        onp.testing.assert_array_equal(seqs.numpy(), onp.asarray(want_s))
        onp.testing.assert_allclose(scores.numpy(), onp.asarray(want_sc),
                                    rtol=1e-5)
    assert len(onp.unique(onp.asarray(want_sc))) < 3 * 32   # ties occurred


# ---------------------------------------------------------------------------
# the machine-translation example's loop
# ---------------------------------------------------------------------------
def _seq_smoothed_ce(out, dense):
    """The example's loss (dense-label softmax cross-entropy per token)
    summed over each sequence: the JAX ``ShardedTrainer``'s mean of it over
    the batch is the example's ``loss.backward()`` (the per-token losses
    summed) over ``trainer.step(batch_size)``'s batch size."""
    return -jnd.sum(dense * jnd.log_softmax(out, axis=-1), axis=(1, 2))


def test_mt_example_first_losses_match_jax(ref):
    """The first 3 losses of ``nmt.mt_example``, the loop of the JAX
    package's ``examples/machine_translation.py``, against the same loop
    on the JAX package from the same weights: the example's batches,
    dense label-smoothed targets and Adam (lr 0.002), its forward,
    backward and update compiled once as the JAX ``ShardedTrainer`` step
    (the same optimizer and gradient; the example's eager autograd would
    compile each of its ops apart)."""
    steps, L, B = 3, 5, 32
    tr = jax_parallel.ShardedTrainer(
        ref["net"], _seq_smoothed_ce, "adam", {"learning_rate": 0.002},
        mesh=jax_parallel.make_mesh(devices=jax.devices()[:1]), n_labels=1)
    rng = onp.random.RandomState(0)
    want = []
    for _ in range(steps):
        src, tgt_in, label = nmt.make_mt_batch(rng, B, L, VOCAB, "copy")
        dense = onp.full(label.shape + (VOCAB,), 0.1 / VOCAB, "float32")
        onp.put_along_axis(dense, label[..., None], 0.1 / VOCAB + 0.9,
                           axis=-1)
        loss = tr.step(src, tgt_in, dense).asnumpy()
        want.append(float(loss) / label.shape[1])
    out = nmt.mt_example(steps=steps, net=port_model(ref["arrays"]),
                         ctx=mx.cpu())
    onp.testing.assert_allclose(out["losses"], want, atol=1e-5)
    assert 0.0 <= out["accuracy"] <= 1.0
