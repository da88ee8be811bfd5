"""PyTorch port: the serving path held against the JAX package on the CPU.

``BucketTable`` must bucket exactly as the JAX one. Then the same requests
go through ``CompiledModel`` + ``DynamicBatcher`` in both packages, with the
same ``bert_2_128_2`` weights, and the per-request outputs must agree
(float32 atol 1e-4: summation order through two layers, observed ~1e-6).
Batch-padding rows (``valid_length`` 0) see no key; both attention paths
give the mean of V there, and they are sliced off before the results are
scattered.
"""
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import models as jax_models
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import serve as jax_serve
from incubator_mxnet_tpu_torch import models, serve
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import params_from_jax

ATOL = 1e-4
VOCAB, MAXLEN = 60, 32
TABLE = {"batch": (1, 2), "seq": (8, 16)}   # 4 buckets: 4 JAX compiles


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("axes", [
    {"batch": (1, 8)},
    {"seq": (8, 48)},
    {"batch": (1, 32), "seq": (8, 512)},
    {"batch": (3, 3), "seq": (5, 100)},
])
def test_bucket_table_matches_jax(axes):
    want, got = jax_serve.BucketTable(axes), serve.BucketTable(axes)
    assert got.axes == want.axes
    assert got.num_buckets() == want.num_buckets()
    assert list(got.assignments()) == list(want.assignments())
    for name, (lo, hi) in axes.items():
        assert got.sizes(name) == want.sizes(name)
        for n in range(1, hi + 1):
            assert got.bucket(name, n) == want.bucket(name, n)
        with pytest.raises(serve.BucketOverflow):
            got.bucket(name, hi + 1)
        with pytest.raises(jax_serve.BucketOverflow):
            want.bucket(name, hi + 1)
    with pytest.raises(MXNetError):
        got.bucket("nope", 1)
    assert serve.round_up_pow2(5) == jax_serve.round_up_pow2(5) == 8


def _requests(n=8, seed=0):
    rng = onp.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        L = int(rng.randint(3, 17))
        reqs.append((rng.randint(1, VOCAB, L).astype("int32"),
                     (onp.arange(L) >= L // 2).astype("int32"),
                     onp.array(L, "float32")))
    return reqs


def _serve(batcher, reqs):
    futures = [batcher.submit(*r) for r in reqs]
    try:
        return [f.result(timeout=120) for f in futures]
    finally:
        batcher.stop()


def test_serving_matches_jax():
    spec = jax_models.serve_spec("bert_encoder")
    example = (onp.ones((2, 8), "int32"), onp.zeros((2, 8), "int32"),
               onp.full((2,), 8, "float32"))
    net = jax_models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                              max_length=MAXLEN, dropout=0.0,
                              use_decoder=False, use_classifier=False)
    net.initialize()
    net.hybridize()
    net(*(nd.array(x) for x in example))
    jcm = jax_serve.CompiledModel(net, jax_serve.BucketTable(TABLE),
                                  spec["input_axes"],
                                  output_axes=spec["output_axes"],
                                  pad_values=spec["pad_values"])
    jcm.warmup()

    port = models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                           max_length=MAXLEN, dropout=0.0, use_decoder=False,
                           use_classifier=False, device="cpu")
    params_from_jax(port, {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()})
    pspec = models.serve_spec("bert_encoder")
    assert pspec == spec
    cm = serve.CompiledModel(port, serve.BucketTable(TABLE),
                             pspec["input_axes"], example,
                             output_axes=pspec["output_axes"],
                             pad_values=pspec["pad_values"])
    warm = cm.warmup()
    assert warm["compiled"] == warm["buckets"] == 4

    reqs = _requests()
    want = _serve(jax_serve.DynamicBatcher(jcm, max_delay_ms=20).start(),
                  reqs)
    batcher = serve.DynamicBatcher(cm, max_delay_ms=20).start()
    got = _serve(batcher, reqs)
    for r, (ws, wp), (gs, gp) in zip(reqs, want, got):
        L = int(r[2])
        assert tuple(gs.shape) == tuple(ws.shape) == (L, 128)
        assert tuple(gp.shape) == tuple(wp.shape) == (128,)
        onp.testing.assert_allclose(gs, ws, atol=ATOL)
        onp.testing.assert_allclose(gp, wp, atol=ATOL)

    snap = batcher.metrics.snapshot(cm)
    info = snap["compile_cache"]
    assert snap["requests"] == len(reqs) and snap["failed"] == 0
    assert info["post_warmup_compiles"] == 0
    assert info["warmup_compiles"] == info["compiles"] == 4
    assert info["hits"] == snap["batches"] and info["misses"] == 0
    assert set(snap) == set(jax_serve.ServeMetrics().snapshot(jcm))
    assert set(info) == set(jcm.cache_info())

    # predict() slices bucket padding off and counts a hit
    seq, pooled = cm.predict(*(onp.stack([a, a]) for a in reqs[0]))
    assert seq.shape == (2, int(reqs[0][2]), 128) and pooled.shape == (2, 128)
    onp.testing.assert_allclose(seq.asnumpy()[0], got[0][0], atol=ATOL,
                                rtol=0)
    assert cm.cache_info()["post_warmup_compiles"] == 0


def test_compiled_model_counters_and_batcher_guards():
    port = models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                           max_length=MAXLEN, num_layers=1,
                           use_decoder=False, use_classifier=False,
                           device="cpu")
    spec = models.serve_spec("bert_encoder")
    example = (onp.ones((1, 8), "int32"), onp.zeros((1, 8), "int32"),
               onp.full((1,), 8, "float32"))
    cm = serve.CompiledModel(port, serve.BucketTable({"batch": (1, 2),
                                                      "seq": (8, 16)}),
                             spec["input_axes"], example,
                             output_axes=spec["output_axes"],
                             pad_values=spec["pad_values"])
    # no warmup: the first run of a bucket is a miss and a "compile"
    ids = onp.ones((1, 5), "int32")
    cm.predict(ids, ids * 0, onp.array([5.0], "float32"))
    cm.predict(ids, ids * 0, onp.array([5.0], "float32"))
    info = cm.cache_info()
    assert (info["misses"], info["hits"], info["compiles"]) == (1, 1, 1)
    with pytest.raises(serve.BucketOverflow):
        cm.predict(onp.ones((3, 5), "int32"), onp.zeros((3, 5), "int32"),
                   onp.full((3,), 5.0, "float32"))
    b = serve.DynamicBatcher(cm, queue_limit=1)    # never started
    with pytest.raises(MXNetError, match="rank"):
        b.submit(ids, ids[0], onp.array(5.0, "float32"))
    with pytest.raises(serve.BucketOverflow):
        b.submit(onp.ones(17, "int32"), onp.zeros(17, "int32"),
                 onp.array(17.0, "float32"))
    f = b.submit(ids[0], ids[0] * 0, onp.array(5.0, "float32"))
    with pytest.raises(serve.QueueFullError):
        b.submit(ids[0], ids[0] * 0, onp.array(5.0, "float32"))
    b.stop()
    with pytest.raises(MXNetError, match="batcher stopped"):
        f.result(timeout=1)
    assert b.metrics.snapshot()["rejected"] == 1
