"""PyTorch port: serving from an exported artifact, held against the JAX
package on the CPU.

- ``serve.export_for_serving`` and ``CompiledModel`` over the imported
  ``SymbolBlock`` (artifact mode) give the JAX artifact ``CompiledModel``'s
  rows for ragged requests, and the block-mode model's exactly; a bucket
  the artifact lacks raises the JAX message; ``set_weights`` in place
  reaches the served buckets with no capture.
- ``ModelRegistry.load(artifacts=, ckpt_root=)``: the same checkpoint (the
  port's ``gluon.Trainer`` wrote it, prefix names) over both packages'
  artifacts gives the same rows; a checkpoint matching no name raises.
- ``ArtifactCache``: put/get keyed by the bucket geometry, a corrupted
  entry evicted and reported as a miss, the ``corrupt_artifact`` chaos
  site (JAX ``tests/test_router.py::TestArtifactCache``).
- ``Replica.load(cache=)``: a miss builds, writes and loads the artifact;
  a restart loads it back with no model built and no capture after
  warmup; a corrupt entry on restart is rebuilt.
- ``models.serving_example`` (the JAX ``examples/serving.py``) serves
  every request with 0 captures after warmup.

Tolerance: float32 rows within 1e-5 of the JAX package's (observed
~1e-6).
"""
import os

import numpy as onp
import pytest

from incubator_mxnet_tpu import serve as jserve

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, models, nd, serve
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.fault import checkpoint, inject
from incubator_mxnet_tpu_torch.fault.retry import RetryExhausted, RetryPolicy
from test_torch_artifact_common import (  # noqa: F401  (fixtures)
    SPEC, TABLE, close, jax_reference, on_cpu, one_torch_thread,
    port_artifact, port_bert, request, scratch_dir,
)

LOAD = dict(input_axes=SPEC["input_axes"], output_axes=SPEC["output_axes"],
            pad_values=SPEC["pad_values"])
RAGGED = ((1, 5), (2, 12), (2, 16), (1, 9))


def _rows(cm, shapes=RAGGED):
    return [[o.asnumpy() for o in cm.predict(*request(B, L, seed=1))]
            for B, L in shapes]


def test_artifact_compiled_model_matches_jax():
    """Artifact mode: the 4 buckets warm up from the program alone; ragged
    requests give the JAX artifact model's rows and the block-mode model's
    exactly; a bucket outside the export raises as in JAX."""
    art, ref = port_artifact(), jax_reference()
    table = serve.BucketTable(TABLE)
    blk = gluon.SymbolBlock.imports(art["sym_file"], ["a", "b", "c"],
                                    art["params_file"])
    cm = serve.CompiledModel(blk, table, **LOAD)
    assert cm.warmup()["compiled"] == 4
    jcm = jserve.CompiledModel(ref["block"], jserve.BucketTable(TABLE),
                               **LOAD)
    live = serve.CompiledModel(art["net"], table, **LOAD)
    got = _rows(cm)
    for g, w, e in zip(got, _rows(jcm), _rows(live)):
        close(g, w)
        for a, b in zip(g, e):
            assert onp.array_equal(a, b)
    info = cm.cache_info()
    assert info["post_warmup_compiles"] == 0 and info["hits"] == len(RAGGED)
    assert cm.resident_bytes() == sum(
        p.data().asnumpy().nbytes for p in blk.collect_params().values())
    wide = serve.CompiledModel(blk, serve.BucketTable(
        {"batch": (1, 4), "seq": (8, 16)}), **LOAD)
    jwide = jserve.CompiledModel(ref["block"], jserve.BucketTable(
        {"batch": (1, 4), "seq": (8, 16)}), **LOAD)
    with pytest.raises(MXNetError) as port_err:
        wide.predict(*request(4, 8))
    with pytest.raises(Exception) as jax_err:
        jwide.predict(*request(4, 8))
    assert str(port_err.value) == str(jax_err.value)


def test_set_weights_reach_the_served_buckets_without_capture():
    """Weights written by ``SymbolBlock.set_weights`` land in the tensors
    the buckets read: the next rows are the new weights' (the live model
    given the same weights), and nothing is captured again."""
    art = port_artifact()
    blk = gluon.SymbolBlock.imports(art["sym_file"], ["a", "b", "c"],
                                    art["params_file"])
    cm = serve.CompiledModel(blk, serve.BucketTable(TABLE), **LOAD)
    cm.warmup()
    rng = onp.random.RandomState(2)
    new = {k: (p.data().asnumpy() * (1 + 0.1 * rng.rand())).astype("float32")
           for k, p in art["net"]._collect_params_with_prefix().items()}
    before = [p._tensor().data_ptr() for p in blk.collect_params().values()]
    assert blk.set_weights(new) == len(new)
    cm.refresh_params()
    assert [p._tensor().data_ptr()
            for p in blk.collect_params().values()] == before
    twin = port_bert()
    serve.apply_weights(twin, new)
    live = serve.CompiledModel(twin, serve.BucketTable(TABLE), **LOAD)
    for g, w in zip(_rows(cm), _rows(live)):
        for a, b in zip(g, w):
            assert onp.array_equal(a, b)
    assert cm.cache_info()["compiles"] == 4


def test_registry_artifacts_with_checkpoint_match_jax():
    """Both registries cold-load their package's artifact with the same
    checkpoint over it and serve the same rows; a checkpoint whose names
    match nothing raises; a missing manifest fails the load as in JAX."""
    art, ref = port_artifact(), jax_reference()
    root = scratch_dir()
    net = port_bert()
    rng = onp.random.RandomState(3)
    for p in net.collect_params().values():
        w = p.data().asnumpy()
        p.set_data(nd.array((w + 0.05 * rng.randn(*w.shape)
                             ).astype("float32")))
    gluon.Trainer(net.collect_params(), "sgd").save_checkpoint(f"{root}/ck")
    reg, jreg = serve.ModelRegistry(), jserve.ModelRegistry()
    v = reg.load("bert", table=serve.BucketTable(TABLE),
                 artifacts=art["prefix"], ckpt_root=f"{root}/ck",
                 input_names=["a", "b", "c"], **LOAD)
    assert v.source == {"artifacts": art["prefix"], "ckpt_root": f"{root}/ck"}
    jreg.load("bert", table=jserve.BucketTable(TABLE),
              artifacts=ref["sym_file"][:-len("-symbol.json")],
              ckpt_root=f"{root}/ck", input_names=["a", "b", "c"],
              analyze=False, **LOAD)
    got = _rows(reg.get("bert"))
    for g, w in zip(got, _rows(jreg.get("bert"))):
        close(g, w)
    live = serve.CompiledModel(net, serve.BucketTable(TABLE), **LOAD)
    for g, w in zip(got, _rows(live)):
        close(g, w, atol=0)
    assert reg.get("bert").cache_info()["post_warmup_compiles"] == 0
    checkpoint.save_checkpoint(f"{root}/other", {"w": onp.zeros(3)}, {},
                               step=1)
    with pytest.raises(MXNetError, match="matched 0 of the artifact"):
        reg.load("bert", table=serve.BucketTable(TABLE),
                 artifacts=art["prefix"], ckpt_root=f"{root}/other", **LOAD)
    assert reg.models() == {"bert": [1]}
    once = serve.ModelRegistry(retry_policy=RetryPolicy(retries=0))
    with pytest.raises(RetryExhausted, match="x-symbol.json"):
        once.load("x", table=serve.BucketTable(TABLE),
                  artifacts=f"{root}/deploy/x", **LOAD)


def _dense_net():
    net = gluon.nn.HybridSequential(prefix="harouter_")
    with net.name_scope():
        net.add(gluon.nn.Dense(16, activation="relu", in_units=8))
        net.add(gluon.nn.Dense(4, in_units=16))
    net.initialize()
    net.hybridize()
    net(nd.array(onp.zeros((2, 8), "float32")))
    return net


def test_artifact_cache_put_get_keyed_by_geometry():
    """A put writes a verified entry that a get hands back (the imported
    artifact serves the model's function); another bucket geometry, or
    another torch version, is another key."""
    cache = serve.ArtifactCache(os.path.join(scratch_dir(), "cache"))
    table = serve.BucketTable({"batch": (1, 2)})
    net = _dense_net()
    prefix = cache.put("rt", 1, net, table, [{0: "batch"}])
    assert os.path.isfile(f"{prefix}-symbol.json")
    hit_prefix, manifest = cache.get("rt", 1, table, [{0: "batch"}])
    assert hit_prefix == prefix and manifest["input_names"] == ["data"]
    blk = gluon.SymbolBlock.imports(f"{hit_prefix}-symbol.json", ["data"],
                                    f"{hit_prefix}-0000.params")
    x = nd.array(onp.random.RandomState(0).randn(1, 8).astype("float32"))
    onp.testing.assert_array_equal(blk(x).asnumpy(), net(x).asnumpy())
    other = serve.BucketTable({"batch": (1, 4)})
    assert serve.signature_key(other, [{0: "batch"}]) \
        != serve.signature_key(table, [{0: "batch"}])
    assert cache.get("rt", 1, other, [{0: "batch"}]) is None
    assert cache.snapshot() == {"hits": 1, "misses": 1, "corrupt": 0,
                                "puts": 1}


def test_artifact_cache_corrupt_entry_is_evicted():
    """A flipped byte in the weights fails the CRC: the entry is evicted
    and reported as a miss, a put repairs it; the ``corrupt_artifact``
    chaos site does the same damage once."""
    cache = serve.ArtifactCache(os.path.join(scratch_dir(), "cache"))
    table = serve.BucketTable({"batch": (1, 2)})
    net = _dense_net()
    prefix = cache.put("corrupt", 1, net, table, [{0: "batch"}])
    params = f"{prefix}-0000.params"
    with open(params, "r+b") as f:
        f.seek(os.path.getsize(params) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    assert cache.get("corrupt", 1, table, [{0: "batch"}]) is None
    assert cache.snapshot()["corrupt"] == 1
    assert not os.path.isdir(os.path.dirname(prefix))
    cache.put("corrupt", 1, net, table, [{0: "batch"}])
    assert cache.get("corrupt", 1, table, [{0: "batch"}]) is not None
    with inject.chaos(seed=3, crash_sites=["corrupt_artifact"]):
        assert cache.get("corrupt", 1, table, [{0: "batch"}]) is None
        cache.put("corrupt", 1, net, table, [{0: "batch"}])
        assert cache.get("corrupt", 1, table, [{0: "batch"}]) is not None
    assert cache.snapshot() == {"hits": 2, "misses": 0, "corrupt": 2,
                                "puts": 3}


def test_replica_restarts_from_the_cache():
    """``Replica.load(cache=, factory=)``: the first boot misses, builds
    the model, writes the entry and serves from it; a kill and restart
    hits the cache and builds no model, with no capture after warmup; an
    entry corrupted before the next restart is rebuilt from the
    factory."""
    cache = serve.ArtifactCache(os.path.join(scratch_dir(), "cache"))
    table = serve.BucketTable({"batch": (1, 2)})
    built = []

    def factory():
        built.append(1)
        return _dense_net()

    def loader(rep):
        rep.load("mlp", table=table, input_axes=[{0: "batch"}],
                 factory=factory, cache=cache,
                 output_axes=[{0: "batch"}], analyze=False)

    rep = serve.Replica("solo", loader, max_delay_ms=2)
    rep.start()
    x = onp.ones((8,), "float32")
    first = rep.submit("mlp", x).result(timeout=10)
    assert first.shape == (4,) and built == [1]
    assert cache.snapshot()["misses"] == 1
    rep.kill("test kill")
    rep.restart()
    assert rep.healthy() and built == [1]
    assert cache.snapshot()["hits"] == 1
    onp.testing.assert_array_equal(rep.submit("mlp", x).result(timeout=10),
                                   first)
    cm = rep.registry.get("mlp")
    assert cm._mode == "artifact"
    assert cm.cache_info()["post_warmup_compiles"] == 0
    with inject.chaos(seed=1, crash_sites=["corrupt_artifact"]):
        rep.restart()
    assert rep.healthy() and len(built) == 2
    assert cache.snapshot()["corrupt"] == 1
    rep.stop()


def test_serving_example_serves_with_no_recapture(tmp_path):
    """The JAX ``examples/serving.py`` loop: LeNet exported per bucket,
    cold-loaded into the registry (here with a checkpoint over it),
    mixed-size requests through the batcher; every request served, 0
    captures after warmup."""
    rep = models.serving_example(requests=24, max_batch=4,
                                 export_dir=str(tmp_path))
    assert rep["served"] == 24 and sum(rep["class_histogram"]) == 24
    assert rep["metrics"]["compile_cache"]["post_warmup_compiles"] == 0
    assert rep["metrics"]["compile_cache"]["cached_executables"] == 3
    assert os.path.isfile(tmp_path / "lenet-symbol.json")
    net = models.LeNet()
    net.initialize()
    net(nd.zeros((1, 1, 28, 28)))
    named = sorted(net._collect_params_with_prefix().items())
    root = str(tmp_path / "ck")
    checkpoint.save_checkpoint(
        root, {f"param:{i:04d}": p.data().asnumpy()
               for i, (_, p) in enumerate(named)},
        {"param_names": [n for n, _ in named]}, step=1)
    rep = models.serving_example(requests=8, max_batch=2, ckpt_dir=root,
                                 ctx=mx.cpu())
    assert rep["served"] == 8
    assert rep["metrics"]["compile_cache"]["post_warmup_compiles"] == 0
