"""PyTorch port: ``mx.profiler`` and ``mx.autotune`` held against the JAX
package on the CPU.

- Profiler: the same nest of ``Frame``/``Scope``/``Task``/``Marker`` and
  ``record_span`` calls in both packages gives the same spans (name,
  kind, parent, depth, step), each child's interval inside its parent's;
  ``dumps()`` has the JAX document's keys and each span row the JAX row's
  keys and counts; ``step_report`` has the JAX report's keys. Over the
  port's ``ShardedTrainer``: one ``step`` frame a step with ``place`` and
  ``dispatch`` segments, and ``device_wait`` when a guard reads the step;
  ``save_checkpoint`` publishes ``checkpoint.save``. ``set_state("run")``
  /``"stop"`` drives ``torch.profiler`` and ``dump()`` writes the chrome
  trace atomically to the configured file.
- Autotune: an entry written by either package is read by the other from
  one directory (the same dict, a hit in each's counters); a corrupt entry
  is evicted and counted as a miss in both; ``applied`` fills only the
  knobs the user left unset and restores the environment; the port's
  ``consult`` refuses a banked tile outside ``1..MAX_TILE``, naming the
  knob and the limit (the JAX one returns it). The port's
  ``ShardedTrainer`` consults once and runs its eager step and its fused
  step's function under the entry's knobs (its loss function reads them),
  a refused entry raises at the first step before any update, and
  ``serve.CompiledModel`` runs each bucket under them.
"""
import json
import os
import time

import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import autotune as jautotune
from incubator_mxnet_tpu import profiler as jprofiler

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autotune, fault, gluon, parallel, serve
from incubator_mxnet_tpu_torch import profiler


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("MXTPU_AUTOTUNE_DIR", "MXTPU_AUTOTUNE", "MXTPU_FLASH_BQ",
              "MXTPU_FLASH_BK"):
        monkeypatch.delenv(k, raising=False)
    profiler.reset_spans()
    jprofiler.reset_spans()
    with mx.cpu():
        yield
    profiler.reset_spans()
    jprofiler.reset_spans()


def _nest(prof):
    with prof.Frame("step"):
        with prof.Scope("outer"):
            with prof.Scope("inner"):
                time.sleep(0.002)
        task = prof.Task("task")
        task.start()
        task.stop()
    prof.Marker("m").mark("proc")
    t0 = time.perf_counter()
    prof.record_span("step.place", 0.5, parent="step", step=1, t0=t0)
    prof.record_span("step", 2.0, kind="frame", step=1, t0=t0)
    return prof.recent_spans()


def test_scope_nesting_and_dumps_schema_match_jax():
    got, want = _nest(profiler), _nest(jprofiler)
    key = [(r.name, r.kind, r.parent, r.depth, r.step) for r in got]
    assert key == [(r.name, r.kind, r.parent, r.depth, r.step)
                   for r in want]
    assert [r.name for r in got] == ["inner", "outer", "task", "step",
                                     "step.place", "step"]
    by = {r.name: r for r in got[:4]}
    for child, parent in (("inner", "outer"), ("outer", "step"),
                          ("task", "step")):
        c, p = by[child], by[parent]
        assert p.t_start <= c.t_start
        assert c.t_start + c.dur_ms / 1e3 <= p.t_start + p.dur_ms / 1e3 \
            + 1e-6
    doc, jdoc = json.loads(profiler.dumps()), json.loads(jprofiler.dumps())
    assert sorted(doc) == sorted(jdoc)
    assert sorted(doc["spans"]) == sorted(jdoc["spans"])
    for name, row in doc["spans"].items():
        assert sorted(row) == sorted(jdoc["spans"][name])
        assert row["count"] == jdoc["spans"][name]["count"]
        assert row["kind"] == jdoc["spans"][name]["kind"]
    assert [m["name"] for m in doc["markers"]] == ["m"]
    rep, jrep = profiler.step_report(), jprofiler.step_report()
    assert sorted(rep) == sorted(jrep)
    assert sorted(rep["memory"]) == sorted(jrep["memory"])
    assert rep["steps"] == jrep["steps"] == 2
    assert sorted(rep["segments"]) == sorted(jrep["segments"])
    json.loads(profiler.dumps(reset=True))
    assert profiler.span_records() == {}


def _dense_trainer(**kw):
    mx.random.seed(0)
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize()
    return parallel.ShardedTrainer(
        net, lambda out, label: ((out - label) ** 2).mean(axis=1), "sgd",
        {"learning_rate": 0.1}, device="cpu", n_labels=1, **kw)


def _batch():
    rng = onp.random.RandomState(0)
    return (rng.randn(8, 4).astype("float32"),
            rng.randn(8, 3).astype("float32"))


def test_step_report_over_sharded_trainer(tmp_path):
    tr = _dense_trainer()
    for _ in range(3):
        tr.step(*_batch())
    rep = profiler.step_report()
    assert rep["steps"] == 3
    assert {k: v["count"] for k, v in rep["segments"].items()} == {
        "place": 3, "dispatch": 3, "python": 3}
    profiler.reset_spans()
    guarded = _dense_trainer(guard=fault.StepGuard(policy="warn"))
    for _ in range(3):
        guarded.step(*_batch())
    rep = profiler.step_report()
    assert rep["steps"] == 3 and rep["instrumented_pct"] > 0
    for seg in ("place", "dispatch", "device_wait"):
        assert rep["segments"][seg]["count"] == 3, rep["segments"]
    frames = [r for r in profiler.recent_spans() if r.name == "step"]
    assert [r.step for r in frames] == [1, 2, 3]
    guarded.save_checkpoint(str(tmp_path / "ck"))
    assert profiler.span_records()["checkpoint.save"]["count"] == 1


def test_set_state_and_dump_write_the_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    profiler.set_config(filename=path)
    profiler.set_state("run")
    assert profiler.is_running()
    with profiler.Scope("work"):
        mx.nd.ones((8, 8)).sum().asnumpy()
    profiler.pause()
    assert not profiler.is_running()
    profiler.resume()
    profiler.set_state("stop")
    assert profiler.dump() == path
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    with open(path) as f:
        trace = json.load(f)
    names = [e["name"] for e in trace["traceEvents"] if e["tid"] == 1]
    assert names == ["work"]
    doc = json.loads(profiler.dumps())
    assert doc["trace_dir"] == str(tmp_path)
    assert doc["spans"]["work"]["count"] == 1


def _entry_cfg():
    return {"env": {"MXTPU_FLASH_BQ": 32, "MXTPU_FLASH_BK": 16},
            "geometry": {"batch": 8}}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_autotune_cache_crosses_packages(writer, tmp_path):
    root = str(tmp_path)
    w, r = (jautotune, autotune) if writer == "jax" else (autotune, jautotune)
    assert autotune.chip_kind() == jautotune.chip_kind() == "cpu"
    path = w.AutotuneCache(root).put("bert", "single", "cpu", _entry_cfg(),
                                     1.5, meta={"by": writer})
    assert os.path.isfile(path)
    reader = r.AutotuneCache(root)
    got = reader.get("bert", "single", "cpu")
    assert got["config"] == _entry_cfg() and got["score"] == 1.5
    assert got["meta"] == {"by": writer}
    assert reader.snapshot()["hits"] == 1
    # the "any" mesh key (the search banks under it) is the fallback in both
    w.AutotuneCache(root).put("gpt", "any", "cpu", _entry_cfg(), 2.0)
    assert r.AutotuneCache(root).get("gpt", "dp2", "cpu")["score"] == 2.0
    assert autotune.mesh_desc(None) == jautotune.mesh_desc(None) == "single"


def test_corrupt_entry_evicted_as_miss(tmp_path):
    stats = []
    for lib in (autotune, jautotune):
        root = str(tmp_path / lib.__name__.split(".")[0])
        cache = lib.AutotuneCache(root)
        path = cache.put("bert", "single", "cpu", _entry_cfg(), 1.0)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(text.replace('"score": 1.0', '"score": 9.0'))
        assert cache.get("bert", "single", "cpu") is None
        assert not os.path.exists(path)
        with open(path, "w") as f:
            f.write("{not json")
        assert cache.get("bert", "single", "cpu") is None
        s = cache.snapshot()
        stats.append({k: s[k] for k in ("hits", "misses", "corrupt")})
    assert stats[0] == stats[1] == {"hits": 0, "misses": 2, "corrupt": 2}


def test_user_env_wins_and_out_of_range_tile_refused(tmp_path,
                                                     monkeypatch):
    entry = {"config": _entry_cfg()}
    monkeypatch.setenv("MXTPU_FLASH_BQ", "8")
    for lib in (autotune, jautotune):
        with lib.applied(entry) as env:
            assert env == {"MXTPU_FLASH_BK": "16"}
            assert os.environ["MXTPU_FLASH_BQ"] == "8"
            assert os.environ["MXTPU_FLASH_BK"] == "16"
        assert "MXTPU_FLASH_BK" not in os.environ
        with lib.applied({"config": {"env": {"PATH": "/x"}}}) as env:
            assert env == {}
    root = str(tmp_path)
    monkeypatch.setenv("MXTPU_AUTOTUNE_DIR", root)
    autotune.AutotuneCache(root).put(
        "big", "single", "cpu", {"env": {"MXTPU_FLASH_BK": 128}}, 0.0)
    with pytest.raises(mx.MXNetError, match=r"MXTPU_FLASH_BK=128.*1\.\.64"):
        autotune.consult("trainer.step", "big")
    assert jautotune.consult("trainer.step", "big")["config"]["env"] == {
        "MXTPU_FLASH_BK": 128}
    monkeypatch.setenv("MXTPU_AUTOTUNE", "0")
    assert autotune.consult("trainer.step", "big") is None


def test_trainer_and_compiled_model_consult_and_apply(tmp_path,
                                                      monkeypatch):
    root = str(tmp_path)
    monkeypatch.setenv("MXTPU_AUTOTUNE_DIR", root)
    seen = []

    def loss_fn(out, label):
        seen.append((os.environ.get("MXTPU_FLASH_BQ"),
                     os.environ.get("MXTPU_FLASH_BK")))
        return ((out - label) ** 2).mean(axis=1)

    cache = autotune.AutotuneCache(root)
    cache.put("dense", "single", "cpu", _entry_cfg(), 1.0)
    mx.random.seed(0)
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize()
    tr = parallel.ShardedTrainer(net, loss_fn, "sgd", {"learning_rate": 0.1},
                                 device="cpu", n_labels=1)
    assert tr._autotune_key == "dense"
    tr.step(*_batch())                             # the eager step
    assert tr.last_path == "eager"
    tr._fused_step(tr.place(*_batch()), capture=False)
    assert tr.last_path == "fused"
    assert seen == [("32", "16")] * 2
    assert tr.autotune_entry["config"] == _entry_cfg()
    assert "MXTPU_FLASH_BQ" not in os.environ
    # a banked tile the kernels do not take: the first step raises
    cache.put("bad", "single", "cpu", {"env": {"MXTPU_FLASH_BQ": 0}}, 1.0)
    bad = parallel.ShardedTrainer(net, loss_fn, "sgd", {"learning_rate": 0.1},
                                  device="cpu", n_labels=1,
                                  autotune_key="bad")
    w0 = net.weight.data().asnumpy().copy()
    with pytest.raises(mx.MXNetError, match="MXTPU_FLASH_BQ=0"):
        bad.step(*_batch())
    onp.testing.assert_array_equal(net.weight.data().asnumpy(), w0)
    assert bad.num_update == 0
    # serve.CompiledModel: consulted at construction, buckets under it

    class Probe(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.dense = gluon.nn.Dense(3, in_units=3)

        def hybrid_forward(self, F, x):
            seen.append(os.environ.get("MXTPU_FLASH_BQ"))
            return self.dense(x)

    cache.put("probe", "single", "cpu", _entry_cfg(), 1.0)
    seen.clear()
    probe = Probe()
    probe.initialize()
    cm = serve.CompiledModel(probe, serve.BucketTable({"batch": (1, 2)}),
                             [{0: "batch"}],
                             example_args=[onp.zeros((1, 3), "float32")])
    assert cm.autotune_entry["config"] == _entry_cfg()
    cm.warmup()
    x = onp.ones((1, 3), "float32")
    onp.testing.assert_allclose(cm.predict(x).asnumpy(),
                                probe(mx.nd.array(x)).asnumpy(), rtol=1e-6)
    assert seen[:3] == ["32"] * 3 and seen[3] is None
