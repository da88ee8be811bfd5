"""PyTorch port: the HA serving tier (``serve.Replica``, ``serve.Router``)
on the CPU, in the scenarios of the JAX package's ``tests/test_router.py``
(``:143-441``) without the artifact cache (which waits for the port's
``export``): kill and restart, failover with zero lost accepted requests,
shedding with ``retry_after``, a hedge that wins, stall detection, the
weight pipe (a verified checkpoint applied with no compile, a non-finite
one refused, the background cadence), stop/start, and a hung staged load keeping the active
version. Every wait polls a condition under a deadline.
"""
import threading
import time

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, nd, serve
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.fault import checkpoint as fault_checkpoint
from incubator_mxnet_tpu_torch.fault import inject


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(prefix):
    with mx.cpu():
        mx.random.seed(0)
        net = gluon.nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(gluon.nn.Dense(16, activation="relu", in_units=8))
            net.add(gluon.nn.Dense(4, in_units=16))
        net.initialize()
        net.hybridize()
        net(nd.array(onp.zeros((2, 8), "float32")))
    return net


@pytest.fixture(scope="module")
def ha():
    """One source model for the module; every replica's loader serves it
    through a fresh registry (the factory path: no example_args, the
    block's last call fixes the signature)."""
    net = _mlp("harouter_")
    table = serve.BucketTable({"batch": (1, 2)})

    def loader(rep):
        rep.load("mlp", table=table, input_axes=[{0: "batch"}],
                 factory=lambda: net, output_axes=[{0: "batch"}])

    return {"net": net, "table": table, "loader": loader}


def _router(ha_env, n=2, **kw):
    reps = [serve.Replica(f"r{i}", ha_env["loader"], max_delay_ms=2)
            for i in range(n)]
    kw.setdefault("heartbeat_ms", 40)
    kw.setdefault("request_timeout_s", 15)
    return serve.Router(reps, **kw).start(), reps


def _wait(cond, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"{what} never held within {timeout} s")


def _all_healthy(router):
    _wait(lambda: all(s == "healthy"
                      for s in router.replicas.states().values()),
          what=f"all healthy ({router.replicas.states()})")


def _compiles(reps):
    return [rep.registry.get("mlp").cache_info() for rep in reps]


def test_kill_fails_fast_and_restart_rebuilds(ha):
    rep = serve.Replica("solo", ha["loader"], max_delay_ms=2)
    rep.start()
    x = onp.ones((8,), "float32")
    assert rep.submit("mlp", x).result(timeout=10).shape == (4,)
    first = rep.registry
    rep.kill("test kill")
    assert rep.state == "crashed" and rep.kills == 1
    with pytest.raises(serve.ReplicaUnavailable):
        rep.submit("mlp", x)
    rep.restart()
    assert rep.healthy() and rep.registry is not first
    assert rep.submit("mlp", x).result(timeout=10).shape == (4,)
    assert rep.registry.get("mlp").cache_info()["post_warmup_compiles"] == 0
    with inject.chaos(seed=5, crash_sites=["replica_kill"]):
        with pytest.raises(serve.ReplicaCrashed):
            rep.submit("mlp", x)
    assert rep.state == "crashed" and rep.kills == 2
    rep.stop()
    assert rep.state == "stopped"
    assert rep.snapshot()["restarts"] == 1


def test_failover_zero_lost_accepted_requests(ha):
    router, reps = _router(ha, n=2, retries=3)
    try:
        ok, rejected, errors = [], [], []
        lock = threading.Lock()
        started = threading.Barrier(5)

        def client(cid):
            rng = onp.random.RandomState(cid)
            started.wait()
            for _ in range(25):
                try:
                    router.call("mlp", rng.randn(8).astype("float32"))
                    with lock:
                        ok.append(1)
                except (serve.ShedError, serve.DeadlineExceeded) as e:
                    with lock:
                        rejected.append(e.retry_after)
                except Exception as e:  # noqa: BLE001 — gate evidence
                    with lock:
                        errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        # one replica dies mid-traffic (an armed chaos kill)
        inject.enable(seed=11, crash_sites=["replica_kill"])
        started.wait()
        for t in threads:
            t.join(60)
        inject.disable()
        assert len(ok) + len(rejected) == 100 and not errors
        assert all(r > 0 for r in rejected)
        stats = router.snapshot()["stats"]
        assert stats["accepted"] == 100 and stats["completed"] == len(ok)
        assert sum(rep.kills for rep in reps) == 1
        assert stats["failovers"] >= 1 or rejected
        _all_healthy(router)        # the health loop restarted the victim
        _wait(lambda: router.snapshot()["stats"]["restarts"] == 1)
        assert all(i["post_warmup_compiles"] == 0 for i in _compiles(reps))
    finally:
        inject.disable()
        router.stop()


def test_admission_shedding_with_retry_after(ha):
    router, reps = _router(ha, n=1, tenant_inflight=1, retries=0)
    x = onp.ones((8,), "float32")
    try:
        with router._lock:
            router._inflight["t0"] = 1
        with pytest.raises(serve.ShedError) as ei:
            router.call("mlp", x, tenant="t0")
        assert ei.value.reason == "tenant_limit" and ei.value.retry_after > 0
        with router._lock:
            router._inflight["t0"] = 0
        router.call("mlp", x, tenant="t1")         # another tenant is fine
        # overload: one request wedged in its flush, one queued behind it
        router.set_overload_policy(shed_depth=1)
        cm = reps[0].registry.get("mlp")
        started, release = threading.Event(), threading.Event()

        def wedged(*args, _real=cm.predict):
            started.set()
            release.wait(10)
            return _real(*args)

        cm.predict = wedged
        try:
            held = [reps[0].submit("mlp", x)]
            assert started.wait(5)
            held.append(reps[0].submit("mlp", x))
            with pytest.raises(serve.ShedError) as ei:
                router.call("mlp", x)
            assert ei.value.reason == "overloaded"
        finally:
            release.set()
        for f in held:
            f.result(timeout=10)
        router.set_overload_policy(shed_depth=0)
        reps[0].kill("test")
        with pytest.raises(serve.ShedError) as ei:
            router.call("mlp", x)
        assert ei.value.reason in ("no_healthy_replica",
                                   "placement_exhausted")
        assert ei.value.retry_after > 0
        _all_healthy(router)
        assert router.snapshot()["stats"]["shed"] == 3
    finally:
        router.stop()


def test_hedged_attempt_wins_on_a_slow_replica(ha):
    router, reps = _router(ha, n=2, hedge_ms=30, retries=1)
    try:
        real_submit = reps[0].submit
        reps[0].submit = lambda model, *arrays: serve.ServeFuture()
        try:
            for _ in range(8):
                val, info = router.call_detailed(
                    "mlp", onp.ones((8,), "float32"), timeout_s=5)
                assert val.shape == (4,)
                if info["hedged"]:
                    assert info["replica"] == "r1"
                    break
            stats = router.snapshot()["stats"]
            assert stats["hedges"] >= 1 and stats["hedge_wins"] >= 1
        finally:
            reps[0].submit = real_submit
    finally:
        router.stop()


def test_stall_detection_kills_and_restarts(ha):
    router, reps = _router(ha, n=1, stall_s=0.15, heartbeat_ms=30)
    release = threading.Event()
    try:
        cm = reps[0].registry.get("mlp")
        real_predict = cm.predict
        started = threading.Event()

        def wedged(*args):
            started.set()
            release.wait(10)
            return real_predict(*args)

        cm.predict = wedged
        reps[0].submit("mlp", onp.ones((8,), "float32"))
        assert started.wait(5)
        try:     # a second request queues behind the wedged flush
            reps[0].submit("mlp", onp.ones((8,), "float32"))
        except serve.ReplicaUnavailable:
            pass  # the health loop may have killed it already
        _wait(lambda: reps[0].kills == 1, what="the stall kill")
        release.set()
        _all_healthy(router)
        assert reps[0].restarts == 1
    finally:
        release.set()
        router.stop()


def test_weight_sync_applies_a_verified_checkpoint(ha, tmp_path):
    router, reps = _router(ha, n=2)
    net = ha["net"]
    saved = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    try:
        x = onp.ones((8,), "float32")
        assert onp.abs(router.call("mlp", x)).sum() > 0
        params = sorted(net.collect_params().items())
        root = str(tmp_path / "ckpts")
        meta = {"param_names": [p.name for _, p in params]}
        before = _compiles(reps)
        fault_checkpoint.save_checkpoint(
            root, {f"param:{i:04d}": p.data().asnumpy() * 0.0
                   for i, (_, p) in enumerate(params)}, meta, step=10)
        out = router.sync_weights_once("mlp", root)
        assert out["outcome"] == "applied" and out["step"] == 10
        assert sorted(out["replicas"]) == ["r0", "r1"]
        for rep in reps:
            assert onp.abs(rep.submit("mlp", x).result(timeout=10)).sum() \
                == 0.0
        after = _compiles(reps)
        assert [a["compiles"] for a in after] \
            == [b["compiles"] for b in before]
        assert router.sync_weights_once("mlp", root)["outcome"] \
            == "unchanged"
        reps[0].restart()       # a restart must get the step pushed again
        assert router.sync_weights_once("mlp", root)["outcome"] == "applied"
        fault_checkpoint.save_checkpoint(
            root, {f"param:{i:04d}": onp.full(p.shape, onp.nan, "float32")
                   for i, (_, p) in enumerate(params)}, meta, step=20)
        out = router.sync_weights_once("mlp", root)
        assert out["outcome"] == "rejected" and out["reason"] == "non_finite"
        got = reps[0].submit("mlp", x).result(timeout=10)
        assert not onp.isnan(got).any()
        assert router.snapshot()["stats"]["weight_syncs"] == 2
        empty = str(tmp_path / "none")
        assert router.sync_weights_once("mlp", empty)["outcome"] \
            == "no_checkpoint"
        # the background cadence picks up the next verified step
        fault_checkpoint.save_checkpoint(
            root, {f"param:{i:04d}": p.data().asnumpy() * 0.0
                   for i, (_, p) in enumerate(params)}, meta, step=30)
        router.start_weight_sync("mlp", root, interval_s=0.02)
        _wait(lambda: router.snapshot()["stats"]["weight_syncs"] == 3,
              what="the cadence's sync")
    finally:
        router.stop()
        serve.apply_weights(net, saved)


def test_stop_start_revives_the_tier(ha):
    router, reps = _router(ha, n=1)
    try:
        assert router.call("mlp", onp.ones((8,), "float32")).shape == (4,)
        router.stop()
        assert reps[0].state == "stopped"
        router.start()          # a stopped replica reboots by restarting
        assert router.call("mlp", onp.ones((8,), "float32")).shape == (4,)
        assert reps[0].restarts == 1
    finally:
        router.stop()


def test_hung_staged_load_keeps_the_active_version(ha):
    rep = serve.Replica("hung", ha["loader"], max_delay_ms=2,
                        load_deadline_s=0.3)
    rep.start()
    x = onp.ones((8,), "float32")
    want = rep.submit("mlp", x).result(timeout=10)
    release = threading.Event()

    def hung_factory():
        release.wait(30)        # never returns within the deadline
        return ha["net"]

    t0 = time.monotonic()
    try:
        with pytest.raises(MXNetError, match="deadline"):
            rep.load("mlp", table=ha["table"], input_axes=[{0: "batch"}],
                     factory=hung_factory, version=2)
    finally:
        release.set()
    assert time.monotonic() - t0 < 5
    assert rep.registry.models() == {"mlp": [1]}
    onp.testing.assert_array_equal(rep.submit("mlp", x).result(timeout=10),
                                   want)
    rep.stop()
