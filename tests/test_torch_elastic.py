"""PyTorch port: the elastic control plane held against the JAX package
(the cases of ``tests/test_elastic.py``) and drilled over a real store.

The detection state machine runs on the dict-backed ``LocalTransport``
(an N-process pod simulated in one process): each case drives both
modules on one simulated store and holds the port's ``snapshot()`` equal
to the JAX module's. JAX's flight-bundle case is left out: flight bundles
are telemetry, queue A's item 8; the port records what each bundle would
hold (``elastic.bundles()``), checked here once per dead index. The drill
spawns two gloo ranks (``tests/torch_dist_worker.py``'s
``elastic_drill_case``) with ``MXTPU_ELASTIC=1``: leases go through the
process group's ``TCPStore``, rank 1's ``host_kill`` fires at step 3,
rank 0 raises ``HostLossError`` at its next step and recovers at one rank
from the checkpoint of step 2. Its losses after recovery equal the
uninterrupted two-rank run's within rtol 1e-6 (one rank means the whole
batch where two ranks averaged their halves' means).
"""
import json
import time

import numpy as onp
import pytest

import torch_dist_worker as W

from incubator_mxnet_tpu.fault import inject as jinject
from incubator_mxnet_tpu.parallel import elastic as jelastic
from incubator_mxnet_tpu.telemetry import flight as jflight

from incubator_mxnet_tpu_torch.fault import inject
from incubator_mxnet_tpu_torch.parallel import elastic
from incubator_mxnet_tpu_torch.parallel.elastic import HostLossError

MODS = ((elastic, inject), (jelastic, jinject))


@pytest.fixture(autouse=True)
def _clean_elastic():
    """Control-plane state never leaks across tests, in either package."""
    for el, inj in MODS:
        el.reset()
        inj.disable()
    jflight.set_dir("")
    yield
    for el, inj in MODS:
        el.reset()
        inj.disable()
    jflight.set_dir(None)


def _pods(index=0, count=2, lease=0.5):
    """One simulated member per package, both on one store."""
    store = {}
    for el, _ in MODS:
        el.configure(on=True, lease=lease, heartbeat=0.1,
                     transport=el.LocalTransport(store, index=index,
                                                 count=count))
    return store


def _peer_lease(store, index, t=None, gen=0):
    """Bank a lease on a simulated peer's behalf."""
    store[f"mxtpu/elastic/{gen}/lease/{index}"] = json.dumps(
        {"t": time.time() if t is None else t, "step": None, "beats": 1,
         "pid": 0, "generation": gen, "collective_ms": 0.0})


def _both(fn):
    """``fn(module)`` for the port, then the JAX module: both results, or
    the exception each raised."""
    out = []
    for el, _ in MODS:
        try:
            out.append(fn(el))
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(e)
    return out


def test_disabled_by_default_and_env_knobs(monkeypatch):
    """Off without ``MXTPU_ELASTIC``: no daemon, a silent poll; the knobs
    parse as the JAX ones (the heartbeat a third of the lease; junk falls
    back to the default)."""
    monkeypatch.delenv("MXTPU_ELASTIC", raising=False)
    for el, _ in MODS:
        assert el.enabled() is False
        assert el.start() is False and el.active() is False
        el.poll()
    monkeypatch.setenv("MXTPU_ELASTIC", "1")
    monkeypatch.setenv("MXTPU_ELASTIC_LEASE_S", "6")
    monkeypatch.delenv("MXTPU_ELASTIC_HEARTBEAT_S", raising=False)
    assert _both(lambda el: (el.enabled(), el.lease_s(),
                             el.heartbeat_s())) == [(True, 6.0, 2.0)] * 2
    monkeypatch.setenv("MXTPU_ELASTIC_HEARTBEAT_S", "0.7")
    monkeypatch.setenv("MXTPU_ELASTIC_LEASE_S", "junk")
    assert _both(lambda el: (el.heartbeat_s(), el.lease_s())) \
        == [(0.7, 10.0)] * 2
    # one process, no group: nothing to bank, a single-member pod
    assert _both(lambda el: (el.start(), el.membership())) \
        == [(False, (0, 1))] * 2


def test_beat_banks_own_lease_and_generation_namespaces(monkeypatch):
    """A beat overwrites the process's own key with the JAX fields; the
    generation namespaces the keys, so a dead generation's lease is
    invisible."""
    store = _pods()
    assert elastic.beat(step=7) is True
    doc = json.loads(store["mxtpu/elastic/0/lease/0"])
    assert sorted(doc) == ["beats", "collective_ms", "generation", "pid",
                           "step", "t"]
    assert doc["step"] == 7 and doc["beats"] == 1
    assert elastic.beat() is True
    assert json.loads(store["mxtpu/elastic/0/lease/0"])["beats"] == 2
    elastic.reset()
    monkeypatch.setenv("MXTPU_ELASTIC_GENERATION", "2")
    store = _pods(lease=0.5)
    assert _both(lambda el: el.generation()) == [2, 2]
    elastic.beat()
    assert "mxtpu/elastic/2/lease/0" in store
    now = time.time()
    _peer_lease(store, 1, t=now, gen=1)
    snaps = _both(lambda el: el.check(raise_on_loss=False, now=now + 0.2))
    assert "1" not in snaps[0]["leases"]
    snaps[1]["beats"] = snaps[0]["beats"]      # only the port beat here
    assert snaps[0] == snaps[1]


def test_two_member_loss_detection_matches_jax():
    """The state machine end to end: a fresh peer is healthy; an expired
    lease is a detected loss, raised at check with the dead index and the
    generation; the corpse stays lost without a second raise. Every
    snapshot equals the JAX module's."""
    store = _pods(lease=0.5)
    now = time.time()
    _peer_lease(store, 1, t=now)
    snaps = _both(lambda el: el.check(now=now + 0.1))
    assert snaps[0] == snaps[1]
    assert snaps[0]["lost"] == [] and "1" in snaps[0]["leases"]
    errs = _both(lambda el: el.check(now=now + 1.0))
    assert isinstance(errs[0], HostLossError)
    assert isinstance(errs[1], jelastic.HostLossError)
    assert (errs[0].lost, errs[0].generation) == (errs[1].lost,
                                                  errs[1].generation) \
        == ([1], 0)
    assert "restart" in str(errs[0])
    snaps = _both(lambda el: el.check(now=now + 2.0))
    assert snaps[0] == snaps[1] and snaps[0]["lost"] == [1]
    elastic.poll()           # drained by the raise above


def test_never_banked_peer_gets_grace_period():
    """A peer that never banked is a loss only a lease after the
    watchdog's own start: a slow rendezvous is not a corpse."""
    _pods(lease=0.5)
    for el, _ in MODS:
        el.configure(heartbeat=30.0)           # the daemon stays idle
    try:
        assert _both(lambda el: el.start()) == [True, True]
        assert elastic.active() is True
        now = time.time()
        snaps = _both(lambda el: el.check(now=now + 0.2))
        assert snaps[0]["lost"] == [] == snaps[1]["lost"]
        errs = _both(lambda el: el.check(now=now + 5.0))
        assert isinstance(errs[0], HostLossError) and errs[0].lost == [1]
        assert errs[1].lost == [1]
    finally:
        for el, _ in MODS:
            el.stop()
    assert elastic.active() is False


def test_loss_raises_via_poll_and_records_one_bundle():
    """The daemon's mode: ``check(raise_on_loss=False)`` records, ``poll``
    raises once (the trainer's step boundary). The flight bundle the JAX
    module writes is recorded once per dead index."""
    store = _pods(lease=0.5)
    now = time.time()
    _peer_lease(store, 1, t=now - 10.0)
    snaps = _both(lambda el: el.check(raise_on_loss=False, now=now))
    assert snaps[0] == snaps[1] and snaps[0]["lost"] == [1]
    errs = _both(lambda el: el.poll())
    assert isinstance(errs[0], HostLossError) and errs[0].lost == [1]
    assert _both(lambda el: el.poll()) == [None, None]
    elastic.check(raise_on_loss=False, now=now + 1.0)
    (bundle,) = elastic.bundles()
    assert bundle["reason"] == "host_loss"
    assert bundle["context"]["lost_process"] == 1
    assert bundle["membership"]["lost"] == [1]


def test_host_stall_holds_beats():
    """A process that runs but stops beating: the seeded knob holds the
    beat back and the snapshot counts the stall, as in JAX."""
    _pods()
    for el, inj in MODS:
        inj.enable(seed=1, host_stall=3)
        inj.note_step(2)
        assert el.beat() is True
        inj.note_step(3)
        assert el.beat() is False and el.beat() is False
    snaps = _both(lambda el: el.snapshot())
    assert snaps[0]["beats"] == 1 and snaps[0]["stalled_beats"] == 2
    assert snaps[0] == snaps[1]


def test_snapshot_elects_lowest_survivor():
    """Process 1 of 3 sees process 0 dead: it is the elected primary."""
    store = _pods(index=1, count=3, lease=0.5)
    now = time.time()
    _peer_lease(store, 0, t=now - 10.0)
    _peer_lease(store, 2, t=now)
    snaps = _both(lambda el: el.check(raise_on_loss=False, now=now))
    assert snaps[0] == snaps[1]
    assert snaps[0]["lost"] == [0] and snaps[0]["elected"] == 1
    assert snaps[0]["process"] == {"index": 1, "count": 3}
    with pytest.raises(HostLossError):
        elastic.poll()


def test_two_rank_drill_over_tcp_store(tmp_path, monkeypatch):
    """The drill (module docstring) over the process group's store."""
    monkeypatch.setenv("MXTPU_ELASTIC", "1")
    monkeypatch.setenv("MXTPU_ELASTIC_LEASE_S", "3.0")
    monkeypatch.setenv("MXTPU_ELASTIC_HEARTBEAT_S", "0.1")
    rng = onp.random.RandomState(0)
    arrays = [rng.randn(4).astype("float32") * 0.1,
              rng.randn(4, 6).astype("float32") * 0.3]
    batches = [(rng.randn(8, 6).astype("float32"),
                rng.randn(8, 4).astype("float32")) for _ in range(4)]
    res, code = W.run_ranks("elastic_drill_case", 2, arrays, batches,
                            str(tmp_path), may_die=(1,))
    assert code == -9                        # SIGKILL: the clean corpse
    assert res["active"] and res["transport"] == "StoreTransport"
    assert res["before"] == res["uninterrupted"][:2]
    assert res["snapshot"]["lost"] == [1]
    assert res["snapshot"]["leases"]["1"]["age_s"] > 3.0
    lost, gen, msg = res["raised"]
    assert lost == [1] and gen == 0 and "restart" in msg
    assert res["restored_step"] == 2 and res["generation"] == 1
    assert res["meta"]["elastic"] == {"generation": 0, "process_count": 2}
    onp.testing.assert_allclose(res["after"], res["uninterrupted"][2:],
                                rtol=1e-6)
