"""PyTorch port: ``mx.fault`` (checkpoints, guards, watchdog, retry, chaos)
and the resumable trainers, held against the JAX package on the CPU.

- The parameter order of ``ShardedTrainer`` is the JAX trainer's (sorted
  Gluon names), and one step's gradient norm matches the JAX trainer's
  (rtol 1e-5: fp32 sums in another order).
- Checkpoint directories cross the packages both ways (arrays bitwise,
  meta equal); the corrupt, bit-flip, same-step re-save and kill-mid-save
  cases of ``tests/test_fault.py:69-168`` hold in the port; a JAX two-host
  checkpoint loads in the port.
- Kill and resume on the port's ``ShardedTrainer`` at ``bert_2_128_2``,
  dropout 0.1, on the eager step and on the fused step's function
  (``_fused_step(capture=False)``): every loss, parameter and optimizer
  state bitwise equal to a run never interrupted.
- Resume across the packages, float32, dropout 0, SGD with momentum: the
  JAX trainer runs 2 steps and saves, the port restores and runs step 3,
  and the reverse; loss and parameters within 1e-5 (atol and rtol) of the
  other package's step 3 (summation order over 3 updates). ``nan_batch``
  poisons BERT's first float data argument, ``valid_length``, which masks
  every key and leaves the loss finite: neither package's guard trips.
- ``StepGuard`` policies against the JAX guard on one verdict sequence
  (counters, history, exceptions, exactly); a rollback leaves every
  parameter's and state's ``data_ptr`` and value as before the step.
- ``gluon.Trainer`` checkpoints both ways (parameters and states bitwise).
- ``ChaosMonkey`` draws equal to the JAX monkey's under one seed,
  ``MXTPU_CHAOS`` parsed alike, the watchdog flagging a ``slow_prob``
  step, ``call_with_retry`` alike.
- ``LossScaler(guard=)`` against the JAX scaler (scale, counters, the
  guard's counters and exceptions, exactly).
"""
import json
import os
import re
import warnings

import jax
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu import models as jax_models
from incubator_mxnet_tpu import parallel as jax_parallel
from incubator_mxnet_tpu.fault import inject as jinject
from incubator_mxnet_tpu.fault import retry as jretry
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import amp, fault, gluon, models, parallel
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.fault import inject
from incubator_mxnet_tpu_torch.fault import retry
from incubator_mxnet_tpu_torch.ndarray.serialization import BFLOAT16

VOCAB, L, B, P = 400, 32, 4, 5
SGD = {"learning_rate": 0.05, "momentum": 0.9}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_chaos():
    """Chaos never leaks across tests, in either package."""
    inject.disable()
    jinject.disable()
    yield
    inject.disable()
    jinject.disable()


def _batch(seed=0):
    rng = onp.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, L)).astype("int32")
    tt = rng.randint(0, 2, (B, L)).astype("int32")
    vl = onp.array([L, 20, 7, 1], "float32")
    pos = rng.randint(0, L, (B, P)).astype("int32")
    lab = rng.randint(0, VOCAB, (B, P)).astype("float32")
    w = onp.ones((B, P), "float32")
    nsp = rng.randint(0, 2, (B,)).astype("float32")
    return ids, tt, vl, pos, lab, w, nsp


def _suffix(name: str) -> str:
    """A Gluon name without its model's instance prefix."""
    return re.sub(r"^bertmodel\d+_", "", name)


def _port_bert(arrays=None, dropout=0.0, **kw):
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                          dropout=dropout, device="cpu")
    if arrays is not None:
        params_from_jax(net, arrays)
    kw.setdefault("optimizer", "sgd")
    kw.setdefault("optimizer_params", SGD)
    return net, parallel.ShardedTrainer(net, models.bert_pretrain_loss,
                                        device="cpu", n_labels=3, **kw)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``ShardedTrainer`` (fused, SGD with momentum, a ``warn``
    guard that reads the loss and the norm) at ``bert_2_128_2``, dropout
    0: initial weights, three steps' losses and norms, a checkpoint after
    step 2, the weights after step 3; then one ``nan_batch`` step."""
    root = str(tmp_path_factory.mktemp("jax_ckpt"))
    batch = _batch()
    net = jax_models.get_bert("bert_2_128_2", vocab_size=VOCAB, max_length=L,
                              dropout=0.0, dtype="float32")
    jmx.random.seed(0)
    net.initialize()
    net(*(jmx.nd.array(x) for x in batch[:4]))
    arrays = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    guard = jfault.StepGuard("warn")
    tr = jax_parallel.ShardedTrainer(
        net, jax_models.bert_pretrain_loss, "sgd", dict(SGD),
        mesh=jax_parallel.make_mesh(devices=jax.devices()[:1]), n_labels=3,
        fused=True, guard=guard)
    losses, norms = [], []
    for t in (1, 2, 3):
        losses.append(float(tr.step(*batch).asnumpy()))
        norms.append(tr.last_grad_norm)
        if t == 2:
            tr.save_checkpoint(root)
    tr.sync_to_block()
    weights = {_suffix(k): p.data().asnumpy()
               for k, p in net.collect_params().items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jinject.chaos(seed=0, nan_prob=1.0):
            tr.step(*batch)
    return {"batch": batch, "arrays": arrays, "root": root, "trainer": tr,
            "net": net, "losses": losses, "norms": norms,
            "weights": weights, "names": sorted(net.collect_params()),
            "nan_tripped": guard.tripped}


def test_parameter_order_is_the_jax_trainers(jax_run):
    """The repaired order: a Gluon block's parameters sorted by Gluon name
    (checkpoints key arrays by this position), and the same gradient
    norm as the JAX trainer's first step."""
    _, tr = _port_bert(jax_run["arrays"])
    tr.step(*jax_run["batch"])
    got = [_suffix(tr._optimizer.idx2name[i])
           for i in range(len(tr._params))]
    assert got == [_suffix(n) for n in jax_run["names"]]
    assert len(got) == 38
    onp.testing.assert_allclose(tr.last_grad_norm, jax_run["norms"][0],
                                rtol=1e-5)


def _flip(path, offset):
    blob = bytearray(open(path, "rb").read())
    blob[offset] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))


@pytest.mark.chaos
def test_checkpoint_files(tmp_path):
    """Directories written by either package load in the other (arrays
    bitwise, bfloat16 and 0-d included, meta equal); then the failure
    cases of ``tests/test_fault.py:69-168`` on the port, and a JAX two-host
    (sharded) checkpoint read by the port."""
    rng = onp.random.RandomState(0)
    bits = rng.randint(0, 1 << 16, (3, 4)).astype("<u2")
    arrs = {"w": rng.randn(3, 5).astype("float32"),
            "i": onp.arange(7, dtype="int32"),
            "s": onp.float32(2.5)}
    meta = {"step": 4, "nested": {"a": [1, 2]}}
    for save, load, bf16 in (
            (fault.save_checkpoint, jfault.load_checkpoint,
             bits.view(BFLOAT16)),
            (jfault.save_checkpoint, fault.load_checkpoint,
             bits.view(jax.numpy.bfloat16))):
        root = str(tmp_path / save.__module__.split(".")[0])
        save(root, dict(arrs, bf=bf16), meta, step=4)
        got, got_meta, step = load(root, 4)
        assert step == 4 and got_meta == meta and set(got) == set(arrs) | {
            "bf"}
        for k, v in arrs.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            onp.testing.assert_array_equal(got[k], v)
        assert got["bf"].dtype.itemsize == 2
        onp.testing.assert_array_equal(
            onp.ascontiguousarray(got["bf"]).view("<u2"), bits)

    # the failure cases, one at a time; each names itself on failure
    def corrupt(root):
        fault.save_checkpoint(root, {"w": onp.arange(8, dtype="f")}, step=1)
        fault.save_checkpoint(root, {"w": onp.arange(8, dtype="f")}, step=2)
        apath = os.path.join(root, "step-0000000002", "arrays.params")
        blob = open(apath, "rb").read()
        with open(apath, "wb") as f:
            f.write(blob[:-6])
        with pytest.raises(fault.CheckpointCorruptError):
            fault.load_checkpoint(root, 2)
        with pytest.warns(UserWarning, match="corrupt"):
            assert fault.load_latest(root)[2] == 1

    def bitflip(root):
        fault.save_checkpoint(root, {"w": onp.zeros(16, "f")}, step=5)
        _flip(os.path.join(root, "step-0000000005", "arrays.params"), 60)
        with pytest.raises(fault.CheckpointCorruptError, match="checksum"):
            fault.load_checkpoint(root, 5)
        with pytest.warns(UserWarning), \
                pytest.raises(fault.CheckpointError):
            fault.load_latest(root)

    def same_step_resave(root):
        fault.save_checkpoint(root, {"w": onp.full(3, 5.0, "f")}, step=7)
        os.replace(os.path.join(root, "step-0000000007"),
                   os.path.join(root, "step-0000000007.replaced"))
        assert fault.list_checkpoints(root) == [7]
        assert fault.load_latest(root)[0]["w"][0] == 5.0
        fault.save_checkpoint(root, {"w": onp.zeros(3, "f")}, step=7)
        assert not [d for d in os.listdir(root) if d.endswith(".replaced")]
        assert fault.load_latest(root)[0]["w"][0] == 0.0

    def kill_mid_save(root):
        arr = {"w": onp.full(4, 7.0, "f")}
        fault.save_checkpoint(root, arr, step=1)
        for step, site in ((2, "checkpoint.finalize"),
                           (3, "checkpoint.arrays")):
            with inject.chaos(seed=0, crash_sites=[site]):
                with pytest.raises(inject.ChaosCrash):
                    fault.save_checkpoint(root, {"w": onp.zeros(4, "f")},
                                          step=step)
            assert fault.list_checkpoints(root) == [1]
            assert jfault.list_checkpoints(root) == [1]
            loaded, _, got = fault.load_latest(root)
            assert got == 1 and loaded["w"][0] == 7.0
        fault.save_checkpoint(root, arr, step=4)   # retention clears temps
        assert not [d for d in os.listdir(root) if d.startswith(".tmp-")]
        # nd.save dies mid-write: the old file stands, no temporary left
        f = os.path.join(root, "w.params")
        mx.nd.save(f, {"w": mx.nd.array(onp.ones(3, "f"), ctx=mx.cpu())})
        with inject.chaos(seed=0, crash_sites=["nd.save"]):
            with pytest.raises(inject.ChaosCrash):
                mx.nd.save(f, {"w": mx.nd.array(onp.zeros(3, "f"),
                                                 ctx=mx.cpu())})
        assert mx.nd.load(f)["w"].asnumpy()[0] == 1.0
        assert os.listdir(root).count("w.params") == 1 and not [
            d for d in os.listdir(root) if ".tmp-" in d]

    def two_host(root):
        arr = {"w": onp.full(4, 7.0, "f"), "b": onp.arange(3, dtype="f")}
        for idx in (1, 0):
            jfault.save_checkpoint(root, arr, step=3, process_index=idx,
                                   process_count=2)
        man = json.load(open(os.path.join(root, "step-0000000003",
                                          "manifest.json")))
        assert sorted(man["shards"]) == ["0", "1"]
        loaded, _, step = fault.load_latest(root)
        assert step == 3 and set(loaded) == {"w", "b"}
        onp.testing.assert_array_equal(loaded["w"], arr["w"])
        # the port's multi-host writer, read back by the JAX package
        for idx in (1, 0):
            fault.save_checkpoint(root, arr, step=4, process_index=idx,
                                  process_count=2)
        loaded, _, step = jfault.load_latest(root)
        assert step == 4 and set(loaded) == {"w", "b"}
        onp.testing.assert_array_equal(loaded["b"], arr["b"])

    for case in (corrupt, bitflip, same_step_resave, kill_mid_save,
                 two_host):
        case(str(tmp_path / case.__name__))


def _resume_run(path: str, dropout: float, root: str) -> dict:
    """Kill and resume at ``bert_2_128_2`` (AdamW): run U 6 steps saving
    at step 3; run K saves at 3 and dies saving at 5; a fresh trainer R
    restores step 3 and runs 4-6. ``path`` is ``eager`` (``step``) or
    ``fused`` (the fused function uncaptured)."""
    batch = _batch(1)

    def build():
        torch.manual_seed(0)
        return _port_bert(dropout=dropout, optimizer="adamw",
                          optimizer_params={"learning_rate": 1e-3},
                          seed=3)[1]

    def step(tr):
        if path == "eager":
            return float(tr.step(*batch))
        if tr._params is None:
            tr._init_state()
        return float(tr._fused_step(tr.place(*batch), capture=False))

    u = build()
    ref = [step(u) for _ in range(3)]
    u.save_checkpoint(os.path.join(root, "u"), keep=2)
    ref += [step(u) for _ in range(3)]
    k = build()
    for t in range(1, 6):
        step(k)
        if t == 3:
            k.save_checkpoint(os.path.join(root, "k"), keep=2)
    with inject.chaos(seed=0, crash_sites=["checkpoint.arrays"]):
        with pytest.raises(inject.ChaosCrash):
            k.save_checkpoint(os.path.join(root, "k"), keep=2)
    assert fault.list_checkpoints(os.path.join(root, "k")) == [3]
    r = build()
    step(r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # Gluon prefixes differ
        assert r.restore_checkpoint(os.path.join(root, "k")) == 3
    assert r.num_update == 3
    got = [step(r) for _ in range(3)]
    return {"u": u, "r": r, "ref": ref, "got": got}


@pytest.mark.chaos
def test_kill_and_resume_is_bitwise(tmp_path):
    for path in ("eager", "fused"):
        run = _resume_run(path, 0.1, str(tmp_path / path))
        u, r = run["u"], run["r"]
        assert run["got"] == run["ref"][3:], path
        assert r.num_update == u.num_update == 6
        for a, b in zip(u._params, r._params):
            assert torch.equal(a, b), path
        for a, b in zip(u._state_tensors(), r._state_tensors()):
            assert torch.equal(a, b), path
        assert torch.equal(u.generator.get_state(), r.generator.get_state())


def test_resume_across_the_packages(jax_run, tmp_path):
    """JAX saves after step 2, the port restores and runs step 3; the port
    saves after step 2, JAX restores and runs step 3."""
    batch = jax_run["batch"]
    port_net, tr = _port_bert(jax_run["arrays"])
    tr.step(*batch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tr.restore_checkpoint(jax_run["root"]) == 2
    assert tr.num_update == 2 and tr.last_restore_meta["t"] == 2
    loss3 = float(tr.step(*batch))
    onp.testing.assert_allclose(loss3, jax_run["losses"][2], rtol=1e-5,
                                atol=1e-5)
    got = {_suffix(p.name): p.data().asnumpy()
           for p in port_net.collect_params().values()}
    assert set(got) == set(jax_run["weights"])
    for k, want in jax_run["weights"].items():
        onp.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-5,
                                    err_msg=k)

    port_net, tr = _port_bert(jax_run["arrays"])
    losses = [float(tr.step(*batch)) for _ in range(2)]
    root = str(tmp_path / "port")
    tr.save_checkpoint(root)
    losses.append(float(tr.step(*batch)))
    jtr = jax_run["trainer"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert jtr.restore_checkpoint(root) == 2
    jloss3 = float(jtr.step(*batch).asnumpy())
    onp.testing.assert_allclose(jloss3, losses[2], rtol=1e-5, atol=1e-5)
    jtr.sync_to_block()
    want = {_suffix(p.name): p.data().asnumpy()
            for p in port_net.collect_params().values()}
    for k, p in jax_run["net"].collect_params().items():
        onp.testing.assert_allclose(p.data().asnumpy(), want[_suffix(k)],
                                    rtol=1e-5, atol=1e-5, err_msg=k)
    # nan_batch poisons valid_length, which masks every key: no trip
    assert jax_run["nan_tripped"] == 0
    guard = fault.StepGuard("warn")
    tr._guard = guard
    with inject.chaos(seed=0, nan_prob=1.0) as monkey:
        tr.step(*batch)
    assert monkey.log[0] == ("nan_batch", True) and guard.tripped == 0


@pytest.mark.chaos
def test_step_guard_policies_match_jax():
    """One verdict sequence through both packages' guards under each
    policy; then a port rollback in place."""
    seq = [(True, 1.0), (False, None), (True, 50.0), (True, float("nan")),
           (True, 2.0)] + [(False, None)] * 3
    for policy in ("warn", "skip_and_rollback", "halt"):
        trips = ([], [])
        guards = [pkg.StepGuard(policy, grad_norm_limit=10.0,
                                max_consecutive=2,
                                on_trip=lambda g, info, k=k:
                                trips[k].append(info["reason"]))
                  for k, pkg in enumerate((jfault, fault))]
        outcome = ([], [])
        for step, (ok, gn) in enumerate(seq):
            for k, g in enumerate(guards):
                reason = g.is_bad(ok, gn)
                if reason is None:
                    g.good_step()
                    outcome[k].append("good")
                    continue
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        outcome[k].append(g.decide(step, reason))
                except (jfault.NonFiniteError, fault.NonFiniteError) as e:
                    outcome[k].append(("raised", str(e)))
        assert outcome[0] == outcome[1], policy
        assert trips[0] == trips[1], policy
        j, p = guards
        assert (j.tripped, j.skipped, j.history, j._consecutive) == \
            (p.tripped, p.skipped, p.history, p._consecutive), policy
    assert outcome[1][1][0] == "raised"      # halt: the first bad step

    with mx.cpu():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(16, activation="relu", in_units=12),
                gluon.nn.Dense(4, in_units=16))
        net.initialize()
    guard = fault.StepGuard("skip_and_rollback")
    tr = parallel.ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "adamw", {"learning_rate": 1e-2},
                                 device="cpu", guard=guard)
    rng = onp.random.RandomState(0)
    x = rng.randn(8, 12).astype("float32")
    y = rng.randint(0, 4, (8,)).astype("float32")
    for _ in range(2):
        tr.step(x, y)
    live = list(tr._params) + tr._state_tensors()
    ptrs = [t.data_ptr() for t in live]
    before = [t.detach().clone() for t in live]
    with inject.chaos(seed=0, nan_prob=1.0), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr.step(x, y)
    assert guard.tripped == guard.skipped == 1 and tr.num_update == 2
    assert guard.history == [(3, "non-finite loss/grad")]
    assert tr.last_finite is False
    now = list(tr._params) + tr._state_tensors()
    assert [t.data_ptr() for t in now] == ptrs
    for a, b in zip(before, now):
        assert torch.equal(a, b)
    tr.step(x, y)
    assert tr.num_update == 3 and tr.last_finite and guard._consecutive == 0


def test_gluon_trainer_checkpoints_both_ways(tmp_path):
    """The port's ``gluon.Trainer`` (Adam) saves after 2 steps and a fresh
    JAX trainer restores it; JAX steps once more and saves; a fresh port
    trainer restores that."""
    rng = onp.random.RandomState(0)
    x = rng.randn(8, 12).astype("float32")
    y = rng.randint(0, 4, (8,)).astype("float32")

    def build(pkg):
        net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=12),
                    pkg.gluon.nn.Dense(4, in_units=16))
        net.initialize()
        return net, pkg.gluon.Trainer(net.collect_params(), "adam",
                                      {"learning_rate": 1e-2})

    def step(pkg, net, tr):
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y)).mean()
        loss.backward()
        tr.step(1)

    def values(net):
        return {re.sub(r"^mlp\d*_", "", k): p.data().asnumpy()
                for k, p in net.collect_params().items()}

    with mx.cpu():
        pnet, ptr = build(mx)
        for _ in range(2):
            step(mx, pnet, ptr)
        proot = str(tmp_path / "port")
        ptr.save_checkpoint(proot)
    jnet, jtr = build(jmx)
    assert jtr.restore_checkpoint(proot) == 2
    assert jtr.optimizer.num_update == 2
    for k, v in values(pnet).items():
        onp.testing.assert_array_equal(values(jnet)[k], v, err_msg=k)
    step(jmx, jnet, jtr)
    jroot = str(tmp_path / "jax")
    jtr.save_checkpoint(jroot)
    # the restored trainer's own per-index counts start again (both
    # packages), so JAX's num_update is still 2 after one more step
    assert jtr.optimizer.num_update == 2
    with mx.cpu():
        qnet, qtr = build(mx)
        assert qtr.restore_checkpoint(jroot) == 2
    assert qtr.optimizer.num_update == 2
    for k, v in values(jnet).items():
        onp.testing.assert_array_equal(values(qnet)[k], v, err_msg=k)
    for i, st in jtr._states.items():
        assert len(qtr._states[i]) == len(st)
        for a, b in zip(st, qtr._states[i]):
            onp.testing.assert_array_equal(onp.asarray(a), b.numpy())


@pytest.mark.chaos
def test_chaos_watchdog_and_retry(monkeypatch):
    """The monkey's draws, ramps and crash arming under one seed, equal to
    the JAX monkey's; ``MXTPU_CHAOS`` parsed alike; the watchdog flags a
    ``slow_prob`` step; ``call_with_retry`` alike."""
    knobs = dict(seed=7, nan_prob=0.3, slow_prob=0.5, leak=0.2,
                 decode_block_exhaustion=0.4, grad_blowup=0.5,
                 crash_sites=["nd.save"], crash_count=2)
    a, b = inject.ChaosMonkey(**knobs), jinject.ChaosMonkey(**knobs)
    for m in (a, b):
        for _ in range(6):
            for site in ("nan_batch", "slow_step", "kv_drop",
                         "decode_block_exhaustion"):
                m.should(site)
            m.scale_ramp("grad_blowup")
        m.armed("nd.save"), m.armed("nd.save"), m.armed("nd.save")
    assert a.log == b.log and a._ramp == b._ramp and a._armed == b._armed
    assert a.scale_ramp("grad_blowup") == b.scale_ramp("grad_blowup")
    spec = "seed=3, nan_prob=0.25,crash=nd.save,crash=checkpoint.arrays," \
           "host_kill=9,delay_s=0.5"
    monkeypatch.setenv("MXTPU_CHAOS", spec)
    try:
        got = [mod.enable_from_env() for mod in (inject, jinject)]
    finally:
        inject.disable()
        jinject.disable()
    assert got[0].probs == got[1].probs and got[0].seed == 3
    assert got[0]._armed == got[1]._armed and got[0].delay_s == 0.5
    assert got[0].host_kill_step == got[1].host_kill_step == 9
    monkeypatch.setenv("MXTPU_CHAOS", "seed")
    with pytest.raises(mx.MXNetError, match="cannot parse"):
        inject.enable_from_env()
    monkeypatch.delenv("MXTPU_CHAOS")

    with mx.cpu():
        net = gluon.nn.Dense(4, in_units=6)
        net.initialize()
    wd = fault.Watchdog(deadline=0.05)
    tr = parallel.ShardedTrainer(net, gluon.loss.L2Loss(), "sgd",
                                 {"learning_rate": 0.1}, device="cpu",
                                 watchdog=wd)
    x, y = onp.ones((2, 6), "float32"), onp.zeros((2, 4), "float32")
    tr.step(x, y)
    assert tr.watchdog is wd and not wd.flags
    with inject.chaos(seed=0, slow_prob=1.0, delay_s=0.3), \
            pytest.warns(UserWarning, match="watchdog"):
        tr.step(x, y)
    assert [f.step for f in wd.flags] == [2]
    assert wd.flags[0].elapsed >= 0.05 and wd.flags[0].compiles == 0
    adaptive = fault.Watchdog()
    assert adaptive.deadline_for_step() == 300.0
    for _ in range(3):                  # the first watched step is dropped
        with adaptive.watch(step=0):
            pass
    assert adaptive.deadline_for_step() == 2.0

    for mod in (retry, jretry):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("down")
            return "up"

        seen = []
        policy = mod.RetryPolicy(retries=3, base_delay=0.0)
        assert mod.call_with_retry(flaky, policy,
                                   on_retry=lambda k, e: seen.append(k)) \
            == "up"
        assert seen == [0, 1] and len(calls) == 3
        def gone():
            raise OSError("gone")

        with pytest.raises(mod.RetryExhausted) as err:
            mod.call_with_retry(gone, mod.RetryPolicy(retries=1,
                                                      base_delay=0.0))
        assert isinstance(err.value.last, OSError)
        monkeypatch.setenv("MXNET_KVSTORE_RETRIES", "7")
        assert mod.RetryPolicy.from_env().retries == 7
        assert mod.RetryPolicy().delay(10) == 2.0     # capped


def test_loss_scaler_guard_matches_jax():
    """Overflow and clean steps through both packages' scalers, each with
    a guard of each policy: the scale, the counters, the guard's counters
    and the step at which ``halt`` / ``max_consecutive`` raise."""
    seq = [False, True, False, True, True, True, False, True]
    for policy in ("warn", "skip_and_rollback", "halt"):
        runs = []
        for pkg_fault, pkg_amp in ((jfault, jamp), (fault, amp)):
            guard = pkg_fault.StepGuard(policy, max_consecutive=2)
            s = pkg_amp.LossScaler(init_scale=8.0, scale_window=2,
                                   guard=guard)
            trace = []
            for overflow in seq:
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        s.update_scale(overflow)
                    trace.append(s.loss_scale)
                except pkg_fault.NonFiniteError as e:
                    trace.append(("raised", str(e)))
            runs.append((trace, s.overflows, s.steps, guard.tripped,
                         guard.skipped, guard.history))
        assert runs[0] == runs[1], policy
    with mx.cpu():
        net = gluon.nn.Dense(3, in_units=2)
        net.initialize()
    net.weight._var.grad = torch.tensor([[1.0, float("inf")]] * 3)
    assert amp.LossScaler().has_overflow([net.weight, net.bias])
    net.weight._var.grad = torch.ones(3, 2)
    assert not amp.LossScaler().has_overflow([net.weight, net.bias])
