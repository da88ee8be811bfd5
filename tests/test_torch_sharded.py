"""PyTorch port: ``ShardedTrainer`` over a mesh of gloo ranks held against
the port on one rank and the JAX mesh trainer on the CPU.

The port's ranks are spawned once, four of them
(``tests/torch_dist_worker.py``: one torch thread each, no JAX); the JAX
trainer runs here on the suite's virtual CPU devices, built once, from the
weights the port's ranks load (``convert.params_from_jax``), at
``bert_2_128_2``, L 32, dropout 0.

Tolerances, float32: sp=4 against sp=1 ``rtol=2e-4, atol=2e-5`` on the
losses (the JAX test's, ``tests/test_parallel.py:250``: the ring merges
hops in another order); dp2 x tp2 with ZeRO-1 against the JAX trainer on
the same mesh: losses and each step's gradient norm rtol 1e-5, weights
after two Adam steps (lr 1e-3) atol 5e-5 (Adam divides the first steps'
moments, so a gradient's last bit of summation order moves a weight by up
to ~lr * 1e-2); the same mesh under SGD (lr 0.1) against the port's one
rank: losses and norms rtol 1e-5, weights rtol 1e-5 atol 1e-6 (the dp
mean of two half-batch means sums in another order); checkpoints bitwise.
"""
import glob
import json
import os

import jax
import numpy as onp
import pytest
import torch

import torch_dist_worker as W

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu import parallel as jparallel

from incubator_mxnet_tpu_torch import parallel

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_net():
    """``bert_2_128_2`` of the JAX package, seeded, and its weights (JAX
    names), which the port's ranks load."""
    net = jmodels.get_bert("bert_2_128_2", vocab_size=W.BERT_VOCAB,
                           max_length=W.BERT_L, dropout=0.0)
    jmx.random.seed(0)
    net.initialize()
    net(*(jmx.nd.array(x) for x in W.bert_batches(1)[0][:4]))
    return net, {k: p.data().asnumpy()
                 for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def arrays(jax_net):
    return jax_net[1]


def _sorted(weights: dict) -> list:
    return [weights[k] for k in sorted(weights)]


@pytest.fixture(scope="module")
def one_rank_sgd(arrays):
    """The port's one-rank trainer, SGD (lr 0.1), two steps: losses,
    gradient norms and global weights."""
    tr = W.bert_trainer(arrays, parallel.make_mesh(devices=[0]), opt="sgd",
                        lr=0.1)
    losses, gnorms = [], []
    for b in W.bert_batches(2):
        losses.append(float(tr.step(*b)))
        gnorms.append(tr.last_grad_norm)
    return dict(W.trainer_state(tr), losses=losses, gnorms=gnorms)


@pytest.fixture(scope="module")
def mesh_run(jax_net, tmp_path_factory):
    """The JAX trainer on a dp2 x tp2 mesh of four devices with ZeRO-1 and
    ``bert_sharding_rules`` (two Adam steps, a checkpoint); then one world
    of four port ranks (``torch_dist_worker.sharded_case``): BERT on sp=4,
    on dp2 x tp2 the same two Adam steps, a checkpoint and the JAX one
    restored, two SGD steps, and ``bert_pretraining --dp 2 --tp 2``; then
    the JAX trainer restoring the port's checkpoint."""
    root = tmp_path_factory.mktemp("mesh")
    jax_root, port_root = str(root / "jax"), str(root / "port")
    pre_root = str(root / "pretraining")
    net, arrays = jax_net
    mesh = jparallel.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    # a guard that only reads: the JAX trainer reports its gradient norm
    jtr = jparallel.ShardedTrainer(
        net, jmodels.bert_pretrain_loss, "adam", {"learning_rate": LR},
        mesh=mesh, rules=jmodels.bert_sharding_rules(), n_labels=3,
        zero1=True, guard=jfault.StepGuard("warn"))
    jlosses, jgnorms = [], []
    for b in W.bert_batches(2):
        jlosses.append(float(jtr.step(*b).asnumpy()))
        jgnorms.append(jtr.last_grad_norm)
    jweights = [onp.asarray(jax.device_get(v)) for v in jtr._param_vals]
    jtr.save_checkpoint(jax_root)
    res = W.run_ranks("sharded_case", 4, arrays, LR, port_root, jax_root,
                      pre_root)
    jtr.restore_checkpoint(port_root)
    restored = [onp.asarray(jax.device_get(v)) for v in jtr._param_vals]
    return {"jax_losses": jlosses, "jax_gnorms": jgnorms,
            "jax_weights": jweights, "ranks": res,
            "jax_restored": restored, "jax_t": jtr.num_update,
            "port_root": port_root, "pre_root": pre_root}


def test_bert_step_sp4_matches_sp1(mesh_run, one_rank_sgd):
    """A BERT step on an sp=4 mesh of four ranks (attention lowered to
    ring attention over ``sp``, the rest replicated) reproduces the
    one-rank losses and weights (port of
    ``tests/test_parallel.py::test_bert_step_sp4_matches_sp1``)."""
    for r in (rank["sp4"] for rank in mesh_run["ranks"]):
        # one ring call per layer and step, on this rank's 8 positions
        assert r["ring_calls"] == 4 and r["ring_shape"] == (4, 2, 8, 64)
        onp.testing.assert_allclose(r["losses"], one_rank_sgd["losses"],
                                    rtol=2e-4, atol=2e-5)
        for got, want in zip(_sorted(r["weights"]),
                             _sorted(one_rank_sgd["weights"])):
            onp.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        assert r["path"] == "eager"


def test_dp2_tp2_zero1_matches_jax_mesh_trainer(mesh_run):
    """Losses, the global gradient norm of each step and the weights
    after two Adam steps equal the JAX mesh trainer's. Adam's update does
    not see a gradient's scale; the norm does: a sum over ``dp`` where
    the mean belongs, or a gathered parameter's gradient summed over the
    ``tp`` ranks that computed it alike, moves it."""
    for r in (rank["adam"] for rank in mesh_run["ranks"]):
        onp.testing.assert_allclose(r["losses"], mesh_run["jax_losses"],
                                    rtol=1e-5)
        onp.testing.assert_allclose(r["gnorms"], mesh_run["jax_gnorms"],
                                    rtol=1e-5)
        assert r["path"] == "eager"
        got = _sorted(r["weights"])
        assert len(got) == len(mesh_run["jax_weights"])
        for g, want in zip(got, mesh_run["jax_weights"]):
            onp.testing.assert_allclose(g, want, atol=5e-5)


def test_dp2_tp2_zero1_sgd_matches_one_rank(mesh_run, one_rank_sgd):
    """Two SGD steps on dp2 x tp2 with the rules and ZeRO-1 equal the
    one-rank steps: under SGD a gradient off by a constant factor moves
    the weights, and the norms must agree as well."""
    for r in (rank["sgd"] for rank in mesh_run["ranks"]):
        onp.testing.assert_allclose(r["losses"], one_rank_sgd["losses"],
                                    rtol=1e-5)
        onp.testing.assert_allclose(r["gnorms"], one_rank_sgd["gnorms"],
                                    rtol=1e-5)
        for got, want in zip(_sorted(r["weights"]),
                             _sorted(one_rank_sgd["weights"])):
            onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_each_rank_holds_only_its_blocks(mesh_run):
    """A rule-sharded parameter is stored as this rank's tp block, and its
    Adam moments as that block's dp slice (ZeRO-1); a replicated
    parameter's moments are its dp slice where a dimension divides."""
    local = mesh_run["ranks"][0]["adam"]["local"]
    qkv = next(v for k, v in local.items() if k.endswith("qkv_weight"))
    assert qkv == ((192, 128), [(96, 128), (96, 128)])
    proj = next(v for k, v in local.items() if k.endswith("proj_weight"))
    assert proj == ((128, 64), [(64, 64), (64, 64)])
    gamma = next(v for k, v in local.items() if k.endswith("ln1_gamma"))
    assert gamma == ((128,), [(64,), (64,)])
    full = sum(int(onp.prod(w.shape)) for w in mesh_run["jax_weights"])
    held = sum(int(onp.prod(p)) for p, _ in local.values())
    states = sum(int(onp.prod(s)) for _, st in local.values() for s in st)
    assert held < 0.6 * full and states < 0.6 * full


def test_port_checkpoint_read_by_jax(mesh_run):
    """The four ranks' checkpoint: every rank's shard and marker, the
    primary's manifest, the JAX keys; the JAX trainer restores the port's
    global weights bit for bit."""
    step_dir = glob.glob(os.path.join(mesh_run["port_root"], "step-*"))[0]
    man = json.load(open(os.path.join(step_dir, "manifest.json")))
    assert sorted(man["shards"]) == ["0", "1", "2", "3"]
    assert man["meta"]["zero1"] is True and man["step"] == 2
    assert mesh_run["jax_t"] == 2
    port = _sorted(mesh_run["ranks"][0]["adam"]["weights"])
    for got, want in zip(mesh_run["jax_restored"], port):
        onp.testing.assert_array_equal(got, want)


def test_jax_checkpoint_restored_by_port(mesh_run):
    """The JAX mesh trainer's checkpoint restores into a port trainer on
    the same mesh, each rank taking its blocks: the global weights are the
    JAX ones bit for bit, and the step goes on from there."""
    for r in (rank["adam"] for rank in mesh_run["ranks"]):
        assert r["restored_step"] == 2 and r["restored_t"] == 2
        for got, want in zip(_sorted(r["restored"]),
                             mesh_run["jax_weights"]):
            onp.testing.assert_array_equal(got, want)
        assert onp.isfinite(r["restored_loss"])


def test_bert_pretraining_dp2(mesh_run):
    """``models.bert_pretraining.main`` with ``--dp 2 --tp 2`` on four
    ranks: the ranks agree on the losses, the checkpoint has every
    rank's shard, and a second run resumes from it; a batch that ``dp``
    does not divide raises."""
    res = [rank["pretraining"] for rank in mesh_run["ranks"]]
    first, again, _ = res[0]
    for r in res:
        assert r[:2] == (first, again)
        assert "divisible by 2" in r[2]
    assert onp.isfinite(first) and onp.isfinite(again)
    man = json.load(open(glob.glob(os.path.join(
        mesh_run["pre_root"], "step-*", "manifest.json"))[-1]))
    assert sorted(man["shards"]) == ["0", "1", "2", "3"]


@pytest.mark.slow
def test_bert_sharded_pretrain_step_loss_decreases():
    """Eight ranks, dp2 x tp2 x sp2 (the port of
    ``tests/test_models.py::test_bert_sharded_pretrain_step_loss_decreases``):
    the loss falls over 12 AdamW steps and every rank reads the same."""
    res = W.run_ranks("pretrain_8_case", 8, timeout=600)
    for losses in res:
        assert losses == res[0]
        assert all(onp.isfinite(losses)) and losses[-1] < losses[0]
