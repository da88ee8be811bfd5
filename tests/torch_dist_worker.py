"""Spawned ranks for the port's multi-process tests (not collected).

:func:`run_ranks` starts ``world`` processes with the ``spawn`` method on a
free local port; each joins a gloo process group through the port's
``parallel.dist.initialize``, runs one function of this module (one torch
thread, no JAX) and writes its result, or its traceback, to a file. Each
join has its own timeout and a timeout kills every rank; a rank's
traceback fails the caller with its text.
"""
from __future__ import annotations

import os
import pickle
import socket
import sys
import tempfile
import traceback
import multiprocessing as mp

import numpy as onp

JOIN_TIMEOUT_S = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYTHON = sys.executable


def child_env() -> dict:
    """The environment of a worker started as a command: the repo on the
    path, one thread, quiet c10d."""
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
                "TORCH_CPP_LOG_LEVEL": "ERROR"})
    return env


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(fn_name, rank, world, port, args, out_dir):
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        os.environ["TORCH_CPP_LOG_LEVEL"] = "ERROR"
        import torch
        torch.set_num_threads(1)
        from incubator_mxnet_tpu_torch.parallel import dist
        dist.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
        try:
            res = globals()[fn_name](rank, world, *args)
        finally:
            dist.finalize()
        with open(path, "wb") as f:
            pickle.dump(("ok", res), f)
    except BaseException:  # noqa: BLE001 - the parent reports it
        with open(path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)


def run_ranks(fn_name: str, world: int, *args, timeout: float = None,
              may_die=()):
    """Run ``fn_name(rank, world, *args)`` in ``world`` spawned ranks;
    returns the ranks' results in rank order, or raises AssertionError
    with the first failing rank's traceback. A rank in ``may_die`` (a
    chaos drill's victim) may die without a result: its result is its
    exit code."""
    timeout = JOIN_TIMEOUT_S if timeout is None else timeout
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_entry, args=(
            fn_name, r, world, port, args, out_dir)) for r in range(world)]
        for p in procs:
            p.start()
        try:
            for r, p in enumerate(procs):
                p.join(timeout)
                if p.is_alive():
                    raise AssertionError(
                        f"rank {r} of {fn_name} still running after "
                        f"{timeout:g} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path) and r in may_die:
                results.append(procs[r].exitcode)
                continue
            if not os.path.exists(path):
                raise AssertionError(f"rank {r} of {fn_name} died with exit "
                                     f"code {procs[r].exitcode}")
            with open(path, "rb") as f:
                status, res = pickle.load(f)
            if status != "ok":
                raise AssertionError(f"rank {r} of {fn_name} failed:\n{res}")
            results.append(res)
    return results


def _t(x):
    import torch
    return torch.from_numpy(onp.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------
def collectives_case(rank, world):
    """Every verb of ``parallel.collectives`` on a 2 x 2 (dp, tp) mesh and
    over the world, against what numpy computes from all ranks' inputs."""
    import torch
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.parallel import collectives as C
    mesh = parallel.make_mesh(dp=2, tp=2)
    x = torch.arange(8.0).reshape(4, 2) + 10 * rank
    out = {
        "coords": (C.axis_index("dp", mesh), C.axis_index("tp", mesh),
                   C.axis_size("tp", mesh)),
        "sum_tp": C.all_reduce(x, "tp", mesh=mesh).numpy(),
        "mean_all": C.all_reduce(x, ("dp", "tp"), "mean", mesh=mesh).numpy(),
        "max_world": C.all_reduce(x, None, "max").numpy(),
        "gather_dp": C.all_gather(x, "dp", gather_axis=1, mesh=mesh).numpy(),
        "gather_both": C.all_gather(x, ("dp", "tp"), mesh=mesh).numpy(),
        "stack_tp": C.all_gather(x, "tp", tiled=False, mesh=mesh).numpy(),
        "rs_tp": C.reduce_scatter(x, "tp", mesh=mesh).numpy(),
        "rs_both": C.reduce_scatter(x, ("dp", "tp"), mesh=mesh).numpy(),
        "bcast_tp": C.broadcast(x, "tp", root=1, mesh=mesh).numpy(),
        "a2a_tp": C.all_to_all(x, "tp", 0, 1, mesh=mesh).numpy(),
        "run_dp": C.run_all_reduce(mesh, x, "dp").numpy(),
    }
    # ppermute forward, and its backward along the inverse permutation
    xr = x.clone().requires_grad_(True)
    y = C.ppermute(xr, "tp", [(0, 1)], mesh=mesh)
    (y * (rank + 1)).sum().backward()
    out["pperm"] = y.detach().numpy()
    out["pperm_grad"] = xr.grad.numpy()
    # the conjugate pairs: gather then a replicated loss, slice's backward
    w = (torch.arange(6.0) + 1).requires_grad_(True)
    full = C.replicated_gather(w.reshape(2, 3), "tp", 0, mesh=mesh)
    (full ** 2).sum().backward()
    out["rg_grad"] = w.grad.numpy()
    z = torch.arange(4.0).requires_grad_(True)
    part = C.replicated_slice(z, "tp", 0, mesh=mesh)
    (part * 3).sum().backward()
    out["rs_grad"] = z.grad.numpy()
    sh = parallel.named_sharding(mesh, "dp", "tp")
    out["block"] = parallel.shard_array(onp.arange(16.0).reshape(4, 4),
                                        mesh, sh.spec).numpy()
    out["regather"] = sh.gather(_t(out["block"])).numpy()
    out["world"] = (parallel.process_index(), parallel.process_count(),
                    parallel.is_primary(), parallel.process_namespace())
    return out


def ring_case(rank, world, q, k, v, mask, dout):
    """``ring_attention_sharded`` over sp=4 (forward: full, key mask,
    causal; gradients of full and causal under a cotangent ``dout``)."""
    import torch
    from incubator_mxnet_tpu_torch import parallel
    mesh = parallel.make_mesh(dp=1, sp=world)
    out = {}
    for name, km, causal in (("full", None, False), ("mask", mask, False),
                             ("causal", None, True),
                             ("causal_mask", mask, True)):
        qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
        o = parallel.ring_attention_sharded(
            mesh, qt, kt, vt, key_mask=None if km is None else _t(km),
            causal=causal)
        (o * _t(dout)).sum().backward()
        out[name] = (o.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(),
                     vt.grad.numpy())
    return out


def parallel_case(rank, world, q, k, v, mask, dout):
    """Both multi-rank checks of ``tests/test_torch_parallel.py`` in one
    world: the collectives, then ring attention."""
    return {"collectives": collectives_case(rank, world),
            "ring": ring_case(rank, world, q, k, v, mask, dout)}


BERT_VOCAB, BERT_L = 64, 32


def bert_batches(n=2, B=4, L=BERT_L, P=4, vocab=BERT_VOCAB, seed=0):
    """Seeded BERT pretraining batches (every mask weight 1, full valid
    lengths but one ragged row)."""
    rng = onp.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (B, L)).astype("int32")
        tt = onp.zeros((B, L), "int32")
        vl = onp.full((B,), L, "float32")
        vl[-1] = L // 2
        pos = rng.randint(0, L, (B, P)).astype("int32")
        lab = rng.randint(0, vocab, (B, P)).astype("float32")
        w = onp.ones((B, P), "float32")
        nsp = rng.randint(0, 2, (B,)).astype("float32")
        out.append((ids, tt, vl, pos, lab, w, nsp))
    return out


def bert_trainer(arrays, mesh, rules=False, zero1=None, opt="adam",
                 lr=0.01):
    """The port's ``bert_2_128_2`` (dropout 0) from ``arrays`` (JAX
    names), in a ``ShardedTrainer`` on ``mesh``."""
    from incubator_mxnet_tpu_torch import models, parallel
    from incubator_mxnet_tpu_torch.convert import params_from_jax
    net = models.get_bert("bert_2_128_2", vocab_size=BERT_VOCAB,
                          max_length=BERT_L, dropout=0.0, device="cpu")
    params_from_jax(net, arrays)
    return parallel.ShardedTrainer(
        net, models.bert_pretrain_loss, opt, {"learning_rate": lr},
        device="cpu", n_labels=3, mesh=mesh, zero1=zero1,
        rules=models.bert_sharding_rules() if rules else None)


def trainer_state(tr) -> dict:
    """Global weights by name and the local shapes of parameters and
    states."""
    names = tr._optimizer.idx2name
    return {
        "weights": {names[i]: tr._global_param(i).float().numpy().copy()
                    for i in range(len(tr._params))},
        "local": {names[i]: (tuple(p.shape), [tuple(s.shape) for s in st])
                  for i, (p, st) in enumerate(zip(tr._params, tr._states))},
    }


def bert_mesh_case(rank, world, arrays, mesh_kw, rules, zero1, steps,
                   opt="adam", lr=0.01, ckpt_dir=None, jax_ckpt=None):
    """``steps`` steps of BERT on a mesh: losses, gradient norms, global
    weights, local shapes, the ring's calls; then a checkpoint saved under
    ``ckpt_dir`` and (``jax_ckpt``) one of the JAX package restored into a
    new trainer."""
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.parallel import ring
    calls = []
    inner = ring.ring_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return inner(*a, **kw)

    ring.ring_attention = counted
    try:
        mesh = parallel.make_mesh(**mesh_kw)
        tr = bert_trainer(arrays, mesh, rules, zero1, opt, lr)
        batches = bert_batches(steps)
        losses, gnorms = [], []
        for b in batches:
            losses.append(float(tr.step(*b)))
            gnorms.append(tr.last_grad_norm)
    finally:
        ring.ring_attention = inner
    out = dict(trainer_state(tr), losses=losses, gnorms=gnorms,
               path=tr.last_path, ring_calls=len(calls),
               ring_shape=tuple(calls[0]) if calls else None)
    if ckpt_dir:
        tr.save_checkpoint(ckpt_dir)
    if jax_ckpt:
        tr2 = bert_trainer(arrays, mesh, rules, zero1, opt, lr)
        tr2.step(*batches[0])
        out["restored_step"] = tr2.restore_checkpoint(jax_ckpt)
        out["restored"] = trainer_state(tr2)["weights"]
        out["restored_t"] = tr2.num_update
        out["restored_loss"] = float(tr2.step(*batches[0]))
    return out


def sharded_case(rank, world, arrays, adam_lr, port_root, jax_root,
                 pretrain_root):
    """Every multi-rank check of ``tests/test_torch_sharded.py`` in one
    four-rank world: BERT on sp=4 (SGD); on dp2 x tp2 with the rules and
    ZeRO-1, Adam with the checkpoints both ways, then SGD; and
    ``bert_pretraining`` with ``--dp 2 --tp 2``."""
    dp2tp2 = dict(dp=2, tp=world // 2)
    return {
        "sp4": bert_mesh_case(rank, world, arrays, dict(dp=1, sp=world),
                              False, None, 2, "sgd", 0.1),
        "adam": bert_mesh_case(rank, world, arrays, dp2tp2, True, True, 2,
                               "adam", adam_lr, port_root, jax_root),
        "sgd": bert_mesh_case(rank, world, arrays, dp2tp2, True, True, 2,
                              "sgd", 0.1),
        "pretraining": pretraining_case(rank, world, pretrain_root),
    }


def pretraining_case(rank, world, root):
    """``models.bert_pretraining.main`` with ``--dp 2`` (and ``--tp`` the
    rest of the world): the run, then a second one resuming from its
    checkpoint, and the error of a batch that ``dp`` does not divide."""
    from incubator_mxnet_tpu_torch.models import bert_pretraining
    flags = ["--seq-len", "16", "--batch-size", "4", "--dtype", "float32",
             "--dp", "2", "--tp", str(world // 2), "--ckpt-dir", root,
             "--ckpt-every", "2"]
    first = bert_pretraining.main(flags + ["--steps", "3"], device="cpu")
    again = bert_pretraining.main(flags + ["--steps", "4"], device="cpu")
    _, trainer, batch = bert_pretraining.build(
        bert_pretraining.parse_args(flags), device="cpu")
    try:
        trainer.step(*(a[:3] for a in batch))
        raised = ""
    except Exception as e:  # noqa: BLE001 - the test reads the message
        raised = str(e)
    return first, again, raised


def pretrain_8_case(rank, world):
    """The port of ``tests/test_models.py::test_bert_sharded_pretrain_step_
    loss_decreases`` on a dp2 x tp2 x sp2 mesh: dropout 0.1, AdamW, 12
    steps on one batch."""
    import torch
    from incubator_mxnet_tpu_torch import models, parallel
    mesh = parallel.make_mesh(dp=2, tp=2, sp=2)
    net = models.get_bert("bert_2_128_2", vocab_size=400, max_length=32,
                          dropout=0.1, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    tr = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adamw",
                                 {"learning_rate": 3e-3}, device="cpu",
                                 n_labels=3, mesh=mesh, seq_axis=1,
                                 rules=models.bert_sharding_rules())
    rng = onp.random.RandomState(0)
    B, L, P = 8, 32, 4
    batch = (rng.randint(0, 400, (B, L)).astype("int32"),
             rng.randint(0, 2, (B, L)).astype("int32"),
             onp.full((B,), L, "float32"),
             rng.randint(0, L, (B, P)).astype("int32"),
             rng.randint(0, 400, (B, P)).astype("float32"),
             onp.ones((B, P), "float32"),
             rng.randint(0, 2, (B,)).astype("float32"))
    return [float(tr.step(*batch)) for _ in range(12)]


def dist_sync_case(rank, world):
    """The port of ``tests/dist_sync_kvstore_worker.py``, then
    ``gluon.Trainer`` and ``Module`` with ``kvstore="dist_sync"`` on each
    rank's own data: returns what the parent checks."""
    import torch
    import incubator_mxnet_tpu_torch as mx
    out = {}
    with mx.cpu():
        kv = mx.kv.create("dist_sync")
        out["who"] = (kv.rank, kv.num_workers, kv.type)
        kv.init(3, mx.nd.zeros((4, 2)))
        kv.push(3, mx.nd.full((4, 2), float(rank + 1)))
        o = mx.nd.zeros((4, 2))
        kv.pull(3, out=o)
        out["one"] = o.asnumpy()
        keys = [10, 11]
        kv.init(keys, [mx.nd.zeros((3,))] * 2)
        kv.push(keys, [mx.nd.full((3,), float(rank + 1)),
                       mx.nd.full((3,), 2.0 * (rank + 1))])
        out["batch"] = [a.asnumpy() for a in kv.pull(keys)]
        kv.barrier()
        kv.push(3, mx.nd.ones((4, 2)))
        kv.pull(3, out=o)
        out["again"] = o.asnumpy()
        # update on the store: every rank applies the summed gradient
        kv2 = mx.kv.create("dist_sync")
        kv2.init(0, mx.nd.ones((3,)))
        kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
        kv2.push(0, mx.nd.full((3,), float(rank + 1)))
        out["updated"] = kv2.pull(0).asnumpy()
        # gluon.Trainer: each rank's rows, the gradients summed across
        torch.manual_seed(0)
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize(mx.init.Constant(0.1))
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore="dist_sync")
        x = mx.nd.array(onp.arange(12.0).reshape(4, 3)[2 * rank:2 * rank + 2])
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(4)
        out["trainer"] = net.weight.data().asnumpy()
        # Module.fit's update with a dist_sync store
        sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                                    name="fc")
        sym = mx.sym.LinearRegressionOutput(sym, mx.sym.Variable("lin_label"),
                                            name="lin")
        mod = mx.module.Module(sym, label_names=["lin_label"],
                               context=mx.cpu())
        mod.bind([("data", (2, 3))], [("lin_label", (2, 2))])
        mod.init_params(mx.init.Constant(0.1))
        mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1),))
        mod.forward(mx.io.DataBatch([x], [mx.nd.zeros((2, 2))]),
                    is_train=True)
        mod.backward()
        mod.update()
        out["module"] = mod.get_params()[0]["fc_weight"].asnumpy()
    return out


# ---------------------------------------------------------------------------
# pipeline (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------
def mlp_stage(p, x):
    """The JAX test's stage: ``tanh(x @ w + b)``."""
    import torch
    return torch.tanh(x @ p["w"] + p["b"])


def encoder_losses(arrays, x, y, mesh, rules, steps=3):
    """``steps`` SGD steps (lr 0.05, L2 loss) of a 4-layer
    ``StackedTransformerEncoder`` (16 units, 4 microbatches) from
    ``arrays`` (its weights in sorted-name order) on ``mesh``: the losses,
    and the local shapes of its layer stack."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, models, parallel
    with mx.cpu():
        enc = models.StackedTransformerEncoder(
            num_layers=4, units=16, hidden_size=32, num_heads=2, n_micro=4)
        enc.initialize()
        for (_, p), a in zip(sorted(enc.collect_params().items()), arrays):
            p.set_data(mx.nd.array(a))
        loss_fn = gluon.loss.L2Loss()
        tr = parallel.ShardedTrainer(
            enc, lambda o, t: loss_fn(o, t).mean(), "sgd",
            {"learning_rate": 0.05}, device="cpu", n_labels=1, mesh=mesh,
            rules=rules)
        losses = [float(tr.step(x, y)) for _ in range(steps)]
    return losses, sorted({tuple(p.shape) for p in tr._params})


def pipeline_case(rank, world, w4, b4, x4, w2, b2, x2, wg, bg, xg, enc_arrays,
                  ex, ey):
    """Every multi-rank check of ``tests/test_torch_pipeline.py`` in one
    world of four: ``pipeline_sharded`` on pp=4 and on pp2 x dp2, the
    gradients of ``pipeline_apply`` on pp=4, and the stacked encoder's SGD
    steps on pp2 x dp2 (rule ``.*`` over pp) and on one rank."""
    import torch
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.parallel import collectives as C
    pp4 = parallel.make_mesh(pp=4, dp=1)
    pp2 = parallel.make_mesh(pp=2, dp=2)
    out = {"pp4": parallel.pipeline_sharded(
        pp4, {"w": _t(w4), "b": _t(b4)}, _t(x4), mlp_stage,
        n_micro=4).numpy()}
    out["pp2dp2"] = parallel.pipeline_sharded(
        pp2, {"w": _t(w2), "b": _t(b2)}, _t(x2), mlp_stage, n_micro=4,
        batch_axis="dp").numpy()
    # the backward pipeline: pipeline_apply on this rank's stage, the
    # stack sliced from a global parameter (its gradient gathered back)
    gp = {"w": _t(wg).requires_grad_(True), "b": _t(bg).requires_grad_(True)}
    local = {k: C.replicated_slice(v, "pp", 0, mesh=pp4)
             for k, v in gp.items()}
    xm = _t(xg.reshape((4, -1) + xg.shape[1:])).requires_grad_(True)
    y = parallel.pipeline_apply(local, xm, mlp_stage, mesh=pp4)
    (y ** 2).sum().backward()
    out["grads"] = {k: v.grad.numpy() for k, v in gp.items()}
    out["grad_x"] = xm.grad.numpy()
    rules = parallel.ShardingRules([(r".*", parallel.sharding.P("pp"))])
    out["enc_piped"] = encoder_losses(enc_arrays, ex, ey, pp2, rules)
    out["enc_single"] = encoder_losses(enc_arrays, ex, ey,
                                       parallel.make_mesh(devices=[rank]),
                                       None)
    return out


# ---------------------------------------------------------------------------
# mixture of experts (tests/test_torch_moe.py)
# ---------------------------------------------------------------------------
def moe_block_losses(arrays, x, y, mesh, rules, steps=2):
    """``steps`` SGD steps (lr 0.05, L2 loss) of ``parallel.MoEFFN(4, 16,
    8, capacity_factor=100)`` from ``arrays`` (sorted-name order) on
    ``mesh``: the losses and the local shapes of its parameters."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    with mx.cpu():
        blk = parallel.MoEFFN(num_experts=4, hidden=16, units=8,
                              capacity_factor=100.0)
        blk.initialize()
        for (_, p), a in zip(sorted(blk.collect_params().items()), arrays):
            p.set_data(mx.nd.array(a))
        loss_fn = gluon.loss.L2Loss()
        tr = parallel.ShardedTrainer(
            blk, lambda o, t: loss_fn(o, t).mean(), "sgd",
            {"learning_rate": 0.05}, device="cpu", n_labels=1, mesh=mesh,
            rules=rules)
        losses = [float(tr.step(x, y)) for _ in range(steps)]
    names = tr._optimizer.idx2name
    return losses, {names[i].rsplit("_", 1)[-1]: tuple(p.shape)
                    for i, p in enumerate(tr._params)}


def moe_case(rank, world, params, x, gate, drop_params, drop_x, drop_gate,
             cot, blk_arrays, bx, by):
    """Every multi-rank check of ``tests/test_torch_moe.py`` in one world
    of two (ep=2): ``moe_ffn_sharded`` without drops, with drops, and its
    gradients under the cotangent ``cot``; the ``all_to_all`` backward;
    and two SGD steps of ``MoEFFN`` with its experts over ep and on one
    rank."""
    import torch
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.parallel import collectives as C
    from incubator_mxnet_tpu_torch.parallel.moe import moe_ffn_sharded
    mesh = parallel.make_mesh(ep=2, dp=1)
    T = x.shape[0]
    tp = {k: _t(v) for k, v in params.items()}
    out = {"ffn": moe_ffn_sharded(mesh, tp, _t(x), _t(gate),
                                  capacity=T).numpy()}
    out["drops"] = moe_ffn_sharded(
        mesh, {k: _t(v) for k, v in drop_params.items()}, _t(drop_x),
        _t(drop_gate), capacity=1).numpy()
    gp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = _t(x).requires_grad_(True)
    y = moe_ffn_sharded(mesh, gp, xt, _t(gate), capacity=T)
    (y * _t(cot)).sum().backward()
    out["grads"] = {k: v.grad.numpy() for k, v in gp.items()}
    out["grad_x"] = xt.grad.numpy()
    # all_to_all's backward is the reverse exchange
    a = (torch.arange(16.0).reshape(2, 4, 2) + 100 * rank).requires_grad_()
    b = C.all_to_all(a, "ep", 1, 0, mesh=mesh)
    (b * (torch.arange(b.numel()).reshape(b.shape) + 1.0)).sum().backward()
    out["a2a"] = (b.detach().numpy(), a.grad.numpy())
    rules = parallel.ShardingRules(
        [(r".*(w1|w2|b1|b2|router)", parallel.sharding.P("ep"))])
    out["block_ep"] = moe_block_losses(blk_arrays, bx, by, mesh, rules)
    out["block_single"] = moe_block_losses(
        blk_arrays, bx, by, parallel.make_mesh(devices=[rank]), None)
    return out


# ---------------------------------------------------------------------------
# elastic drill (tests/test_torch_elastic.py)
# ---------------------------------------------------------------------------
def _drill_trainer(arrays, mesh):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    with mx.cpu():
        net = gluon.nn.Dense(4, in_units=6, prefix="drill_")
        net.initialize()
        for (_, p), a in zip(sorted(net.collect_params().items()), arrays):
            p.set_data(mx.nd.array(a))
        loss_fn = gluon.loss.L2Loss()
        return parallel.ShardedTrainer(
            net, lambda o, t: loss_fn(o, t).mean(), "sgd",
            {"learning_rate": 0.1}, device="cpu", n_labels=1, mesh=mesh)


def elastic_drill_case(rank, world, arrays, batches, root):
    """The two-rank drill over the process group's ``TCPStore`` (elastic
    on through the environment): four uninterrupted dp=2 steps; then a
    fresh run that checkpoints after step 2, where rank 1's ``host_kill``
    fires at step 3; rank 0 waits for the lease watchdog, takes
    ``HostLossError`` at its next step, leaves the group and recovers at
    one rank from the checkpoint, then runs steps 3 and 4."""
    import time
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.fault import inject
    from incubator_mxnet_tpu_torch.parallel import dist, elastic
    out = {"active": elastic.active(),
           "transport": type(elastic._transport()).__name__}
    mesh = parallel.make_mesh(dp=2)
    tr = _drill_trainer(arrays, mesh)
    out["uninterrupted"] = [float(tr.step(*b)) for b in batches]
    tr = _drill_trainer(arrays, mesh)
    out["before"] = [float(tr.step(*b)) for b in batches[:2]]
    tr.save_checkpoint(root)
    if rank == 1:
        inject.enable(seed=0, host_kill=3)
        tr.step(*batches[2])             # SIGKILL before its collectives
        raise AssertionError("host_kill did not fire")
    deadline = time.time() + 60
    while not elastic.snapshot()["lost"] and time.time() < deadline:
        time.sleep(0.05)
    out["snapshot"] = elastic.snapshot()
    try:
        tr.step(*batches[2])
        out["raised"] = None
    except elastic.HostLossError as e:
        out["raised"] = (e.lost, e.generation, str(e))
    # restart on the survivor: a world of one
    dist.finalize()
    tr1 = _drill_trainer(arrays, parallel.make_mesh())
    tr1.step(*batches[0])
    out["restored_step"] = elastic.recover(tr1, root)
    out["generation"] = elastic.generation()
    out["meta"] = tr1.last_restore_meta
    out["after"] = [float(tr1.step(*b)) for b in batches[2:]]
    return out


# ---------------------------------------------------------------------------
# a rule over dp (tests/test_torch_multi_context.py)
# ---------------------------------------------------------------------------
def mlp_net(mx, arrays, prefix="mlp_"):
    """Dense(8, relu) -> Dense(3) on 6 inputs, weights from ``arrays``
    (sorted-name order)."""
    net = mx.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, in_units=6, activation="relu"))
        net.add(mx.gluon.nn.Dense(3, in_units=8))
    net.initialize()
    for (_, p), a in zip(sorted(net.collect_params().items()), arrays):
        p.set_data(mx.nd.array(a))
    return net


def dp_rule_case(rank, world, arrays, batches, pattern):
    """Three SGD-with-momentum steps of :func:`mlp_net` under a rule that
    shards the parameters matching ``pattern`` over dp=2, and on one rank:
    losses, global weights, and the local shapes of parameters and
    states."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import parallel
    out = {}
    for tag, mesh, rules in (
            ("dp", parallel.make_mesh(dp=2),
             parallel.ShardingRules([(pattern, parallel.sharding.P("dp"))])),
            ("one", parallel.make_mesh(devices=[rank]), None)):
        with mx.cpu():
            net = mlp_net(mx, arrays)
            loss_fn = mx.gluon.loss.L2Loss()
            tr = parallel.ShardedTrainer(
                net, lambda o, t: loss_fn(o, t).mean(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, device="cpu",
                n_labels=1, mesh=mesh, rules=rules)
            losses = [float(tr.step(*b)) for b in batches]
        out[tag] = dict(trainer_state(tr), losses=losses,
                        gnorm=tr.last_grad_norm)
    return out
