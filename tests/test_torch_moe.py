"""PyTorch port: switch mixture-of-experts over ``ep`` held against the JAX
package (the cases of ``tests/test_pipeline_moe.py:114-175``, and
``moe_dispatch`` itself).

The port's ranks are spawned once, two of them (ep=2;
``tests/torch_dist_worker.py``'s ``moe_case``: one torch thread each, no
JAX); the JAX references run here on ``jax.devices()[:2]``, on the same
inputs.

Tolerances, float32: outputs rtol 1e-4, atol 1e-5 (the JAX test's);
gradients rtol 1e-4, atol 1e-5; ``moe_dispatch``'s expert, position and
keep exactly, its buffer and router probability rtol 1e-6, atol 1e-7 (one
float32 softmax); the block's two SGD losses rtol 1e-4, atol 1e-5 (the
JAX test's) against JAX's ep=2 run and the port's one rank.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_worker as W

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.parallel.moe import (
    moe_dispatch as jmoe_dispatch, moe_ffn_sharded as jmoe_ffn_sharded)
from incubator_mxnet_tpu.parallel.sharding import ShardingRules as JRules

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import parallel
from incubator_mxnet_tpu_torch.parallel.moe import moe_dispatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_routing(params, x, gate):
    """Every token through its top-1 expert, scaled by its probability
    (the JAX test's oracle)."""
    probs = onp.exp(gate) / onp.exp(gate).sum(-1, keepdims=True)
    eidx = probs.argmax(-1)
    want = onp.zeros_like(x)
    for t in range(len(x)):
        e = eidx[t]
        h = onp.maximum(x[t] @ params["w1"][e].T + params["b1"][e], 0)
        want[t] = (h @ params["w2"][e].T + params["b2"][e]) * probs[t, e]
    return want


@pytest.fixture(scope="module")
def inputs():
    rng = onp.random.RandomState(4)
    E, T, C, H = 4, 32, 8, 16
    params = {"w1": rng.randn(E, H, C).astype("float32") * 0.3,
              "b1": rng.randn(E, H).astype("float32") * 0.1,
              "w2": rng.randn(E, C, H).astype("float32") * 0.3,
              "b2": rng.randn(E, C).astype("float32") * 0.1}
    x = rng.randn(T, C).astype("float32")
    gate = rng.randn(T, E).astype("float32")
    rng = onp.random.RandomState(6)
    drop = {"w1": rng.randn(2, 8, 4).astype("float32"),
            "b1": onp.zeros((2, 8), "float32"),
            "w2": rng.randn(2, 4, 8).astype("float32"),
            "b2": onp.zeros((2, 4), "float32")}
    dx = rng.randn(8, 4).astype("float32")
    dgate = onp.zeros((8, 2), "float32")
    dgate[:, 0] = 10.0                  # every token wants expert 0
    rng = onp.random.RandomState(5)
    return dict(params=params, x=x, gate=gate, drop=drop, dx=dx,
                dgate=dgate, cot=rng.randn(T, C).astype("float32"),
                bx=rng.randn(2, 8, 8).astype("float32"),
                by=rng.randn(2, 8, 8).astype("float32"))


def _jax_block_losses(x, y, mesh, rules=None):
    """The JAX test's run (``tests/test_pipeline_moe.py:131-151``):
    returns the losses and the initial weights in sorted-name order."""
    loss_fn = jgluon.loss.L2Loss()
    jmx.random.seed(6)
    blk = jparallel.MoEFFN(num_experts=4, hidden=16, units=8,
                           capacity_factor=100.0)
    blk.initialize()
    init = [p.data().asnumpy()
            for _, p in sorted(blk.collect_params().items())]
    tr = jparallel.ShardedTrainer(blk, lambda o, t: loss_fn(o, t).mean(),
                                  "sgd", {"learning_rate": 0.05}, mesh=mesh,
                                  rules=rules, n_labels=1)
    return [float(tr.step(x, y).asnumpy()) for _ in range(2)], init


@pytest.fixture(scope="module")
def run(inputs):
    """The JAX references on ep=2, then one world of two port ranks."""
    i = inputs
    mesh = jparallel.make_mesh(ep=2, dp=1, devices=jax.devices()[:2])
    T = i["x"].shape[0]
    ref = {"ffn": onp.asarray(jmoe_ffn_sharded(mesh, i["params"], i["x"],
                                               i["gate"], capacity=T)),
           "drops": onp.asarray(jmoe_ffn_sharded(mesh, i["drop"], i["dx"],
                                                 i["dgate"], capacity=1))}
    g = jax.grad(lambda p, x: (jmoe_ffn_sharded(mesh, p, x, i["gate"], T)
                               * i["cot"]).sum(), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in i["params"].items()},
        jnp.asarray(i["x"]))
    ref["grads"] = {k: onp.asarray(v) for k, v in g[0].items()}
    ref["grad_x"] = onp.asarray(g[1])
    ref["block_ep"], init = _jax_block_losses(
        i["bx"], i["by"], mesh, JRules([(r".*(w1|w2|b1|b2|router)",
                                         JP("ep"))]))
    ref["block_single"], _ = _jax_block_losses(
        i["bx"], i["by"], jparallel.make_mesh(devices=jax.devices()[:1]))
    ranks = W.run_ranks("moe_case", 2, i["params"], i["x"], i["gate"],
                        i["drop"], i["dx"], i["dgate"], i["cot"], init,
                        i["bx"], i["by"])
    return ref, ranks


def test_moe_dispatch_matches_jax():
    """Top-1 routing with capacity: expert, position and keep equal to
    the JAX function's, exact; argmax ties go to the lower expert (as
    XLA's); the buffer holds each kept token, and the dropped ones
    nowhere."""
    rng = onp.random.RandomState(9)
    T, C, E, cap = 24, 5, 4, 3
    x = rng.randn(T, C).astype("float32")
    gate = rng.randn(T, E).astype("float32")
    gate[:4] = 0.0                      # ties: expert 0
    gate[4:7, 1:3] = 5.0                # ties between experts 1 and 2
    got = moe_dispatch(torch.tensor(x), torch.tensor(gate), E, cap)
    want = jmoe_dispatch(jnp.asarray(x), jnp.asarray(gate), E, cap)
    for name, g, w in zip(("dispatched", "combine", "eidx", "pos", "keep"),
                          got, want):
        g, w = g.numpy(), onp.asarray(w)
        if g.dtype.kind == "f":
            onp.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                        err_msg=name)
        else:
            assert onp.array_equal(g, w), name
    assert (got[2].numpy()[:4] == 0).all() and (got[2].numpy()[4:7] == 1).all()
    assert not got[4].all() and got[4].any()


def test_moe_ffn_sharded_matches_dense_routing(run, inputs):
    """ep=2, capacity high enough that nothing drops: each rank's global
    output equals the JAX function's and the dense oracle."""
    ref, ranks = run
    want = _dense_routing(inputs["params"], inputs["x"], inputs["gate"])
    onp.testing.assert_allclose(ref["ffn"], want, rtol=1e-4, atol=1e-5)
    for r in ranks:
        onp.testing.assert_allclose(r["ffn"], ref["ffn"], rtol=1e-4,
                                    atol=1e-5)
        onp.testing.assert_allclose(r["ffn"], want, rtol=1e-4, atol=1e-5)


def test_moe_capacity_drops_are_zero_contribution(run):
    """Capacity 1, every token wants expert 0: one token per token shard
    gets through, the rest are exactly zero, as in JAX."""
    ref, ranks = run
    assert (onp.abs(ref["drops"]) > 1e-9).any(-1).sum() == 2
    for r in ranks:
        assert (onp.abs(r["drops"]) > 1e-9).any(-1).sum() == 2
        onp.testing.assert_allclose(r["drops"], ref["drops"], rtol=1e-4,
                                    atol=1e-5)


def test_moe_grads_match_jax(run):
    """The backward through both differentiable ``all_to_all``s: the
    experts' and the tokens' gradients on ep=2 equal ``jax.grad`` of the
    JAX function on every rank."""
    ref, ranks = run
    for r in ranks:
        for k in ref["grads"]:
            onp.testing.assert_allclose(r["grads"][k], ref["grads"][k],
                                        rtol=1e-4, atol=1e-5, err_msg=k)
        onp.testing.assert_allclose(r["grad_x"], ref["grad_x"], rtol=1e-4,
                                    atol=1e-5)


def test_all_to_all_backward_is_the_reverse_exchange(run):
    """``collectives.all_to_all`` (split 1, concat 0) over ep=2, and its
    backward: rank ``r``'s block ``j`` went to rank ``j``'s rows ``r``, so
    its gradient is the cotangent of those rows (the reverse exchange)."""
    _, ranks = run
    a = [torch.arange(16.0).reshape(2, 4, 2) + 100 * r for r in range(2)]
    for r, res in enumerate(ranks):
        b, ga = res["a2a"]
        want = torch.cat([t[:, 2 * r:2 * r + 2] for t in a], dim=0)
        assert onp.array_equal(b, want.numpy())
        cot = (torch.arange(b.size) + 1.0).reshape(b.shape).numpy()
        for j in range(2):
            assert onp.array_equal(ga[:, 2 * j:2 * j + 2],
                                   cot[2 * r:2 * r + 2])


def test_moe_block_ep_matches_local(run):
    """Two SGD steps of ``MoEFFN`` with its experts and router over ep=2
    (each rank its two experts, ungathered; the router gathered) equal
    JAX's ep=2 run and the port's one rank."""
    ref, ranks = run
    onp.testing.assert_allclose(ref["block_ep"], ref["block_single"],
                                rtol=1e-4, atol=1e-5)
    for r in ranks:
        ep_losses, ep_shapes = r["block_ep"]
        one, shapes = r["block_single"]
        onp.testing.assert_allclose(ep_losses, ref["block_ep"], rtol=1e-4,
                                    atol=1e-5)
        onp.testing.assert_allclose(ep_losses, one, rtol=1e-4, atol=1e-5)
        onp.testing.assert_allclose(one, ref["block_single"], rtol=1e-4,
                                    atol=1e-5)
        assert ep_shapes == {"b1": (2, 16), "b2": (2, 8), "router": (2, 8),
                             "w1": (2, 16, 8), "w2": (2, 8, 16)}
        assert shapes["w1"] == (4, 16, 8)


def test_moe_block_local_path_matches_jax():
    """Without a mesh every expert runs locally at capacity ``min(T,
    max(1, int(cf * T / E)))``: the block's forward (drops included, cf
    0.5) equals the JAX block's on the same weights."""
    rng = onp.random.RandomState(3)
    x = rng.randn(2, 6, 8).astype("float32")
    jmx.random.seed(2)
    jblk = jparallel.MoEFFN(num_experts=4, hidden=16, units=8,
                            capacity_factor=0.5)
    jblk.initialize()
    want = jblk(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        blk = parallel.MoEFFN(num_experts=4, hidden=16, units=8,
                              capacity_factor=0.5)
        blk.initialize()
        for (_, p), (_, q) in zip(sorted(blk.collect_params().items()),
                                  sorted(jblk.collect_params().items())):
            p.set_data(mx.nd.array(q.data().asnumpy()))
        got = blk(mx.nd.array(x)).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (onp.abs(got).sum(-1) == 0).any()     # some token dropped
