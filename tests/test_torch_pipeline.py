"""PyTorch port: pipeline parallelism over ``pp`` held against the JAX
package (the cases of ``tests/test_pipeline_moe.py:29-111``).

The port's ranks are spawned once, four of them
(``tests/torch_dist_worker.py``'s ``pipeline_case``: one torch thread each,
no JAX); the JAX references run here on ``jax.devices()[:4]`` at the same
mesh shapes: pp=4; pp2 x dp2 in place of the JAX test's 8-device pp2 x
dp4; and the gradients of ``pipeline_apply`` on pp=4.

Tolerances, float32: outputs atol 1e-5 (rtol 1e-5) against JAX and the
layer loop; gradients rtol 1e-4, atol 1e-5 (the JAX test's); the stacked
encoder's three SGD losses rtol 2e-4, atol 2e-5 (the JAX test's) against
JAX's pp=2 run and the port's one rank.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_worker as W

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.models import StackedTransformerEncoder as JEncoder
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.parallel.collectives import shard_map
from incubator_mxnet_tpu.parallel.pipeline import (
    pipeline_apply as jpipeline_apply, pipeline_sharded as jpipeline_sharded)
from incubator_mxnet_tpu.parallel.sharding import ShardingRules as JRules

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import models, parallel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage_params(rng, n_stages, d):
    return (rng.randn(n_stages, d, d).astype("float32") * 0.3,
            rng.randn(n_stages, d).astype("float32") * 0.1)


def _sequential(w, b, x):
    for s in range(len(w)):
        x = onp.tanh(x @ w[s] + b[s])
    return x


@pytest.fixture(scope="module")
def inputs():
    rng = onp.random.RandomState(0)
    w4, b4 = _stage_params(rng, 4, 8)
    x4 = rng.randn(16, 8).astype("float32")
    w2, b2 = _stage_params(rng, 2, 8)
    x2 = rng.randn(16, 8).astype("float32")
    wg, bg = _stage_params(rng, 4, 6)
    xg = rng.randn(8, 6).astype("float32")
    ex = rng.randn(8, 12, 16).astype("float32")
    ey = rng.randn(8, 12, 16).astype("float32")
    return dict(w4=w4, b4=b4, x4=x4, w2=w2, b2=b2, x2=x2, wg=wg, bg=bg,
                xg=xg, ex=ex, ey=ey)


def _jax_encoder_losses(x, y, mesh, rules=None):
    """The JAX test's run (``tests/test_pipeline_moe.py:94-108``); returns
    the losses and the initial weights in sorted-name order."""
    loss_fn = jgluon.loss.L2Loss()
    jmx.random.seed(5)
    enc = JEncoder(
        num_layers=4, units=16, hidden_size=32, num_heads=2, n_micro=4)
    enc.initialize()
    init = [p.data().asnumpy()
            for _, p in sorted(enc.collect_params().items())]
    tr = jparallel.ShardedTrainer(enc, lambda o, t: loss_fn(o, t).mean(),
                                  "sgd", {"learning_rate": 0.05}, mesh=mesh,
                                  rules=rules, n_labels=1)
    return [float(tr.step(x, y).asnumpy()) for _ in range(3)], init


@pytest.fixture(scope="module")
def run(inputs):
    """The JAX references, then one world of four port ranks."""
    i = inputs
    dev = jax.devices()[:4]
    ref = {"pp4": onp.asarray(jpipeline_sharded(
        jparallel.make_mesh(pp=4, dp=1, devices=dev),
        {"w": i["w4"], "b": i["b4"]}, i["x4"], _jstage, n_micro=4))}
    ref["pp2dp2"] = onp.asarray(jpipeline_sharded(
        jparallel.make_mesh(pp=2, dp=2, devices=dev),
        {"w": i["w2"], "b": i["b2"]}, i["x2"], _jstage, n_micro=4,
        batch_axis="dp"))
    # the JAX test's gradient case (``:57-85``) on pp=4
    fn = shard_map(partial(jpipeline_apply, stage_fn=_jstage, axis="pp"),
                   mesh=jparallel.make_mesh(pp=4, dp=1, devices=dev),
                   in_specs=({"w": JP("pp"), "b": JP("pp")}, JP(None, None)),
                   out_specs=JP(None, None))
    xm = jnp.asarray(i["xg"].reshape(4, 2, 6))
    g = jax.jit(jax.grad(lambda p, x: (fn(p, x) ** 2).sum(),
                         argnums=(0, 1)))({"w": i["wg"], "b": i["bg"]}, xm)
    ref["grads"] = {k: onp.asarray(v) for k, v in g[0].items()}
    ref["grad_x"] = onp.asarray(g[1])
    ref["enc_piped"], enc_init = _jax_encoder_losses(
        i["ex"], i["ey"], jparallel.make_mesh(pp=2, dp=2, sp=1, tp=1,
                                              devices=dev),
        JRules([(r".*", JP("pp"))]))
    ref["enc_single"], _ = _jax_encoder_losses(
        i["ex"], i["ey"], jparallel.make_mesh(devices=dev[:1]))
    ranks = W.run_ranks("pipeline_case", 4, i["w4"], i["b4"], i["x4"],
                        i["w2"], i["b2"], i["x2"], i["wg"], i["bg"],
                        i["xg"], enc_init, i["ex"], i["ey"])
    return ref, ranks


def test_pipeline_matches_sequential(run, inputs):
    """pp=4, four microbatches: every rank holds the whole output, equal
    to the JAX pipeline's and to the layer loop."""
    ref, ranks = run
    want = _sequential(inputs["w4"], inputs["b4"], inputs["x4"])
    onp.testing.assert_allclose(ref["pp4"], want, rtol=1e-5, atol=1e-5)
    for r in ranks:
        onp.testing.assert_allclose(r["pp4"], ref["pp4"], rtol=1e-5,
                                    atol=1e-5)
        onp.testing.assert_allclose(r["pp4"], want, rtol=1e-5, atol=1e-5)


def test_pipeline_with_dp_axis(run, inputs):
    """pp2 x dp2 with ``batch_axis="dp"``: each dp rank pipelines its rows
    of every microbatch; the gathered output equals JAX's and the loop."""
    ref, ranks = run
    want = _sequential(inputs["w2"], inputs["b2"], inputs["x2"])
    for r in ranks:
        onp.testing.assert_allclose(r["pp2dp2"], ref["pp2dp2"], rtol=1e-5,
                                    atol=1e-5)
        onp.testing.assert_allclose(r["pp2dp2"], want, rtol=1e-5, atol=1e-5)


def test_pipeline_grads_match_jax(run):
    """Autograd through the ticks is the backward pipeline: the stage
    parameters' and the input's gradients on pp=4 equal JAX's (``jax.grad``
    through ``shard_map(pipeline_apply)``) on every rank."""
    ref, ranks = run
    for r in ranks:
        for k in ("w", "b"):
            onp.testing.assert_allclose(r["grads"][k], ref["grads"][k],
                                        rtol=1e-4, atol=1e-5)
        onp.testing.assert_allclose(r["grad_x"], ref["grad_x"], rtol=1e-4,
                                    atol=1e-5)


def test_pipeline_grads_match_layer_loop(run, inputs):
    """The same gradients against torch autograd through the plain layer
    loop (no schedule, one process)."""
    _, ranks = run
    w = torch.tensor(inputs["wg"], requires_grad=True)
    b = torch.tensor(inputs["bg"], requires_grad=True)
    x = torch.tensor(inputs["xg"], requires_grad=True)
    h = x
    for s in range(4):
        h = torch.tanh(h @ w[s] + b[s])
    (h ** 2).sum().backward()
    for r in ranks:
        onp.testing.assert_allclose(r["grads"]["w"], w.grad.numpy(),
                                    rtol=1e-4, atol=1e-5)
        onp.testing.assert_allclose(r["grads"]["b"], b.grad.numpy(),
                                    rtol=1e-4, atol=1e-5)
        onp.testing.assert_allclose(r["grad_x"].reshape(8, 6),
                                    x.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_stacked_encoder_pp_matches_single_device(run):
    """The JAX test's done-criterion: three SGD steps of the stacked
    encoder on pp2 x dp2 (rule ``.*`` over pp, four microbatches) equal
    JAX's pp=2 run and the port's one-rank run; each rank holds and
    updates only its stage's two layers (the trainer hands the stack over
    ungathered)."""
    ref, ranks = run
    onp.testing.assert_allclose(ref["enc_piped"], ref["enc_single"],
                                rtol=2e-4, atol=2e-5)
    for r in ranks:
        piped, shapes = r["enc_piped"]
        single, full = r["enc_single"]
        onp.testing.assert_allclose(piped, ref["enc_piped"], rtol=2e-4,
                                    atol=2e-5)
        onp.testing.assert_allclose(piped, single, rtol=2e-4, atol=2e-5)
        onp.testing.assert_allclose(single, ref["enc_single"], rtol=2e-4,
                                    atol=2e-5)
        assert all(s[0] == 2 for s in shapes), shapes
        assert all(s[0] == 4 for s in full), full


def test_one_rank_pipeline_is_the_layer_loop():
    """On one rank (no process group) ``pipeline_apply`` is the stage on
    each microbatch in turn, and the stacked encoder under a one-rank
    mesh runs its plain layer loop: bitwise what it computes without a
    mesh."""
    rng = onp.random.RandomState(7)
    w, b = _stage_params(rng, 1, 6)
    x = rng.randn(4, 3, 6).astype("float32")
    out = parallel.pipeline_apply({"w": torch.tensor(w),
                                   "b": torch.tensor(b)}, torch.tensor(x),
                                  W.mlp_stage,
                                  mesh=parallel.make_mesh(devices=[0]))
    onp.testing.assert_allclose(out.numpy(), onp.tanh(x @ w[0] + b[0]),
                                rtol=1e-6, atol=1e-6)
    with mx.cpu():
        mx.random.seed(1)
        enc = models.StackedTransformerEncoder(2, 16, 32, 2, n_micro=2)
        enc.initialize()
        xe = mx.nd.array(rng.randn(4, 5, 16).astype("float32"))
        plain = enc(xe).asnumpy()
        with parallel.mesh.active_mesh(parallel.make_mesh(devices=[0])):
            meshed = enc(xe).asnumpy()
    assert onp.array_equal(plain, meshed)
