"""PyTorch port: ``parallel`` (dist, mesh, sharding, collectives, ring
attention) and ``flash_block`` held against the JAX package on the CPU.

The multi-rank checks run the port in spawned gloo ranks
(``tests/torch_dist_worker.py``: one torch thread each, no JAX) and the
JAX package here, on the suite's virtual CPU devices.

Tolerances, float32: ``flash_block`` against the JAX Pallas entry in
interpret mode atol 1e-5 (another summation order of the same products);
ring attention against JAX ``ring_attention_sharded`` on 4 devices atol
2e-5 for outputs and 1e-4 for gradients, as the JAX tests hold their ring
against dense attention (``tests/test_parallel.py:62,211``).
"""
import re
import types

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import torch_dist_worker as W

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.ops.pallas import flash_attention as jax_fa
from incubator_mxnet_tpu.parallel import ring as jring

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import models, parallel
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.parallel import ring

#: the JAX ``parallel`` names the port has yet to bring: none since the
#: slice with pipeline, MoE and the elastic control plane
LATER = set()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_parallel_names_are_the_jax_ones_less_the_later_slice():
    # ``moe_block`` is imported when the first MoEFFN is built, in either
    # package: import it in both
    import incubator_mxnet_tpu.parallel.moe_block  # noqa: F401
    import incubator_mxnet_tpu_torch.parallel.moe_block  # noqa: F401
    assert _public(parallel) == _public(jparallel) - LATER
    assert mx.kv is mx.kvstore
    assert {"create", "KVStore", "KVStoreBase", "register"} <= _public(mx.kv)


def test_mesh_config_and_rule_tables_match_jax():
    """``MeshConfig.resolve`` (sizes and errors) and the three rule tables'
    ``spec_for`` over the real parameter names and shapes, with and
    without a mesh to check divisibility against."""
    for kw, n in ((dict(dp=-1, tp=2), 8), (dict(tp=4, sp=2), 8),
                  (dict(dp=1, tp=1), 1), (dict(dp=3, tp=3), 8),
                  (dict(dp=-1, tp=-1), 4), (dict(dp=0), 4),
                  (dict(dp=-1, tp=3), 8)):
        outs = []
        for lib in (parallel, jparallel):
            try:
                outs.append(lib.MeshConfig(**kw).resolve(n))
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], kw
    jmesh = jparallel.make_mesh(dp=2, tp=4)
    pmesh = types.SimpleNamespace(shape=dict(jmesh.shape))
    with mx.cpu():
        bert = models.get_bert("bert_2_128_2", vocab_size=30, max_length=16,
                               dropout=0.0, device="cpu")
        nmt = models.NMTModel(30, 30, units=32, hidden_size=64,
                              num_layers=1, num_heads=2, dropout=0.0,
                              max_length=16)
        nmt.initialize()
        resnet = mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
        resnet.initialize()
        resnet(mx.nd.zeros((1, 3, 32, 32)))
    tables = ((bert, models.bert_sharding_rules(),
               jmodels.bert_sharding_rules()),
              (nmt, models.transformer_sharding_rules(),
               jmodels.nmt.transformer_sharding_rules()),
              (resnet, mx.gluon.model_zoo.vision.resnet_sharding_rules(),
               jmx.gluon.model_zoo.vision.resnet_sharding_rules()))
    sharded = 0
    for net, port_rules, jax_rules in tables:
        for name, p in net.collect_params().items():
            shape = tuple(p.shape)
            want = tuple(jax_rules.spec_for(name, shape, jmesh))
            assert tuple(port_rules.spec_for(name, shape, pmesh)) == want
            assert tuple(port_rules.spec_for(name)) == tuple(
                jax_rules.spec_for(name))
            sharded += bool(want)
    assert sharded > 20
    rules = parallel.ShardingRules([(r".*weight", ("tp", None))])
    assert rules.spec_for("odd_weight", (6, 3), pmesh) == ()
    assert re.search("PartitionSpec", repr(rules))


def _jax_hop_case(seed, B=2, H=2, L=16, D=8):
    rng = onp.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, L, D).astype("float32")
                   for _ in range(4))
    dlse = rng.randn(B, H, L).astype("float32")
    mask = (rng.rand(B, L) > 0.4).astype("float32")
    mask[1] = 0.0                          # a row that sees no key
    return q, k, v, do, dlse, mask


@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_matches_jax(causal):
    """``flash_block``: ``o``, ``lse`` and the gradients under both
    cotangents (``dlse`` folded into ``delta``) against the JAX entry; a
    batch row whose every key is masked gives an lse of about -1e30 in
    both; the ring's hop modes (0, 1 and 2, flash and plain paths) against
    JAX ``_hop_attn``."""
    q, k, v, do, dlse, mask = _jax_hop_case(1)
    scale = 8 ** -0.5

    def jax_fn(q, k, v):
        o, lse = jax_fa.flash_block(q, k, v, jnp.asarray(mask), causal,
                                    scale)
        return (o * do).sum() + (lse * dlse).sum(), (o, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o, lse = fa.flash_block(qt, kt, vt, torch.from_numpy(mask), causal,
                            scale)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    live = mask.any(axis=1)
    onp.testing.assert_allclose(o.detach().numpy()[live],
                                onp.asarray(jo)[live], atol=1e-5)
    onp.testing.assert_allclose(lse.detach().numpy()[live],
                                onp.asarray(jlse)[live], atol=1e-5)
    assert (lse.detach().numpy()[~live] < -1e29).all()
    assert (onp.asarray(jlse)[~live] < -1e29).all()
    for got, want in zip((qt.grad, kt.grad, vt.grad), jg):
        onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                    atol=1e-5)
    kv = torch.stack([torch.from_numpy(k), torch.from_numpy(v)])
    for mode in (0, 1, 2):
        jo, jlse = jring._hop_attn(q, k, v, jnp.asarray(mask), mode, 0, 0,
                                   scale)
        for impl in ("", "xla"):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("MXTPU_RING_IMPL", impl)
                po, plse = ring._hop_attn(torch.from_numpy(q), kv,
                                          torch.from_numpy(mask), mode, 0,
                                          0, scale)
            onp.testing.assert_allclose(po.numpy()[live],
                                        onp.asarray(jo)[live], atol=1e-5)
            onp.testing.assert_allclose(plse.numpy()[live],
                                        onp.asarray(jlse)[live], atol=1e-5)
            assert (plse.numpy()[~live] < -1e29).all()


@pytest.fixture(scope="module")
def four_ranks():
    """One world of four gloo ranks for both multi-rank tests: the
    collectives, then ring attention on seeded inputs (``q, k, v``, a key
    mask whose first shard has no key for batch 0, the cotangent)."""
    rng = onp.random.RandomState(3)
    B, H, L, D = 2, 2, 32, 8
    q, k, v, dout = (rng.randn(B, H, L, D).astype("float32")
                     for _ in range(4))
    mask = (rng.rand(B, L) > 0.3).astype("float32")
    mask[0, :8] = 0.0
    res = W.run_ranks("parallel_case", 4, q, k, v, mask, dout)
    return (q, k, v, mask, dout), res


def test_collectives_four_ranks(four_ranks):
    """Every verb on a 2 x 2 (dp, tp) mesh of four gloo ranks against
    numpy over all ranks' inputs; ``ppermute``'s backward along the
    inverse permutation; the conjugate pairs without a sum; a block and
    its gather; ``dist``'s world."""
    res = [r["collectives"] for r in four_ranks[1]]
    X = [onp.arange(8.0).reshape(4, 2) + 10 * r for r in range(4)]
    for r, o in enumerate(res):
        dp, tp = divmod(r, 2)
        tp_ranks, dp_ranks = [2 * dp, 2 * dp + 1], [tp, 2 + tp]
        s_tp = X[tp_ranks[0]] + X[tp_ranks[1]]
        assert o["coords"] == (dp, tp, 2)
        assert o["world"] == (r, 4, r == 0, f"p{r}")
        want = {
            "sum_tp": s_tp, "mean_all": sum(X) / 4, "max_world": X[3],
            "gather_dp": onp.concatenate([X[i] for i in dp_ranks], 1),
            "gather_both": onp.concatenate(X, 0),
            "stack_tp": onp.stack([X[i] for i in tp_ranks]),
            "rs_tp": s_tp[2 * tp:2 * tp + 2], "rs_both": sum(X)[r:r + 1],
            "bcast_tp": X[tp_ranks[1]],
            "a2a_tp": onp.concatenate([X[i][2 * tp:2 * tp + 2]
                                       for i in tp_ranks], 1),
            "run_dp": X[dp_ranks[0]] + X[dp_ranks[1]],
            "pperm": X[r - 1] if tp == 1 else onp.zeros((4, 2)),
            "pperm_grad": onp.full((4, 2), r + 2.0) if tp == 0
            else onp.zeros((4, 2)),
            "rg_grad": 2 * (onp.arange(6.0) + 1),
            "rs_grad": onp.full(4, 3.0),
            "block": onp.arange(16.0).reshape(4, 4)[2 * dp:2 * dp + 2,
                                                    2 * tp:2 * tp + 2],
            "regather": onp.arange(16.0).reshape(4, 4)}
        for key, val in want.items():
            onp.testing.assert_array_equal(o[key], val, err_msg=key)


def test_ring_attention_matches_jax(four_ranks):
    """The port's ring over four gloo ranks (sp=4) against JAX
    ``ring_attention_sharded`` on four devices: full, key mask, causal,
    causal with a key mask; outputs and the gradients of q, k, v (the
    ports of ``test_ring_attention_matches_dense``, ``_key_mask`` and
    ``_grads_match_dense``)."""
    (q, k, v, mask, dout), ranks = four_ranks
    res = [r["ring"] for r in ranks]
    mesh = jparallel.make_mesh(dp=1, sp=4, devices=jax.devices()[:4])
    refs = {}
    for causal in (False, True):
        # one JAX program per causal flag: no mask is a mask of ones there
        # (JAX ``ring.py:120-121``)
        def loss(q, k, v, km, causal=causal):
            o = jparallel.ring_attention_sharded(mesh, q, k, v, key_mask=km,
                                                 causal=causal)
            return (o * dout).sum(), o

        refs[causal] = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))
    for name, km, causal in (("full", None, False), ("mask", mask, False),
                             ("causal", None, True),
                             ("causal_mask", mask, True)):
        (_, o), grads = refs[causal](
            q, k, v, onp.ones_like(mask) if km is None else km)
        got = res[0][name]
        onp.testing.assert_allclose(got[0], onp.asarray(o), atol=2e-5,
                                    err_msg=name)
        for g, want in zip(got[1:], grads):
            onp.testing.assert_allclose(g, onp.asarray(want), atol=1e-4,
                                        err_msg=name)
        for r in range(1, 4):
            onp.testing.assert_array_equal(res[r][name][0], got[0])


def test_launch_two_workers(tmp_path):
    """The port's ``tools/launch.py`` starts two workers whose
    ``dist.initialize()`` meets through the ``DMLC_*`` variables; a
    worker's failure is its exit code."""
    from incubator_mxnet_tpu_torch.tools import launch
    script = tmp_path / "worker.py"
    script.write_text(
        "import os, sys, torch\n"
        f"sys.path.insert(0, {W.REPO!r})\n"
        "torch.set_num_threads(1)\n"
        "from incubator_mxnet_tpu_torch import parallel\n"
        "parallel.initialize(device='cpu')\n"
        "assert parallel.process_count() == 2\n"
        "x = parallel.all_reduce(torch.ones(3) * (parallel.process_index()"
        " + 1), None)\n"
        "assert x.tolist() == [3.0] * 3, x\n"
        "open(os.path.join(sys.argv[1], 'ok%d' % parallel.process_index()),"
        " 'w').close()\n"
        "parallel.finalize()\n")
    env = dict(W.child_env())
    rc = launch.launch_local(2, [W.PYTHON, str(script), str(tmp_path)],
                             env=env, timeout=W.JOIN_TIMEOUT_S)
    assert rc == 0 and (tmp_path / "ok0").exists() \
        and (tmp_path / "ok1").exists()
    bad = launch.launch_local(2, [W.PYTHON, "-c", "raise SystemExit(3)"],
                              env=env, timeout=W.JOIN_TIMEOUT_S)
    assert bad == 3
