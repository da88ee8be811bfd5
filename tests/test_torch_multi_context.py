"""PyTorch port: parameters on several contexts and a sharding rule over
``dp``, held against the JAX package.

- MXNet's single-process data parallelism: ``net.initialize(ctx=[cpu(0),
  cpu(1)])``, ``gluon.utils.split_and_load``, one backward per context's
  loss and ``Trainer.step`` (JAX ``gluon/parameter.py:138-158``,
  ``gluon/trainer.py:124-216``). The port names a second CPU context with
  ``MXTPU_CPU_DEVICES=2``; the JAX package runs on the suite's virtual CPU
  devices. Weights after the first SGD-with-momentum step rtol 1e-5, atol
  1e-6 against JAX, and after two against one context on the whole batch
  (the replicas' summed gradients are the whole batch's, summed in
  another order).
- ``ShardedTrainer`` on dp=2 with a rule over ``dp`` (two gloo ranks,
  ``tests/torch_dist_worker.py``'s ``dp_rule_case``) against the JAX mesh
  trainer on two devices with the same rule, and against one rank:
  losses, gradient norms and weights rtol 1e-5, atol 1e-6.
"""
import jax
import numpy as onp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_dist_worker as W

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.parallel.sharding import ShardingRules as JRules

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import MXNetError

PATTERN = r"dense0_(weight|bias)"


@pytest.fixture(autouse=True)
def _two_cpu_contexts(monkeypatch):
    monkeypatch.setenv("MXTPU_CPU_DEVICES", "2")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = onp.random.RandomState(0)
    arrays = [rng.randn(8).astype("float32") * 0.1,
              rng.randn(8, 6).astype("float32") * 0.4,
              rng.randn(3).astype("float32") * 0.1,
              rng.randn(3, 8).astype("float32") * 0.4]
    batches = [(rng.randn(8, 6).astype("float32"),
                rng.randn(8, 3).astype("float32")) for _ in range(3)]
    return arrays, batches


def _gluon_run(pkg, ctxs, kvstore, arrays, batches, steps=2):
    """``steps`` SGD-with-momentum steps of the MLP on ``ctxs`` through
    ``split_and_load``, the gradients exchanged through ``kvstore`` (a
    type name, None, or ``"store"``: a store object of type ``nccl``);
    returns each parameter's replicas after each step, and the
    losses."""
    with pkg.cpu():
        net = W.mlp_net(pkg, arrays, prefix="ctx_")
        net.collect_params().reset_ctx(ctxs)
        if kvstore == "store":
            kvstore = pkg.kv.create("nccl")
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore=kvstore)
        loss_fn = pkg.gluon.loss.L2Loss()
        losses, reps = [], []
        for x, y in batches[:steps]:
            xs = pkg.gluon.utils.split_and_load(x, ctxs)
            ys = pkg.gluon.utils.split_and_load(y, ctxs)
            with pkg.autograd.record():
                ls = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
            pkg.autograd.backward(ls)
            tr.step(x.shape[0])
            losses.append(sum(float(l.sum().asnumpy()) for l in ls))
            reps.append({name.split("_", 1)[1]:
                         [d.asnumpy() for d in p.list_data()]
                         for name, p in sorted(net.collect_params().items())})
        ctx_of = [str(p.list_ctx()) for p in net.collect_params().values()]
    return reps, losses, ctx_of


@pytest.mark.parametrize("kvstore", [None, "store"])
def test_gluon_step_on_two_contexts_matches_jax(data, kvstore):
    """The replicas' gradients summed (inline, or through a store), one
    update, the weight copied to each replica: after the first step every
    replica equals JAX's (its Trainer with an ``nccl`` store object, the
    one exchange of the JAX package that takes two CPU devices), and
    after two steps the one-context run on the whole batch. The JAX
    package cannot take a second step here: its update leaves each
    replica holding the first device's array, which the next forward on
    ``cpu(1)`` refuses (queue C)."""
    arrays, batches = data
    ctxs = [mx.cpu(0), mx.cpu(1)]
    reps, losses, ctx_of = _gluon_run(mx, ctxs, kvstore, arrays, batches)
    jreps, jlosses, jctx = _gluon_run(jmx, [jmx.cpu(0), jmx.cpu(1)],
                                      "store", arrays, batches, steps=1)
    one, one_losses, _ = _gluon_run(mx, [mx.cpu(0)], kvstore, arrays,
                                    batches)
    assert ctx_of == jctx == ["[cpu(0), cpu(1)]"] * 4
    onp.testing.assert_allclose(losses[:1], jlosses, rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(losses, one_losses, rtol=1e-5, atol=1e-6)
    for name, vals in reps[0].items():
        for v, j in zip(vals, jreps[0][name]):
            onp.testing.assert_allclose(v, j, rtol=1e-5, atol=1e-6,
                                        err_msg=name)
    for name, vals in reps[1].items():
        assert len(vals) == 2 and onp.array_equal(vals[0], vals[1]), name
        onp.testing.assert_allclose(vals[0], one[1][name][0], rtol=1e-5,
                                    atol=1e-6, err_msg=name)


def test_parameter_context_api():
    """``initialize(ctx=[...])``, ``data``/``grad`` per context (each its
    own tensor), ``list_*``, ``set_data``/``zero_grad``/``cast`` on every
    replica, ``reset_ctx`` to a list, and the errors: a context the
    parameter is not on, a CPU context past ``MXTPU_CPU_DEVICES``."""
    c0, c1 = mx.cpu(0), mx.cpu(1)
    with mx.cpu():
        p = mx.gluon.Parameter("w", shape=(2, 3))
        p.initialize(mx.init.One(), ctx=[c0, c1])
        assert p.list_ctx() == [c0, c1]
        d0, d1 = p.data(c0), p.data(c1)
        assert d1.context == c1 and d0.context == c0
        assert d0._data.data_ptr() != d1._data.data_ptr()
        assert [g.context for g in p.list_grad()] == [c0, c1]
        p.set_data(mx.nd.full((2, 3), 2.0))
        assert all((d.asnumpy() == 2).all() for d in p.list_data())
        p.list_grad()[1]._data.fill_(5.0)
        p.zero_grad()
        assert all((g.asnumpy() == 0).all() for g in p.list_grad())
        with pytest.raises(RuntimeError, match="not initialized on"):
            p.data(mx.gpu(0))
        p.cast("float16")
        assert {str(d.dtype) for d in p.list_data()} == {"float16"}
        p.reset_ctx([c1])
        assert p.list_ctx() == [c1] and p.data().context == c1
        x = mx.nd.array(onp.ones((2, 3), "float32"), ctx=c1)
        assert x.context == c1 and x.as_in_context(c1) is x
        assert x.copyto(c0).context == c0
        with pytest.raises(MXNetError, match="device_id out of range"):
            mx.nd.zeros((2,), ctx=mx.cpu(2))


def test_dp_rule_sharded_trainer_matches_jax(data):
    """A rule over ``dp`` on dp=2: the first layer is stored as each
    rank's rows (its momentum too), gathered for the forward; its
    gradient is reduce-scattered over dp. Losses, gradient norms and the
    global weights equal the JAX mesh trainer's with the same rule, and
    the port's one rank."""
    arrays, batches = data
    mesh = jparallel.make_mesh(dp=2, devices=jax.devices()[:2])
    with jmx.cpu():
        net = W.mlp_net(jmx, arrays)
        loss_fn = jmx.gluon.loss.L2Loss()
        jtr = jparallel.ShardedTrainer(
            net, lambda o, t: loss_fn(o, t).mean(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh,
            rules=JRules([(PATTERN, JP("dp"))]), n_labels=1,
            guard=jmx.fault.StepGuard("warn"))
        jlosses = [float(jtr.step(*b).asnumpy()) for b in batches]
    names = [n.split("_", 1)[1] for n, _ in
             sorted(net.collect_params().items())]
    jweights = dict(zip(names, (onp.asarray(jax.device_get(v))
                                for v in jtr._param_vals)))
    ranks = W.run_ranks("dp_rule_case", 2, arrays, batches, PATTERN)
    for r in ranks:
        dp, one = r["dp"], r["one"]
        onp.testing.assert_allclose(dp["losses"], jlosses, rtol=1e-5,
                                    atol=1e-6)
        onp.testing.assert_allclose(dp["losses"], one["losses"], rtol=1e-5,
                                    atol=1e-6)
        onp.testing.assert_allclose(dp["gnorm"], jtr.last_grad_norm,
                                    rtol=1e-5)
        for k, v in dp["weights"].items():
            name = k.split("_", 1)[1]
            onp.testing.assert_allclose(v, jweights[name], rtol=1e-5,
                                        atol=1e-6, err_msg=name)
            onp.testing.assert_allclose(v, one["weights"][k], rtol=1e-5,
                                        atol=1e-6, err_msg=name)
        local = {k.split("_", 1)[1]: v for k, v in dp["local"].items()}
        assert local["dense0_weight"] == ((4, 6), [(4, 6)])
        assert local["dense0_bias"] == ((4,), [(4,)])
        assert local["dense1_weight"][0] == (3, 8)
