"""PyTorch port: learning-rate schedules, the optimizer base and the
multi-tensor update, held against the JAX package on the CPU.

- Every scheduler's value over ``num_update`` 0..50 equals the JAX one
  (rtol 1e-7: both are the same Python float arithmetic), and the device
  twin ``torch_lr`` equals ``jax_lr`` (rtol 1e-6: float32 on both sides,
  transcendental functions of two libraries).
- The base: ``begin_num_update``, ``lr_scheduler``, ``set_lr_mult`` /
  ``set_wd_mult`` and ``create(..., **kwargs)`` give the reference's
  ``num_update`` and weights (rtol 1e-6: the same float32 update).
- ``update_multi`` against a loop of the per-parameter ``update``: SGD with
  and without momentum, Adam and AdamW; float32, and bfloat16 with and
  without ``multi_precision``; mixed ``lr_mult``/``wd_mult``, gradient
  clipping and rescaling: bit for bit on the CPU, where the same arithmetic
  runs op for op. With a device ``lr`` and ``t`` it equals the per-parameter
  ``step`` given the same tensor ``t``, bit for bit.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import lr_scheduler as jsched
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu_torch import lr_scheduler as sched
from incubator_mxnet_tpu_torch import optimizer as opt
from incubator_mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedules(m):
    return {
        "factor": m.FactorScheduler(7, 0.5, base_lr=0.1, warmup_steps=5),
        "factor_floor": m.FactorScheduler(2, 0.1, stop_factor_lr=1e-4,
                                          base_lr=0.1),
        "multifactor": m.MultiFactorScheduler([10, 20, 30], 0.3,
                                              base_lr=0.2),
        "poly": m.PolyScheduler(40, base_lr=0.1, pwr=2, final_lr=0.01,
                                warmup_steps=4, warmup_mode="exp"),
        "cosine": m.CosineScheduler(45, base_lr=0.3, final_lr=0.02,
                                    warmup_steps=3, warmup_begin_lr=0.01),
        "linear_warmup": m.LinearWarmUp(m.CosineScheduler(50, base_lr=0.1),
                                        0.0, 8),
    }


@pytest.mark.parametrize("name", sorted(_schedules(sched)))
def test_schedule_matches_jax(name):
    port, ref = _schedules(sched)[name], _schedules(jsched)[name]
    got = [port(n) for n in range(51)]
    want = [ref(n) for n in range(51)]
    onp.testing.assert_allclose(got, want, rtol=1e-7)
    dev = [float(port.torch_lr(torch.tensor(n, dtype=torch.int32)))
           for n in range(51)]
    jdev = [float(ref.jax_lr(jnp.int32(n))) for n in range(51)]
    onp.testing.assert_allclose(dev, jdev, rtol=1e-6)


def _run(pkg_opt, nd, name, steps, kwargs, setup=None):
    """``steps`` updates of two weights through ``pkg_opt``'s ``name``:
    the weights and ``num_update`` after each step."""
    o = pkg_opt.create(name, **kwargs)
    if setup:
        setup(o)
    rng = onp.random.RandomState(3)
    ws = [nd.array(rng.randn(4, 3).astype("float32")),
          nd.array(rng.randn(5).astype("float32"))]
    states = [o.create_state_multi_precision(i, w._data if hasattr(
        w, "_data") and isinstance(w._data, torch.Tensor) else w)
        for i, w in enumerate(ws)]
    out = []
    for _ in range(steps):
        for i, w in enumerate(ws):
            g = nd.array(rng.randn(*w.shape).astype("float32"))
            states[i] = o.update(i, w, g, states[i])
        out.append(([w.asnumpy().copy() for w in ws], o.num_update,
                     o.learning_rate))
    return out


CASES = {
    "begin_num_update": ("sgd", dict(learning_rate=0.1, begin_num_update=3,
                                     momentum=0.9), None),
    "scheduler_adam": ("adam", dict(
        learning_rate=0.05, wd=0.01,
        lr_scheduler="factor"), None),
    "mults_adamw": ("adamw", dict(learning_rate=0.01, wd=0.1),
                    lambda o: (o.set_lr_mult({1: 0.5}),
                               o.set_wd_mult({0: 0.0}))),
    "names_sgd": ("sgd", dict(learning_rate=0.1, wd=0.05, rescale_grad=0.5,
                              clip_gradient=1.0),
                  lambda o: (setattr(o, "idx2name", {0: "w0", 1: "w1"}),
                             o.set_lr_mult({"w1": 2.0}),
                             o.set_wd_mult({"w0": 0.5}))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_base_matches_jax(case):
    """Update counts from ``begin_num_update``, the scheduler's rate, the
    multipliers by index and by name: the reference's numbers."""
    name, kw, setup = CASES[case]
    import incubator_mxnet_tpu_torch as mx
    runs = {}
    for label, pkg_opt, nd, smod in (("port", opt, mx.nd, sched),
                                     ("jax", jopt, jmx.nd, jsched)):
        k = dict(kw)
        if k.get("lr_scheduler") == "factor":
            k["lr_scheduler"] = smod.FactorScheduler(2, 0.5)
        with (mx.cpu() if label == "port" else jmx.cpu()):
            runs[label] = _run(pkg_opt, nd, name, 4, k, setup)
    for (gw, gn, glr), (ww, wn, wlr) in zip(runs["port"], runs["jax"]):
        assert gn == wn
        assert glr == pytest.approx(wlr, rel=1e-12)
        for a, b in zip(gw, ww):
            onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_create_takes_reference_kwargs():
    o = opt.create("sgd", begin_num_update=3, learning_rate=0.2,
                   lazy_update=True)
    assert o.num_update == 3 and o.begin_num_update == 3
    o._update_count(0)
    assert o._index_update_count[0] == 4 and o.num_update == 4
    s = opt.create("adam", lr_scheduler=sched.FactorScheduler(1, 0.5),
                   learning_rate=0.4)
    assert s.lr_scheduler.base_lr == 0.4
    with pytest.raises(MXNetError, match="LRScheduler"):
        s.set_learning_rate(0.1)
    s.num_update = 2
    assert s.learning_rate == pytest.approx(0.1)


OPTIMIZERS = {
    "sgd": dict(learning_rate=0.1, wd=0.01),
    "sgd_momentum": dict(learning_rate=0.1, wd=0.01, momentum=0.9,
                         clip_gradient=0.5, rescale_grad=0.25),
    "adam": dict(learning_rate=0.01, wd=0.01, rescale_grad=0.5),
    "adamw": dict(learning_rate=0.01, wd=0.01, clip_gradient=1.0),
}
TYPES = {"float32": (torch.float32, False), "bf16_mp": (torch.bfloat16, True),
         "bf16": (torch.bfloat16, False)}


def _weights(dtype, steps, seed=0):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn(5, 3, generator=g).to(dtype),
          torch.randn(7, generator=g).to(dtype),
          torch.randn(4, 2, generator=g)]       # a float32 one besides
    grads = [[torch.randn(w.shape, generator=g).to(w.dtype) for w in ws]
             for _ in range(steps)]
    return ws, grads


def _optimizer(case, mp):
    name = case.split("_")[0]
    o = opt.create(name, multi_precision=mp, **OPTIMIZERS[case])
    o.set_lr_mult({1: 0.5})
    o.set_wd_mult({2: 0.0})
    return o


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_update_multi_equals_per_parameter_update(case, dtype):
    torch_dtype, mp = TYPES[dtype]
    results = []
    for multi in (False, True):
        ws, grads = _weights(torch_dtype, 3)
        o = _optimizer(case, mp)
        states = [o.create_state_multi_precision(i, w)
                  for i, w in enumerate(ws)]
        for gs in grads:
            if multi:
                o.update_multi([0, 1, 2], ws, gs, states)
            else:
                states = [o.update(i, w, g, s) for i, (w, g, s) in
                          enumerate(zip(ws, gs, states))]
        results.append((ws, states, o.num_update,
                        dict(o._index_update_count)))
    (wa, sa, na, ca), (wb, sb, nb, cb) = results
    assert na == nb == 3 and ca == cb
    for a, b in zip(wa, wb):
        assert torch.equal(a, b)
    for s1, s2 in zip(sa, sb):
        assert len(s1) == len(s2)
        for a, b in zip(s1, s2):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_update_multi_device_scalars_equal_step(case):
    """With ``lr`` and ``t`` as tensors (the fused step's form) the update
    reads no host value and equals ``step`` given the same tensor ``t``;
    its states stay the same tensors (updated in place)."""
    ws, grads = _weights(torch.float32, 3, seed=1)
    ref = [w.clone() for w in ws]
    o = _optimizer(case, False)
    r = _optimizer(case, False)
    states = [o.create_state_multi_precision(i, w) for i, w in enumerate(ws)]
    rstates = [r.create_state_multi_precision(i, w)
               for i, w in enumerate(ref)]
    ids = [id(a) for s in states for a in s]
    for k, gs in enumerate(grads):
        t = torch.tensor(k + 1, dtype=torch.int32)
        o.update_multi([0, 1, 2], ws, gs, states,
                       lr=torch.tensor(o.learning_rate), t=t)
        for i, (w, g) in enumerate(zip(ref, gs)):
            lr_i = r.learning_rate * r._mult(i, "lr_mult", r.lr_mult)
            new_w, new_s = r.step(w, g, rstates[i], lr_i, r._get_wd(i), t)
            w.copy_(new_w)
            rstates[i] = tuple(new_s)
    assert ids == [id(a) for s in states for a in s]
    for a, b in zip(ws, ref):
        assert torch.equal(a, b)
    with pytest.raises(MXNetError, match="device t"):
        o.update_multi([0], ws[:1], grads[0][:1], states[:1],
                       lr=torch.tensor(0.1), t=[1])


def test_update_groups():
    o = opt.create("adam", multi_precision=True)
    ws = [torch.zeros(2, dtype=torch.bfloat16), torch.zeros(3),
          torch.zeros(4, dtype=torch.bfloat16), torch.zeros(1)]
    states = [o.create_state_multi_precision(i, w) for i, w in enumerate(ws)]
    assert opt.update_groups(o, ws, states) == [[0, 2], [1, 3]]
