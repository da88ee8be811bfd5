"""PyTorch port: the thirteen optimizers beyond SGD/Adam/AdamW, held
against the JAX package on the CPU.

- Each of NAG, RMSProp (plain and centered with ``clip_weights``),
  AdaGrad, AdaDelta, FTRL, Signum (with and without momentum), LAMB,
  LARS, DCASGD (with and without momentum), Adamax, Nadam and FTML: 5
  steps of ``update`` on three weights from the same state, with weight
  decay, ``rescale_grad`` and ``clip_gradient``, against the JAX
  ``update``: within 1e-6 of the largest weight; float32, and bfloat16
  weights under ``multi_precision`` (the float32 masters compared). The
  JAX package makes a ``multi_precision`` state in bfloat16, the port in
  float32 (ROADMAP queue C, kept): AdaDelta, the one rule that rounds a
  first-step value there, is held within 2e-5 of that reference (1.51e-5
  observed by step 4) and within 1e-6 of the JAX run from float32 states.
  ``update_multi`` over the three equals the loop of ``update`` bit for
  bit (one rule, :class:`optimizer._L`, runs both).
- A device ``lr``/``t`` (tensors, as the fused step passes them), with an
  ``lr_mult``: ``update_multi`` equals ``step`` given the same tensors,
  bit for bit; and ``ShardedTrainer``'s fused function (uncaptured, as on
  the CPU) equals its eager step within 1e-5 over 3 steps, SGLD with its
  generator seeded alike.
- SGLD (its noise is Philox, not threefry): the update less the JAX
  step's deterministic part (``w - lr/2 * g``, the JAX SGD step at half
  the rate) has mean 0 and variance ``lr`` within 5 standard errors over
  200,000 draws.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import optimizer as jopt
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, optimizer as opt, parallel

TOL = 1e-6
#: under multi_precision, against the JAX run from its own bfloat16 states
KEPT_TOL = {"adadelta": 2e-5}
COMMON = dict(rescale_grad=0.5, clip_gradient=2.0)

#: case -> (registered name, keyword arguments)
CASES = {
    "nag": ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01, wd=0.01)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01, centered=True,
                                         clip_weights=1.0)),
    "adagrad": ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    "adadelta": ("adadelta", dict(wd=0.01)),
    "ftrl": ("ftrl", dict(learning_rate=0.1, wd=0.01)),
    "signum": ("signum", dict(learning_rate=0.01, wd=0.01, wd_lh=0.01)),
    "signsgd": ("signum", dict(learning_rate=0.01, momentum=0.0)),
    "lamb": ("lamb", dict(learning_rate=0.01, wd=0.01)),
    "lamb_bounds": ("lamb", dict(learning_rate=0.01, lower_bound=0.5,
                                 upper_bound=2.0, bias_correction=False)),
    "lars": ("lars", dict(learning_rate=0.1, wd=0.01)),
    "dcasgd": ("dcasgd", dict(learning_rate=0.1, wd=0.01)),
    "dcasgd_momentum": ("dcasgd", dict(learning_rate=0.1, momentum=0.9)),
    "adamax": ("adamax", dict(wd=0.01)),
    "nadam": ("nadam", dict(wd=0.01)),
    "ftml": ("ftml", dict(wd=0.01)),
}
#: the weights compared with the JAX package: one shape (each eager JAX
#: op compiles per shape), three tensors (LAMB's and LARS's norms are per
#: tensor); the port-only tests take three shapes
SHAPES_JAX = [(4, 3)] * 3
SHAPES = [(4, 3), (5,), (2, 3, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, steps=5, shapes=SHAPES):
    rng = onp.random.RandomState(seed)
    ws = [rng.randn(*s).astype("float32") for s in shapes]
    gs = [[rng.randn(*s).astype("float32") for s in shapes]
          for _ in range(steps)]
    return ws, gs


def _f32_states(state):
    """The JAX package creates a ``multi_precision`` state in the weight's
    dtype beside its float32 master, and the first update promotes it; the
    port (as upstream MXNet) creates it on the master, in float32. Their
    values are the same (zeros, or the weight), but AdaDelta's first step
    takes ``sqrt(0 + eps)`` in bfloat16 there: its second reference starts
    from the same states in float32."""
    return tuple(s.astype("float32") if hasattr(s, "astype") else s
                 for s in state)


def _jax_runs(ws0, gs):
    """Every case's JAX weights (masters under ``multi_precision``) after
    the 5 ``update`` steps, and the kept-difference cases' run from
    float32 states (``|f32``). Eager: with one weight shape each JAX op
    compiles once per dtype and is reused by every case."""
    out = {}
    runs = [(case, mp, False) for case in CASES for mp in (False, True)]
    runs += [(case, True, True) for case in KEPT_TOL]
    for case, mp, f32 in runs:
        name, kw = CASES[case]
        jo = jopt.create(name, **dict(kw, multi_precision=mp, **COMMON))
        dt = "bfloat16" if mp else "float32"
        jw = [jmx.nd.array(w).astype(dt) for w in ws0]
        js = [jo.create_state_multi_precision(i, w)
              for i, w in enumerate(jw)]
        if f32:
            js = [_f32_states(st) for st in js]
        for g in gs:
            for i, w in enumerate(jw):
                js[i] = jo.update(i, w, jmx.nd.array(g[i]).astype(dt),
                                  js[i])
        out[f"{case}|{mp}" + ("|f32" if f32 else "")] = [
            js[i][0] if mp else w._data for i, w in enumerate(jw)]
    return out


def test_optimizers_match_jax_and_multi():
    """5 steps of ``update``: the JAX numbers within 1e-6 (float32, and
    the masters of bfloat16 weights under ``multi_precision``; AdaDelta's
    there within ``KEPT_TOL`` of the JAX run from its bfloat16 states and
    1e-6 of its run from float32 ones), and ``update_multi`` = ``update``
    bit for bit."""
    ws0, gs = _data(shapes=SHAPES_JAX)
    refs = _jax_runs(ws0, gs)
    for case, (name, kw) in CASES.items():
        for mp in (False, True):
            label = f"{case} multi_precision={mp}"
            kw2 = dict(kw, multi_precision=mp, **COMMON)
            po, mo = opt.create(name, **kw2), opt.create(name, **kw2)
            dt = torch.bfloat16 if mp else torch.float32
            pw = [torch.tensor(w).to(dt) for w in ws0]
            mw = [w.clone() for w in pw]
            ps = [po.create_state_multi_precision(i, w)
                  for i, w in enumerate(pw)]
            ms = [mo.create_state_multi_precision(i, w)
                  for i, w in enumerate(mw)]
            for g in gs:
                gt = [torch.tensor(x).to(dt) for x in g]
                for i in range(len(ws0)):
                    ps[i] = po.update(i, pw[i], gt[i], ps[i])
                mo.update_multi(list(range(len(ws0))), mw, gt, ms)
            checks = [(f"{case}|{mp}", TOL)]
            if mp and case in KEPT_TOL:
                checks = [(f"{case}|{mp}", KEPT_TOL[case]),
                          (f"{case}|{mp}|f32", TOL)]
            for key, tol in checks:
                for i, want in enumerate(refs[key]):
                    want = onp.asarray(want, "float32")
                    got = (ps[i][0] if mp else pw[i]).float().numpy()
                    scale = max(1.0, float(onp.abs(want).max()))
                    err = float(onp.abs(got - want).max()) / scale
                    assert err <= tol, f"{key} weight {i}: {err:.3e}"
            for i in range(len(ws0)):
                assert torch.equal(pw[i], mw[i]), f"{label} multi {i}"
                for a, b in zip(ps[i], ms[i]):
                    assert torch.equal(a, b), f"{label} multi state {i}"


def test_device_lr_and_t_equal_step():
    """``update_multi`` with tensor ``lr`` and ``t`` (an ``lr_mult`` on one
    weight) equals ``step`` per weight given the same tensors."""
    ws0, gs = _data(1, steps=3)
    for case, (name, kw) in list(CASES.items()) + [("sgld", ("sgld", {}))]:
        kw2 = dict(kw, **COMMON)
        mo, so = opt.create(name, **kw2), opt.create(name, **kw2)
        mo.set_lr_mult({1: 0.5})
        mw = [torch.tensor(w) for w in ws0]
        sw = [w.clone() for w in mw]
        # SGLD seeds its generator from mx.random when it makes its state
        mx.random.seed(5)
        ms = [mo.create_state(i, w) for i, w in enumerate(mw)]
        mx.random.seed(5)
        ss = [so.create_state(i, w) for i, w in enumerate(sw)]
        lr = torch.tensor(kw.get("learning_rate", 0.01), dtype=torch.float32)
        for k, g in enumerate(gs):
            t = torch.tensor(k + 1, dtype=torch.int32)
            gt = [torch.tensor(x) for x in g]
            mo.update_multi(list(range(3)), mw, gt, ms, lr=lr,
                            wd=[so._get_wd(i) for i in range(3)], t=t)
            for i in range(3):
                lr_i = lr * (0.5 if i == 1 else 1.0)
                new_w, new_s = so.step(sw[i], gt[i], ss[i], lr_i,
                                       so._get_wd(i), t)
                sw[i], ss[i] = new_w, tuple(new_s)
        for i in range(3):
            assert torch.equal(mw[i], sw[i]), f"{case} weight {i}"


def _sharded_pair(name, kw):
    """Two identical Dense nets and ShardedTrainers of ``name``."""
    out = []
    for _ in range(2):
        mx.random.seed(3)
        net = gluon.nn.HybridSequential(prefix="optnet_")
        with net.name_scope():
            net.add(gluon.nn.Dense(6, activation="tanh", in_units=5))
            net.add(gluon.nn.Dense(3, in_units=6))
        net.initialize(ctx=mx.cpu())
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        out.append(parallel.ShardedTrainer(
            net, lambda o, lab: ce(o, lab), name, dict(kw), device="cpu"))
    return out


def test_sharded_trainer_fused_function_equals_eager():
    """Each optimizer through ``ShardedTrainer``: its fused step's
    function (device ``lr``/``t``, ``update_multi``; uncaptured on the
    CPU) against its eager step (``step`` per parameter), 3 steps: losses
    and weights within 1e-5."""
    rng = onp.random.RandomState(4)
    batches = [(rng.randn(8, 5).astype("float32"),
                rng.randint(0, 3, 8).astype("float32")) for _ in range(3)]
    for case, (name, kw) in list(CASES.items()) + [("sgld", ("sgld", {}))]:
        fused, eager = _sharded_pair(name, kw)
        for k, b in enumerate(batches):
            vals = fused.place(*b)
            if fused._params is None:
                # SGLD seeds its generator from mx.random with its state
                mx.random.seed(7)
                fused._init_state(vals[:1])
            lf = fused._fused_step(vals, capture=False)
            if k == 0:
                mx.random.seed(7)
            le = eager.step(*b)
            assert abs(float(lf) - float(le)) <= 1e-5, case
        for (n, pf), (_, pe) in zip(sorted(fused._block.named_parameters()),
                                    sorted(eager._block.named_parameters())):
            err = float((pf - pe).detach().abs().max())
            assert err <= 1e-5, f"{case} {n}: {err:.3e}"


def test_sgld_noise_and_mean_update():
    """SGLD less the JAX step's deterministic part: mean 0 and variance
    ``lr`` within 5 standard errors over 200,000 draws;
    ``mx.random.seed`` repeats the draws."""
    n, lr = 200_000, 0.04
    rng = onp.random.RandomState(6)
    w, g = rng.randn(n).astype("float32"), rng.randn(n).astype("float32")
    kw = dict(learning_rate=lr, wd=0.01, **COMMON)
    det = jmx.nd.array(w)
    jopt.create("sgd", **dict(kw, learning_rate=lr / 2)).update(
        0, det, jmx.nd.array(g), ())
    det = det.asnumpy()
    draws = []
    for _ in range(2):
        mx.random.seed(9)
        po = opt.create("sgld", **kw)
        pw = torch.tensor(w)
        po.update(0, pw, torch.tensor(g), po.create_state(0, pw))
        draws.append(pw.numpy())
    assert onp.array_equal(draws[0], draws[1])
    r = draws[0].astype("float64") - det
    assert abs(r.mean()) <= 5 * (lr / n) ** 0.5
    assert abs(r.var() - lr) <= 5 * lr * (2.0 / n) ** 0.5
    assert isinstance(opt.create("Ftrl"), opt.FTRL)
    assert opt.Ftrl is opt.FTRL
