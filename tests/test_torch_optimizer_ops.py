"""PyTorch port: the ``mx.nd`` optimizer-update and AMP-cast ops held
against the JAX package's (``ops/optimizer_ops.py``) on the CPU.

The cases of ``tests/test_optimizer_ops.py``, each run through both
packages on the same seeded numpy inputs, and every op of the surface
against its JAX twin. Tolerance: rtol 1e-6 with atol 1e-7 (float32, the
same formula; sqrt and division are correctly rounded in both, so only a
different association of a multiply-add could move the last bit), exact
for the casts.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch import optimizer as opt
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import optimizer_ops

RTOL, ATOL = 1e-6, 1e-7
NAMES = ("sgd_update", "sgd_mom_update", "mp_sgd_update",
         "mp_sgd_mom_update", "adam_update", "adamw_update",
         "nag_mom_update", "signsgd_update", "signum_update",
         "ftrl_update", "rmsprop_update", "lamb_update_phase1",
         "lamb_update_phase2", "mp_lamb_update_phase1",
         "mp_lamb_update_phase2", "multi_sgd_update",
         "multi_sgd_mom_update", "multi_mp_sgd_update",
         "multi_mp_sgd_mom_update", "multi_sum_sq", "amp_cast",
         "amp_multicast")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _rand(shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


def _both(name, arrays, **kwargs):
    """``name`` on the same numpy inputs in the port and in the JAX
    package: two lists of numpy outputs."""
    outs = []
    for pkg in (mx, jmx):
        r = getattr(pkg.nd, name)(*[pkg.nd.array(a) for a in arrays],
                                  **kwargs)
        r = r if isinstance(r, (list, tuple)) else [r]
        outs.append([onp.asarray(x.asnumpy(), dtype="float32") for x in r])
    return outs


def test_names_exposed():
    for name in NAMES:
        assert callable(getattr(nd, name)), name
        assert name in optimizer_ops.__all__


W, G = _rand((3, 4), 1), _rand((3, 4), 2)
M, V = _rand((3, 4), 3), onp.abs(_rand((3, 4), 4))
CASES = {
    "sgd_update": ([W, G], dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    "sgd_update_clip": ([W, G * 10], dict(lr=1.0, clip_gradient=1.0)),
    "sgd_mom_update": ([W, G, M], dict(lr=0.1, momentum=0.9, wd=0.01)),
    "mp_sgd_update": ([W, G, W], dict(lr=0.1, wd=0.02)),
    "mp_sgd_mom_update": ([W, G, M, W], dict(lr=0.1, momentum=0.9)),
    "adam_update": ([W, G, M, V], dict(lr=0.01, wd=0.01,
                                       clip_gradient=0.5)),
    "adamw_update": ([W, G, M, V, onp.array([0.5], "float32")],
                     dict(lr=0.01, eta=0.5, wd=0.1)),
    "nag_mom_update": ([W, G, M], dict(lr=0.1, momentum=0.9, wd=0.01)),
    "signsgd_update": ([W, G], dict(lr=0.1, wd=0.01)),
    "signum_update": ([W, G, M], dict(lr=0.1, momentum=0.9, wd_lh=0.01)),
    "ftrl_update": ([W, G, M, V], dict(lr=0.1, lamda1=0.01, beta=1.0)),
    "rmsprop_update": ([W, G, V], dict(lr=0.01, gamma1=0.9,
                                       clip_weights=1.0)),
    "lamb_update_phase1": ([W, G, M, V], dict(t=3, wd=0.01)),
    "lamb_update_phase2": ([W, G, onp.array([2.0], "float32"),
                            onp.array([0.5], "float32")],
                           dict(lr=0.01, lower_bound=0.1, upper_bound=1.5)),
    "mp_lamb_update_phase1": ([W, G, M, V, W], dict(t=2)),
    "mp_lamb_update_phase2": ([W, G, onp.array([2.0], "float32"),
                               onp.array([0.5], "float32"), W],
                              dict(lr=0.01)),
    "multi_sgd_update": ([W, G, M, V], dict(lrs="0.1, 0.2",
                                            wds=[0.0, 0.01],
                                            num_weights=2)),
    "multi_sgd_mom_update": ([W, G, M, V, G, M],
                             dict(lrs=[0.1, 0.2], wds=0.01, momentum=0.9,
                                  num_weights=2)),
    "multi_mp_sgd_update": ([W, G, W, M, V, M],
                            dict(lrs=[0.1, 0.2], wds=[0.0, 0.0],
                                 num_weights=2, clip_gradient=0.3)),
    "multi_mp_sgd_mom_update": ([W, G, M, W, V, G, M, V],
                                dict(lrs=[0.1, 0.1], wds=[0.01, 0.0],
                                     momentum=0.9, num_weights=2)),
    "multi_sum_sq": ([W, G, M], dict(num_arrays=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    name = case[:-5] if case.endswith("_clip") else case
    arrays, kwargs = CASES[case]
    got, want = _both(name, arrays, **kwargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_sgd_update_clip_gradient():
    out = nd.sgd_update(nd.zeros((4,)), nd.array([10.0, -10.0, 0.5, -0.5]),
                        lr=1.0, clip_gradient=1.0)
    onp.testing.assert_allclose(out.asnumpy(), [-1.0, 1.0, -0.5, 0.5])


def test_sgd_mom_update_matches_optimizer_class():
    """Two steps through the op equal two steps of the port's SGD."""
    w, g = _rand((5,), 3), _rand((5,), 4)
    nw, nm = nd.sgd_mom_update(nd.array(w), nd.array(g), nd.zeros((5,)),
                               lr=0.1, momentum=0.9, wd=0.01)
    nw2, _ = nd.sgd_mom_update(nw, nd.array(g), nm, lr=0.1, momentum=0.9,
                               wd=0.01)
    o = opt.SGD(learning_rate=0.1, momentum=0.9, wd=0.01)
    wc = nd.array(w)
    state = o.create_state(0, wc._data)
    for _ in range(2):
        state = o.update(0, wc, nd.array(g), state)
    onp.testing.assert_allclose(nw2.asnumpy(), wc.asnumpy(), rtol=1e-6)


def test_mp_sgd_update_keeps_fp32_master():
    w32 = _rand((6,), 5)
    g = _rand((6,), 6).astype(onp.float16)
    nw, nw32 = nd.mp_sgd_update(nd.array(w32.astype(onp.float16)),
                                nd.array(g), nd.array(w32), lr=0.1)
    assert nw.dtype == onp.float16 and nw32.dtype == onp.float32
    onp.testing.assert_allclose(nw32.asnumpy(),
                                w32 - 0.1 * g.astype("float32"), rtol=1e-6)


def test_lamb_phases_compose_like_jax():
    """phase1 -> norms -> phase2 through both packages gives one weight."""
    out = []
    for pkg in (mx, jmx):
        w, g = pkg.nd.array(W), pkg.nd.array(G)
        d, _, _ = pkg.nd.lamb_update_phase1(
            w, g, pkg.nd.zeros((3, 4)), pkg.nd.zeros((3, 4)), t=1, wd=0.01)
        r1 = pkg.nd.array([onp.linalg.norm(W)])
        r2 = pkg.nd.array([onp.linalg.norm(d.asnumpy())])
        out.append(pkg.nd.lamb_update_phase2(w, d, r1, r2,
                                             lr=0.01).asnumpy())
    onp.testing.assert_allclose(out[0], out[1], rtol=RTOL, atol=ATOL)


def test_multi_mp_sgd_mom_update_roundtrip():
    args = []
    for i in range(2):
        w32 = _rand((4,), 20 + i)
        args += [nd.array(w32.astype("float16")),
                 nd.array(_rand((4,), 30 + i).astype("float16")),
                 nd.zeros((4,)), nd.array(w32)]
    outs = nd.multi_mp_sgd_mom_update(*args, lrs=[0.1, 0.1], wds=[0.0, 0.0],
                                      momentum=0.9, num_weights=2)
    assert len(outs) == 6
    assert outs[0].dtype == onp.float16 and outs[2].dtype == onp.float32
    with pytest.raises(ValueError, match="lrs"):
        nd.multi_sgd_update(*args[:4], wds=0.0, num_weights=2)


def test_multi_sum_sq():
    a, b = _rand((3, 3), 15), _rand((5,), 16)
    sa, sb = nd.multi_sum_sq(nd.array(a), nd.array(b), num_arrays=2)
    onp.testing.assert_allclose(sa.asnumpy(), (a * a).sum(), rtol=1e-5)
    onp.testing.assert_allclose(sb.asnumpy(), (b * b).sum(), rtol=1e-5)
    one = nd.multi_sum_sq(nd.array(a).astype("bfloat16"), num_arrays=1)
    assert one.dtype == onp.float32


def test_amp_cast_and_multicast():
    for pkg in (mx, jmx):
        x = pkg.nd.array(_rand((3,), 17))
        y = pkg.nd.amp_cast(x, dtype="bfloat16")
        assert str(y.dtype) == "bfloat16"
        lo = pkg.nd.amp_cast(x, dtype="float16")
        a, b = pkg.nd.amp_multicast(lo, x, num_outputs=2)
        assert a.asnumpy().dtype == onp.float32
        c, d = pkg.nd.amp_multicast(lo, x, num_outputs=2, cast_narrow=True)
        assert c.asnumpy().dtype == d.asnumpy().dtype == onp.float16
    with pytest.raises(ValueError, match="dtype"):
        nd.amp_cast(x, dtype="int3")


def test_out_kwarg_inplace_assignment():
    """``out=[weight, mom]`` writes the results into those arrays in place,
    as the JAX package's ``out=`` does; an array on the tape refuses it
    while recording."""
    got = []
    for pkg in (mx, jmx):
        w = pkg.nd.array(_rand((3,), 18))
        g = pkg.nd.array(_rand((3,), 19))
        mom = pkg.nd.zeros((3,))
        ref = pkg.nd.sgd_mom_update(w, g, mom, lr=0.1, momentum=0.9)
        w2 = pkg.nd.array(w.asnumpy())
        back = pkg.nd.sgd_mom_update(w2, g, mom, lr=0.1, momentum=0.9,
                                     out=[w2, mom])
        assert back[0] is w2
        onp.testing.assert_allclose(w2.asnumpy(), ref[0].asnumpy())
        onp.testing.assert_allclose(mom.asnumpy(), ref[1].asnumpy())
        got.append(w2.asnumpy())
    onp.testing.assert_allclose(got[0], got[1], rtol=RTOL)
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 2
        with pytest.raises(MXNetError, match="In-place"):
            nd.sgd_update(x, x, lr=0.1, out=y)


def test_adamw_update_decoupled_decay_not_scaled_by_lr():
    w, g = _rand((4,), 15), _rand((4,), 16)
    lr, eta, wd = 0.01, 0.5, 0.1
    nw, _, _ = nd.adamw_update(nd.array(w), nd.array(g), nd.zeros((4,)),
                               nd.zeros((4,)), nd.array([1.0]), lr=lr,
                               eta=eta, wd=wd)
    mr, vr = 0.1 * g, 0.001 * g * g
    ref = w - eta * (lr * mr / (onp.sqrt(vr) + 1e-8) + wd * w)
    onp.testing.assert_allclose(nw.asnumpy(), ref, rtol=1e-5)
    wrong = w - eta * lr * (mr / (onp.sqrt(vr) + 1e-8) + wd * w)
    assert not onp.allclose(nw.asnumpy(), wrong)


def test_ops_on_tensors_are_pure():
    """Given tensors, an op returns new tensors and leaves its inputs."""
    w = torch.from_numpy(W.copy())
    before = w.clone()
    new_w, new_m = optimizer_ops.sgd_mom_update(
        w, torch.from_numpy(G), torch.zeros(3, 4), lr=0.1, momentum=0.9)
    assert torch.equal(w, before) and new_w is not w
    jw = jnp.asarray(W)
    assert new_m.shape == jw.shape
