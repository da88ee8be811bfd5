"""PyTorch port: the detection models, the op namespace and the bench's
detection workloads held against the JAX package on the CPU.

SSD (narrow filters) and Faster-RCNN (pre 32, post 8) on the same weights
(``convert.params_from_jax``): outputs, the target losses, one step's
gradients and ``detect``, through both of Faster-RCNN's call signatures;
their parameter names; the op namespace's detection names and aliases
(``mx.nd``, ``contrib.nd``) and the helper ops (``smooth_l1``, the
comparisons, ``broadcast_axis``, ``BlockGrad``, the ``*_like`` fills);
the port bench's ``ssd`` and ``frcnn`` workloads at a tiny size.

Tolerances: outputs and losses ``rtol=atol=1e-5`` after 2-5
convolutions; ids and roi batch indices exact; one step's gradients
within 1e-4 of each parameter's largest (a sum over every anchor and
roi); the fused step's function against the eager step ``rtol=1e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.gluon import _trace
from incubator_mxnet_tpu.gluon.block import _TRACING
from incubator_mxnet_tpu.ops import nn as jnn

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, models, nd
from incubator_mxnet_tpu_torch.convert import params_from_jax

TOL = 1e-5
#: XLA:CPU's cheapest compile: the references are small and run once, so
#: compiling them takes most of their time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    """``fn`` jitted, compiled with :data:`FAST_COMPILE`."""
    def call(*args):
        return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)
    return call


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






def _same(got, want, exact=False, tol=TOL):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, exact, tol)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=tol, atol=tol)






# ---------------------------------------------------------------------------
# the op namespace
# ---------------------------------------------------------------------------

def test_op_namespace_names_and_helper_ops():
    for name, aliases in mx.nd.op.DETECTION_ALIASES.items():
        for n in (name,) + aliases:
            assert getattr(mx.nd, n) is getattr(mx.nd, name)
            if n.startswith("_contrib_"):
                assert getattr(mx.contrib.nd, n[len("_contrib_"):]) \
                    is getattr(mx.nd, name)
    rng = onp.random.RandomState(16)
    x = (2 * rng.randn(3, 4)).astype("float32")
    y = onp.round(x, 0)
    for s in (1.0, 3.0):
        onp.testing.assert_allclose(
            mx.nd.smooth_l1(nd.array(x), scalar=s).asnumpy(),
            onp.asarray(jnn.smooth_l1(jnp.asarray(x), scalar=s)),
            rtol=TOL, atol=TOL)
    for name in ("equal", "greater", "greater_equal", "broadcast_equal",
                 "broadcast_greater", "broadcast_greater_equal"):
        got = getattr(mx.nd, name)(nd.array(x), nd.array(y))
        want = getattr(jmx.nd, name)(jmx.nd.array(x), jmx.nd.array(y))
        assert got.dtype == want.dtype == "float32"
        onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    b = mx.nd.broadcast_axis(nd.array(x[:, :1]), axis=1, size=5)
    assert b.shape == (3, 5)
    onp.testing.assert_array_equal(b.asnumpy(), onp.repeat(x[:, :1], 5, 1))
    onp.testing.assert_array_equal(mx.nd.zeros_like(nd.array(x)).asnumpy(),
                                   onp.zeros_like(x))
    onp.testing.assert_array_equal(mx.nd.ones_like(nd.array(x)).asnumpy(),
                                   onp.ones_like(x))
    a = nd.array(x)
    a.attach_grad()
    with autograd.record():
        out = (mx.nd.BlockGrad(a * 2) + a).sum()
    out.backward()
    onp.testing.assert_array_equal(a.grad.asnumpy(), onp.ones_like(x))


# ---------------------------------------------------------------------------
# the models: same weights, forward, loss, detection, one step's gradients
# ---------------------------------------------------------------------------

def _ssd_nets():
    return dict(num_classes=2, filters=(8, 8, 8, 8, 8))


FRCNN_KW = dict(num_classes=3, rpn_pre_nms_top_n=32, rpn_post_nms_top_n=8)


def _model_batch():
    rng = onp.random.RandomState(17)
    x = rng.rand(2, 3, 64, 64).astype("float32")
    x[:, :, 40:, :] = 0.5               # a uniform band: tied features
    ssd_label = onp.full((2, 2, 5), -1.0, "float32")
    ssd_label[:, 0] = [[1, 0.1, 0.2, 0.5, 0.6], [0, 0.4, 0.3, 0.9, 0.8]]
    ssd_label[0, 1] = [0, 0.55, 0.05, 0.95, 0.45]
    gt = onp.full((2, 3, 5), -1.0, "float32")
    gt[0, 0] = [1, 8, 8, 31, 35]
    gt[0, 1] = [2, 30, 20, 60, 50]
    gt[1, 0] = [0, 4, 30, 40, 62]
    info = onp.array([[64, 64, 1.0], [64, 64, 1.0]], "float32")
    return x, ssd_label, gt, info


def _port_net(kind, x, info):
    """A port model on the CPU, initialised (seeded ``Xavier``, shapes
    from one forward)."""
    mx.random.seed(0)
    if kind == "ssd":
        net = models.SSD(**_ssd_nets())
    else:
        net = models.FasterRCNN(output_rpn=True, **FRCNN_KW)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        args = (x,) if kind == "ssd" else (x, info)
        net(*[nd.array(a) for a in args])
    return net


class _JaxFn:
    """A JAX model's forward as a function of its weights (numpy, by JAX
    name): traced once under ``jax.jit`` with the weights as proxies, as
    the JAX trainer traces its step, so each call signature costs one XLA
    program and no eager op."""

    def __init__(self, net, arrays):
        self.net = net
        self.names = sorted(arrays)
        self.params = [net.collect_params()[n] for n in self.names]
        self.vals = [jnp.asarray(arrays[n]) for n in self.names]

    def __call__(self, fn, *args, grads=False):
        def run(pvals, *ins):
            proxies = {id(p): jmx.nd.NDArray(v)
                       for p, v in zip(self.params, pvals)}
            _TRACING.flag = True
            try:
                with jmx.autograd.pause(train_mode=grads), \
                        _trace.TraceScope(proxies):
                    loss, outs = fn(*[jmx.nd.NDArray(v) for v in ins])
            finally:
                _TRACING.flag = False
            return jnp.mean(loss._data), [o._data for o in outs]

        if grads:
            (loss, outs), g = _jit(jax.value_and_grad(run, has_aux=True))(
                self.vals, *args)
            n = len(self.net.prefix)
            return float(loss), [onp.asarray(o) for o in outs], {
                k[n:]: onp.asarray(v) for k, v in zip(self.names, g)}
        loss, outs = _jit(run)(self.vals, *args)
        return [onp.asarray(o) for o in outs]


@pytest.fixture(scope="module")
def jax_models():
    """Each JAX model once on the port's initial weights: its outputs,
    loss and gradients (one jitted program), its outputs without gt and
    its detections."""
    x, ssd_label, gt, info = _model_batch()
    out = {"batch": (x, ssd_label, gt, info)}
    for kind in ("ssd", "frcnn"):
        pnet = _port_net(kind, x, info)
        if kind == "ssd":
            jnet = jmodels.SSD(**_ssd_nets())
        else:
            jnet = jmodels.FasterRCNN(output_rpn=True, **FRCNN_KW)
        jnet.initialize()
        n, jn = len(pnet.prefix), len(jnet.prefix)
        by_suffix = {k[n:]: p for k, p in pnet.collect_params().items()}
        arrays = {k: by_suffix[k[jn:]].data().asnumpy()
                  for k in jnet.collect_params()}
        f = _JaxFn(jnet, arrays)
        ref = {"net": jnet, "arrays": arrays}
        if kind == "ssd":
            loss_fn = jmodels.SSDTargetLoss()

            def train(a, lab):
                outs = jnet(a)
                return loss_fn(*outs, lab), outs

            ref["loss"], ref["outs"], ref["grads"] = f(train, x, ssd_label,
                                                       grads=True)
            ref["detect"] = f(lambda a: (a, [jnet.detect(a)]), x)[0]
        else:
            loss_fn = jmodels.FasterRCNNTargetLoss(num_classes=3)

            def train(a, i, g):
                outs = jnet(a, i, g)
                return loss_fn(*outs, g, i), outs

            ref["loss"], ref["outs"], ref["grads"] = f(train, x, info, gt,
                                                       grads=True)
            ref["plain"] = f(lambda a, i: (a, jnet(a, i)), x, info)
            ref["detect"] = f(lambda a, i: (a, [jnet.detect(
                a, i, threshold=0.0)]), x, info)[0]
        out[kind] = ref
    return out


def _port_grads(net):
    n = len(net.prefix)
    return {k[n:]: p.grad().asnumpy() for k, p in
            net.collect_params().items() if p.grad_req != "null"}


def _grads_close(got, want, rtol=1e-4):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(onp.abs(w).max(), 1e-12)
        err = onp.abs(got[k] - w).max() / scale
        assert err <= rtol, (k, err)


def test_ssd_matches_jax(jax_models):
    """SSD (narrow filters) on the JAX weights: the three outputs, the
    target loss, one step's gradients, and ``detect``'s rows."""
    ref = jax_models["ssd"]
    x, ssd_label, _, _ = jax_models["batch"]
    net = models.SSD(**_ssd_nets())
    net.initialize()
    net(nd.array(x))
    params_from_jax(net, ref["arrays"])
    net.hybridize()
    loss_fn = models.SSDTargetLoss()
    with autograd.record():
        cp, bp, an = net(nd.array(x))
        loss = loss_fn(cp, bp, an, nd.array(ssd_label))
    loss.backward()
    for g, w in zip((cp, bp, an), ref["outs"]):
        onp.testing.assert_allclose(g.asnumpy(), w, rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(float(loss.asnumpy()), ref["loss"],
                                rtol=TOL)
    _grads_close(_port_grads(net), ref["grads"])
    det = net.detect(nd.array(x)).asnumpy()
    want = ref["detect"]
    onp.testing.assert_array_equal(det[..., 0], want[..., 0])
    onp.testing.assert_allclose(det, want, rtol=TOL, atol=TOL)


def test_faster_rcnn_matches_jax(jax_models):
    """Faster-RCNN (pre 32, post 8) on the JAX weights, through both call
    signatures: ``(x, info, gt)`` with the RPN outputs, the four-way loss
    and one step's gradients; ``(x, info)``; and ``detect``. The rois
    (their order included) are the reference's."""
    ref = jax_models["frcnn"]
    x, _, gt, info = jax_models["batch"]
    net = models.FasterRCNN(output_rpn=True, **FRCNN_KW)
    net.initialize()
    net(nd.array(x), nd.array(info))
    params_from_jax(net, ref["arrays"])
    net.hybridize()
    loss_fn = models.FasterRCNNTargetLoss(num_classes=3)
    with autograd.record():
        outs = net(nd.array(x), nd.array(info), nd.array(gt))
        loss = loss_fn(*outs, nd.array(gt), nd.array(info))
    loss.backward()
    assert [o.shape for o in outs] == [w.shape for w in ref["outs"]]
    for g, w in zip(outs, ref["outs"]):
        onp.testing.assert_allclose(g.asnumpy(), w, rtol=TOL, atol=TOL)
    onp.testing.assert_array_equal(outs[2].asnumpy()[:, 0],
                                   ref["outs"][2][:, 0])
    onp.testing.assert_allclose(float(loss.asnumpy()), ref["loss"],
                                rtol=TOL)
    _grads_close(_port_grads(net), ref["grads"])
    plain = net(nd.array(x), nd.array(info))
    assert len(plain) == 5 and plain[0].shape == (2, 8, 4)
    for g, w in zip(plain, ref["plain"]):
        onp.testing.assert_allclose(g.asnumpy(), w, rtol=TOL, atol=TOL)
    det = net.detect(nd.array(x), nd.array(info), threshold=0.0).asnumpy()
    want = ref["detect"]
    assert det.shape == want.shape == (2, 8 * 3, 6)
    onp.testing.assert_array_equal(det[..., 0], want[..., 0])
    onp.testing.assert_allclose(det, want, rtol=TOL, atol=1e-4)


def test_detection_model_names_and_parameters(jax_models):
    """The port's models carry the JAX package's parameter names and
    shapes, and ``ssd_300`` builds the bench's SSD."""
    for key, net in (("ssd", models.SSD(**_ssd_nets())),
                     ("frcnn", models.FasterRCNN(**FRCNN_KW))):
        jnet = jax_models[key]["net"]
        n, jn = len(net.prefix), len(jnet.prefix)
        assert sorted(k[n:] for k in net.collect_params()) == sorted(
            k[jn:] for k in jnet.collect_params())
    assert isinstance(models.ssd_300(), models.SSD)
    assert models.ssd_300()._num_classes == 20


def _jax_bench_module():
    import importlib.util
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(repo, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", ["ssd", "frcnn"])
def test_bench_detection_workload_on_cpu(workload, monkeypatch):
    """The port bench's ``ssd`` / ``frcnn`` workload at a tiny size on the
    CPU: the JAX bench's GMAC formulas and JSON keys, finite losses, and
    the fused step's function (run uncaptured) equal to the eager step."""
    from incubator_mxnet_tpu_torch import bench
    jbench = _jax_bench_module()
    assert bench._ssd_gmacs(300, 20) == jbench._ssd_gmacs(300, 20)
    assert bench._frcnn_gmacs(224, R=132) == jbench._frcnn_gmacs(224, R=132)
    for k, v in dict(MXTPU_BENCH_BATCH="1", MXTPU_BENCH_IMG="64").items():
        monkeypatch.setenv(k, v)
    build = {"ssd": bench.build_ssd, "frcnn": bench.build_frcnn}[workload]
    tr_e, batch, info = build("cpu")
    tr_f, _, _ = build("cpu")
    timings = {}
    dt, losses = bench.measure(tr_e, batch, 1, timings)
    rec = bench.detection_result(info, dt, losses, timings["first_step_s"])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert {"step_ms", "mfu", "batch", "img", "backend", "loss"} <= set(
        rec["extra"])
    assert rec["metric"] == {"ssd": "ssd300", "frcnn": "frcnn"}[workload] \
        + "_train_imgs_per_sec_per_chip"
    assert all(onp.isfinite(float(v)) for v in losses)
    # the fused step's function, uncaptured, against the eager steps: each
    # step's loss reads the weights the step before left
    placed = tr_f.place(*batch)
    tr_f._init_state(placed[:len(placed) - tr_f._n_labels])
    for want in losses[:2]:
        got = tr_f._fused_step(placed, capture=False)
        onp.testing.assert_allclose(float(got), float(want), rtol=1e-6)
