"""PyTorch port: detection held against the JAX package on the CPU.

Every op of ``ops/detection.py`` on seeded inputs, the same in both
packages: the box helpers, ``box_nms`` (with ``topk``, classes,
formats), ``bipartite_matching``, the MultiBox ops, ROIAlign (plain,
aligned, position-sensitive), ROIPooling, the RPN's anchors, proposals
and targets, deformable convolution and PS-ROI pooling; ties built on
purpose (equal scores, a uniform image, equal negative losses, an
all-equal score matrix); the ``topk``-cut NMS loop against the JAX full
loop. The models are in ``tests/test_torch_detection_models.py``. Each
test runs several cases: a file of more tests than
``tests/test_examples.py`` would be handed to a worker before it under
``--dist loadfile`` and lengthen the suite.

Tolerances: integer and boolean outputs (kept rows, ids, labels, matches,
roi order, class targets) exact; float32 values ``rtol=atol=1e-5``,
gradients within 1e-5 of the largest |gradient| (another summation order
in ``mean`` and the interpolation products).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.ops import detection as jdet

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ops import detection as tdet

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


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return onp.asarray(x)


def _both(name, *args, **kw):
    """The op ``name`` of both packages on the same numpy ``args``:
    ``(port, jax)`` outputs as numpy."""
    fn = getattr(jdet, name)
    want = _jit(lambda *a: fn(*a, **kw))(*[jnp.asarray(a) for a in args])
    got = getattr(tdet, name)(*[torch.from_numpy(onp.array(a))
                                for a in args], **kw)
    return _np(got), _np(want)


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


def _boxes(rng, *shape, lo=0.0, hi=1.0, min_wh=0.05):
    """Corner boxes (..., 4) inside [lo, hi]."""
    a = rng.uniform(lo, hi, shape + (2,))
    b = rng.uniform(lo, hi, shape + (2,))
    x1, x2 = onp.minimum(a[..., 0], b[..., 0]), onp.maximum(a[..., 0],
                                                            b[..., 0])
    y1, y2 = onp.minimum(a[..., 1], b[..., 1]), onp.maximum(a[..., 1],
                                                            b[..., 1])
    return onp.stack([x1, y1, x2 + min_wh, y2 + min_wh], -1).astype(
        "float32")


def _vjp_same(name, args, diff, kw, seed=1, tol=TOL):
    """Outputs and the gradients of the arguments at ``diff`` for one
    seeded cotangent, both packages."""
    jargs = [jnp.asarray(a) for a in args]

    def jf(*d):
        full = list(jargs)
        for i, v in zip(diff, d):
            full[i] = v
        return getattr(jdet, name)(*full, **kw)

    d0 = [jargs[i] for i in diff]
    shape = jax.eval_shape(jf, *d0).shape
    cot = onp.random.RandomState(seed).randn(*shape).astype("float32")

    def out_and_vjp(d, c):
        out, vjp = jax.vjp(jf, *d)
        return out, vjp(c)

    want, jg = _jit(out_and_vjp)(d0, jnp.asarray(cot))
    targs = [torch.from_numpy(onp.array(a)) for a in args]
    for i in diff:
        targs[i].requires_grad_(True)
    got = getattr(tdet, name)(*targs, **kw)
    _same(_np(got), _np(want), tol=tol)
    tg = torch.autograd.grad(got, [targs[i] for i in diff],
                             torch.from_numpy(cot), allow_unused=True)
    for g, w in zip(tg, jg):
        w = onp.asarray(w)
        g = onp.zeros_like(w) if g is None else g.numpy()
        onp.testing.assert_allclose(g, w, rtol=tol,
                                    atol=tol * max(1.0, onp.abs(w).max()))


# ---------------------------------------------------------------------------
# box helpers, NMS, matching
# ---------------------------------------------------------------------------

def test_box_iou_and_format_helpers():
    rng = onp.random.RandomState(0)
    a, b = _boxes(rng, 2, 5), _boxes(rng, 2, 7)
    # a degenerate box (zero area) and a disjoint pair give 0, not NaN
    a[0, 0] = [0.3, 0.3, 0.3, 0.3]
    _same(*_both("box_iou", a, b))
    _same(*_both("box_iou", a, b, format="center"))
    for name in ("_center_to_corner", "_corner_to_center"):
        _same(*_both(name, a))


BOX_NMS_CASES = {
    "plain": dict(),
    "classes": dict(id_index=0, overlap_thresh=0.3),
    "force": dict(id_index=0, force_suppress=True, overlap_thresh=0.3),
    "topk": dict(id_index=0, topk=7, valid_thresh=0.2),
    "background": dict(id_index=0, background_id=1),
    "center_in": dict(in_format="center", out_format="corner"),
    "center_out": dict(out_format="center", overlap_thresh=0.2),
}


def test_box_nms():
    """Every case of :data:`BOX_NMS_CASES` on (2, 3, 24, 7) rows; then
    equal scores on identical and overlapping boxes: which row survives
    and the order of the survivors follow the stable sort."""
    rng = onp.random.RandomState(1)
    N = 24
    data = onp.concatenate([
        rng.randint(0, 3, (2, 3, N, 1)).astype("float32"),
        rng.rand(2, 3, N, 1).astype("float32"),
        _boxes(rng, 2, 3, N, hi=0.6, min_wh=0.2),
        rng.rand(2, 3, N, 1).astype("float32")], -1)
    for case, kw in sorted(BOX_NMS_CASES.items()):
        got, want = _both("box_nms", data, **kw)
        _same(got, want, exact=True)
        assert (want[..., 0] == -1).any() and (want[..., 0] >= 0).any(), \
            case
    rng = onp.random.RandomState(2)
    N = 16
    boxes = onp.repeat(_boxes(rng, 4, min_wh=0.3), 4, axis=0)    # 4 x 4 dup
    scores = onp.array([0.5, 0.5, 0.9, 0.5] * 4, "float32")[:, None]
    ids = onp.array([0, 1, 0, 0] * 4, "float32")[:, None]
    data = onp.concatenate([ids, scores, boxes], -1)[None].repeat(2, 0)
    data[1, :, 1] = 0.7                                   # every score equal
    for kw in (dict(id_index=0), dict(), dict(topk=5),
               dict(id_index=0, force_suppress=True)):
        got, want = _both("box_nms", data, **kw)
        _same(got, want, exact=True)


def test_box_nms_topk_cut_matches_full_loop():
    """The port runs its loop over the first ``topk`` sorted rows only; the
    JAX package loops over all N. Same rows kept, in the same order."""
    rng = onp.random.RandomState(3)
    N = 200
    data = onp.concatenate([
        rng.randint(0, 4, (3, N, 1)).astype("float32"),
        onp.round(rng.rand(3, N, 1), 1).astype("float32"),   # many ties
        _boxes(rng, 3, N, hi=0.7, min_wh=0.1)], -1)
    for topk in (17, 199, 400):
        got, want = _both("box_nms", data, topk=topk, id_index=0,
                          overlap_thresh=0.4, valid_thresh=0.05)
        _same(got, want, exact=True)
        assert (got[:, min(topk, N):] == -1).all()


def test_bipartite_matching():
    """Random scores rounded to ties, and an all-equal matrix (every pick
    a tie, the 2-d form), descending and ascending, with ``topk``."""
    rng = onp.random.RandomState(4)
    data = onp.round(rng.rand(3, 6, 5), 1).astype("float32")
    flat = onp.full((4, 4), 0.8, "float32")
    for kw in (dict(), dict(threshold=0.3, topk=3),
               dict(is_ascend=True, threshold=0.6), dict(threshold=0.0)):
        _same(*_both("bipartite_matching", data, **kw), exact=True)
        _same(*_both("bipartite_matching", flat, **kw), exact=True)


# ---------------------------------------------------------------------------
# SSD ops
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, B=3, N=60, M=3, C=4):
    anchor = _boxes(rng, 1, N, hi=0.8, min_wh=0.1)
    label = onp.full((B, M, 5), -1.0, "float32")
    label[:, :2, 0] = rng.randint(0, C, (B, 2))
    label[:, :2, 1:] = _boxes(rng, B, 2, hi=0.7, min_wh=0.2)
    label[2, 1] = -1.0                               # one image, one object
    cls_pred = rng.randn(B, C + 1, N).astype("float32")
    return anchor, label, cls_pred


def test_multibox_ops():
    """MultiBoxPrior (non-square map: the aspect correction; clip, steps,
    offsets); MultiBoxTarget with and without hard negative mining, and
    with ties: uniform predictions (every negative loss equal), duplicate
    anchors (equal IoUs, so the forced match and the best gt tie), two
    identical gts and a padding gt; MultiBoxDetection (ids exact)."""
    feat = onp.zeros((2, 3, 5, 7), "float32")
    for kw in (dict(sizes=(0.2, 0.27), ratios=(1, 2, 0.5)),
               dict(sizes=(0.5,), ratios=(1,), clip=True),
               dict(sizes=(0.3, 0.6, 0.9), ratios=(1, 3), steps=(0.1, 0.2),
                    offsets=(0.25, 0.75), clip=True)):
        _same(*_both("multibox_prior", feat, **kw))
    anchor, label, cls_pred = _ssd_inputs(onp.random.RandomState(5))
    for kw in (dict(), dict(negative_mining_ratio=3.0),
               dict(negative_mining_ratio=2.0, minimum_negative_samples=7,
                    overlap_threshold=0.3)):
        got, want = _both("multibox_target", anchor, label, cls_pred, **kw)
        _same(got[0], want[0])
        _same(got[1:], want[1:], exact=True)
    rng = onp.random.RandomState(6)
    anchor, label, _ = _ssd_inputs(rng, N=40)
    anchor[0, 20:] = anchor[0, :20]
    label[1, 1] = label[1, 0]
    cls_pred = onp.zeros((3, 5, 40), "float32")
    got, want = _both("multibox_target", anchor, label, cls_pred,
                      negative_mining_ratio=3.0)
    _same(got[0], want[0])
    _same(got[1:], want[1:], exact=True)
    assert (want[2] == -1).any() and (want[2] == 0).any()
    rng = onp.random.RandomState(7)
    N = 60
    anchor = _boxes(rng, 1, N, hi=0.8, min_wh=0.1)
    logits = rng.randn(2, 4, N).astype("float32")
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    loc = (0.3 * rng.randn(2, N * 4)).astype("float32")
    for kw in (dict(), dict(nms_topk=20, threshold=0.1),
               dict(force_suppress=True, clip=False),
               dict(background_id=-1)):
        got, want = _both("multibox_detection", prob, loc, anchor, **kw)
        _same(got, want)
        _same(got[..., 0], want[..., 0], exact=True)


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------

def _rois(rng, R, B, size, scale=1.0):
    """(R, 5) rois ``[batch_idx, x1, y1, x2, y2]`` in pixels; the first
    smaller than a pixel."""
    rois = onp.zeros((R, 5), "float32")
    rois[:, 0] = rng.randint(0, B, R)
    rois[:, 1:] = _boxes(rng, R, hi=size * 0.8, min_wh=2.0) * scale
    rois[0, 1:] = [1.0, 1.0, 1.5, 1.2]                # smaller than a pixel
    return rois


def test_roi_ops():
    """ROIAlign (plain, aligned with 3 samples, position-sensitive):
    outputs and the gradients of data and rois; a constant image pools to
    the constant everywhere (ties in every sample); PSROIPooling is the
    position-sensitive form; ROIPooling with halves that round to even,
    and its data gradient; deformable convolution with groups and
    deformable groups, gradients of data, offsets and weights."""
    rng = onp.random.RandomState(8)
    data = rng.randn(2, 8, 9, 11).astype("float32")
    rois = _rois(rng, 6, 2, 18)
    for kw in (dict(pooled_size=(3, 3), spatial_scale=0.5),
               dict(pooled_size=(2, 4), sample_ratio=3, aligned=True),
               dict(pooled_size=(2, 2), spatial_scale=0.5,
                    position_sensitive=True)):
        _vjp_same("roi_align", [data, rois], (0, 1), kw)
    rng = onp.random.RandomState(9)
    flat = onp.full((1, 8, 6, 6), 0.25, "float32")
    got, want = _both("roi_align", flat, _rois(rng, 4, 1, 6),
                      pooled_size=(2, 2))
    _same(got, want)
    onp.testing.assert_allclose(got, 0.25, rtol=1e-6)
    data = rng.randn(2, 12, 7, 7).astype("float32")
    _same(*_both("psroi_pooling", data, _rois(rng, 5, 2, 14), output_dim=3,
                 pooled_size=2, spatial_scale=0.5))
    rng = onp.random.RandomState(10)
    data = rng.randn(2, 3, 12, 10).astype("float32")
    rois = _rois(rng, 6, 2, 20)
    rois[1, 1:] = [4.5, 2.5, 13.5, 11.5]
    _vjp_same("roi_pooling", [data, rois], (0,),
              dict(pooled_size=(3, 2), spatial_scale=0.5))
    rng = onp.random.RandomState(15)
    data = rng.randn(2, 4, 7, 6).astype("float32")
    kw = dict(kernel=(3, 3), stride=(1, 2), pad=(1, 1), dilate=(1, 1),
              num_filter=6, num_group=2, num_deformable_group=2)
    offset = (1.5 * rng.randn(2, 2 * 2 * 9, 7, 3)).astype("float32")
    weight = (0.2 * rng.randn(6, 2, 3, 3)).astype("float32")
    bias = rng.randn(6).astype("float32")
    _vjp_same("deformable_convolution", [data, offset, weight, bias],
              (0, 1, 2), kw)


# ---------------------------------------------------------------------------
# the RPN path
# ---------------------------------------------------------------------------

def _rpn_anchor_helpers():
    base_t = tdet._base_anchors(8, (2, 4), (0.5, 1, 2))
    base_j = jdet._base_anchors(8, (2, 4), (0.5, 1, 2))
    onp.testing.assert_array_equal(base_t, base_j)
    onp.testing.assert_array_equal(tdet._shifted_anchors(3, 5, 8, base_t),
                                   jdet._shifted_anchors(3, 5, 8, base_j))
    rng = onp.random.RandomState(11)
    anchors = _boxes(rng, 20, hi=50.0, min_wh=4.0)
    deltas = (0.2 * rng.randn(20, 4)).astype("float32")
    for iou_loss in (False, True):
        _same(*_both("_bbox_pred", anchors, deltas, iou_loss=iou_loss))
    _same(*_both("_encode_boxes", anchors, _boxes(rng, 20, hi=50.0)))
    got = tdet._clip_boxes(torch.from_numpy(anchors * 2 - 10), 40.0, 30.0)
    want = jdet._clip_boxes(jnp.asarray(anchors * 2 - 10), 40.0, 30.0)
    _same(_np(got), _np(want))


def _rpn_inputs(rng, B=2, A=6, H=5, W=6, uniform=False):
    logits = rng.randn(B, 2, A, H, W).astype("float32")
    if uniform:
        logits[:] = 0.3
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    cls_prob = prob.reshape(B, 2 * A, H, W)
    bbox = (0.1 * rng.randn(B, 4 * A, H, W)).astype("float32")
    if uniform:
        bbox[:] = 0.0
    info = onp.array([[40, 48, 1.0], [36, 40, 1.5]], "float32")[:B]
    return cls_prob, bbox, info


PROPOSAL_KW = dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12,
                   threshold=0.5, rpn_min_size=4, scales=(2, 4),
                   ratios=(0.5, 1, 2), feature_stride=8)


def test_multi_proposal():
    """rois (and scores) equal; with a uniform image every score ties, so
    the top-k order and the NMS picks follow the lower index; with few
    candidates the scan runs out and pads zeros; the gradients of the
    scores and deltas; ``proposal`` is the one-image form."""
    for case in ("random", "uniform", "score", "iou_loss", "exhausted"):
        _multi_proposal_case(case)
    rng = onp.random.RandomState(13)
    cls_prob, bbox, info = _rpn_inputs(rng)
    _vjp_same("multi_proposal", [cls_prob, bbox, info], (0, 1), PROPOSAL_KW)
    got, want = _both("proposal", cls_prob[:1], bbox[:1], info[:1],
                      **PROPOSAL_KW)
    _same(got, want)


def _multi_proposal_case(case):
    rng = onp.random.RandomState(12)
    cls_prob, bbox, info = _rpn_inputs(rng, uniform=case == "uniform")
    kw = dict(PROPOSAL_KW)
    if case == "score":
        kw["output_score"] = True
    if case == "iou_loss":
        kw["iou_loss"] = True
        bbox = bbox * 20
    if case == "exhausted":
        kw.update(rpn_pre_nms_top_n=10, rpn_post_nms_top_n=16,
                  threshold=0.1)
    got, want = _both("multi_proposal", cls_prob, bbox, info, **kw)
    _same(got, want)
    if case == "exhausted":
        assert (want[:, 1:] == 0).all(axis=1).any()
    if case == "uniform":
        # the same rois as the JAX package to the last bit, order included
        _same(got, want, exact=True)


def test_rpn_targets_and_anchor_helpers():
    """The anchor helpers (numpy copies of the reference's), the box
    decode/encode and clip; AnchorTarget with a border gt and padding;
    ProposalTarget with NMS padding and gt rois."""
    _rpn_anchor_helpers()
    rng = onp.random.RandomState(14)
    cls_prob, _, info = _rpn_inputs(rng)
    gt = onp.full((2, 3, 5), -1.0, "float32")
    gt[0, 0] = [1, 8, 8, 23, 23]
    gt[0, 1] = [2, 0, 20, 15, 39]            # at the border
    gt[1, 0] = [0, 10, 4, 30, 24]
    kw = dict(feature_stride=8, scales=(2, 4), ratios=(0.5, 1, 2))
    got, want = _both("rpn_target", cls_prob, gt, info, **kw)
    _same(got[0], want[0], exact=True)
    _same(got[1:], want[1:])
    assert (want[0] == 1).any() and (want[0] == -1).any()
    rois = onp.zeros((2 * 6, 5), "float32")
    rois[:6, 0], rois[6:, 0] = 0, 1
    rois[:, 1:] = _boxes(rng, 12, hi=30.0, min_wh=4.0)
    rois[1, 1:] = gt[0, 0, 1:]
    rois[7, 1:] = gt[1, 0, 1:] + 1.0
    rois[5, 1:] = 0.0                         # NMS padding
    got, want = _both("proposal_target", rois, gt, num_classes=3,
                      fg_overlap=0.5)
    _same(got[0], want[0], exact=True)
    _same(got[1:], want[1:])
    assert (want[0] > 0).sum() >= 2
