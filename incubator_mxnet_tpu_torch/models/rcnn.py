"""Faster-RCNN, and the JAX package's Faster-RCNN example loop.

Counterpart: the JAX package's ``models/rcnn.py`` (``:22-278``) and
``examples/train_frcnn.py`` (:func:`frcnn_example`). The two-stage
pipeline keeps fixed shapes: RPN scores -> top-k -> an NMS scan that emits
exactly ``rpn_post_nms_top_n`` rois (zeros once exhausted), ROIAlign over
fixed sampling grids, and a per-roi head over ``B * R`` rows. So a
hybridized ``FasterRCNN`` captures one CUDA graph per call signature
(``forward(x, im_info)`` and ``forward(x, im_info, gt)`` are two), and the
fused training step captures the whole step.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as onp
import torch

from .. import autograd
from .. import initializer as _init
from ..gluon.block import HybridBlock
from ..ndarray import NDArray
from ..ops.detection import _bbox_pred, _clip_boxes, box_nms
from .. import nn
from .ssd import hit_rate

__all__ = ["FasterRCNN", "RPN", "FasterRCNNTargetLoss", "frcnn_example"]


class _Backbone(HybridBlock):
    """Small conv trunk: per scale a 3x3 convolution with ReLU and a 2x2
    max pool (JAX counterpart: ``models/rcnn.py:22``)."""

    def __init__(self, filters: Sequence[int] = (16, 32, 64), **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.blocks = []
            for i, f in enumerate(filters):
                conv = nn.Conv2D(f, 3, padding=1, activation="relu",
                                 prefix=f"conv{i}_")
                pool = nn.MaxPool2D(2, 2)
                self.register_child(conv, f"conv{i}")
                self.register_child(pool, f"pool{i}")
                self.blocks += [conv, pool]

    def hybrid_forward(self, F, x):
        for b in self.blocks:
            x = b(x)
        return x


class RPN(HybridBlock):
    """Region proposal head (JAX counterpart: ``models/rcnn.py:44``):
    objectness (B, 2A, H, W), softmax over {bg, fg} per anchor, and box
    deltas (B, 4A, H, W). Normal(0.01) heads, as GluonCV's."""

    def __init__(self, channels: int, num_anchors: int, **kw):
        super().__init__(**kw)
        self._A = num_anchors
        with self.name_scope():
            self.conv = nn.Conv2D(channels, 3, padding=1, activation="relu",
                                  prefix="conv_",
                                  weight_initializer=_init.Normal(0.01))
            self.cls = nn.Conv2D(2 * num_anchors, 1, prefix="cls_",
                                 weight_initializer=_init.Normal(0.01))
            self.reg = nn.Conv2D(4 * num_anchors, 1, prefix="reg_",
                                 weight_initializer=_init.Normal(0.01))

    def hybrid_forward(self, F, x):
        h = self.conv(x)
        scores = self.cls(h)
        B, _, H, W = scores.shape
        A = self._A
        s = F.softmax(scores.reshape((B, 2, A, H, W)), axis=1)
        return s.reshape((B, 2 * A, H, W)), self.reg(h)


class FasterRCNN(HybridBlock):
    """Two-stage detector (JAX counterpart: ``models/rcnn.py:78``).

    ``forward(x, im_info)`` -> ``(cls_scores (B, R, num_classes+1),
    box_deltas (B, R, 4*(num_classes+1)), rois (B*R, 5))`` with ``R =
    rpn_post_nms_top_n``; ``forward(x, im_info, gt)`` (training) appends
    the M gt boxes to each image's rois (R + M rows). ``output_rpn=True``
    adds the RPN's ``(rpn_cls, rpn_reg)`` for
    :class:`FasterRCNNTargetLoss`."""

    def __init__(self, num_classes: int,
                 scales: Tuple[float, ...] = (2, 4),
                 ratios: Tuple[float, ...] = (0.5, 1, 2),
                 feature_stride: int = 8,
                 rpn_pre_nms_top_n: int = 64,
                 rpn_post_nms_top_n: int = 16,
                 rpn_min_size: int = 2,
                 roi_size: Tuple[int, int] = (7, 7),
                 backbone_filters: Sequence[int] = (16, 32, 64),
                 output_rpn: bool = False, **kw):
        super().__init__(**kw)
        self._output_rpn = output_rpn
        self._num_classes = num_classes
        self._scales, self._ratios = tuple(scales), tuple(ratios)
        self._stride = feature_stride
        self._pre, self._post = rpn_pre_nms_top_n, rpn_post_nms_top_n
        self._min_size = rpn_min_size
        self._roi_size = tuple(roi_size)
        A = len(scales) * len(ratios)
        with self.name_scope():
            self.backbone = _Backbone(backbone_filters, prefix="backbone_")
            self.rpn = RPN(backbone_filters[-1], A, prefix="rpn_")
            self.head_dense = nn.Dense(128, activation="relu",
                                       prefix="head_", flatten=False)
            self.cls_score = nn.Dense(num_classes + 1, prefix="cls_score_",
                                      flatten=False,
                                      weight_initializer=_init.Normal(0.01))
            self.bbox_pred = nn.Dense(4 * (num_classes + 1),
                                      prefix="bbox_pred_", flatten=False,
                                      weight_initializer=_init.Normal(0.001))

    def hybrid_forward(self, F, x, im_info, gt=None):
        feat = self.backbone(x)
        rpn_cls, rpn_reg = self.rpn(feat)
        rois = F.MultiProposal(
            rpn_cls, rpn_reg, im_info,
            rpn_pre_nms_top_n=self._pre, rpn_post_nms_top_n=self._post,
            rpn_min_size=self._min_size, scales=self._scales,
            ratios=self._ratios, feature_stride=self._stride)
        # proposals are constants for the head (the Proposal op has no
        # gradient): box gradients must not reach the RPN through them
        rois = F.BlockGrad(rois)
        B = x.shape[0]
        R = self._post
        if gt is not None:
            # training: the gt boxes join each image's rois, so the head
            # always sees positives; a padding gt row (class -1) becomes a
            # zero-area roi at the origin
            M = gt.shape[1]
            cls_col = F.slice_axis(gt, axis=2, begin=0, end=1)
            valid = F.broadcast_greater_equal(cls_col, F.zeros_like(cls_col))
            gt_boxes = F.slice_axis(gt, axis=2, begin=1, end=5) * valid
            rois = F.reshape(rois, (B, R, 5))
            batch_col = F.slice_axis(rois, axis=2, begin=0, end=1)
            gt_bidx = F.broadcast_axis(
                F.slice_axis(batch_col, axis=1, begin=0, end=1), axis=1,
                size=M)
            gt_rois = F.concat(gt_bidx, gt_boxes, dim=2)      # (B, M, 5)
            rois = F.reshape(F.concat(rois, gt_rois, dim=1),
                             (B * (R + M), 5))
            R = R + M
        pooled = F.ROIAlign(feat, rois, pooled_size=self._roi_size,
                            spatial_scale=1.0 / self._stride,
                            sample_ratio=2)                    # (B*R, C, 7, 7)
        h = self.head_dense(pooled.reshape((B * R, -1)))
        cls = F.softmax(self.cls_score(h), axis=-1).reshape(
            (B, R, self._num_classes + 1))
        box = self.bbox_pred(h).reshape((B, R, 4 * (self._num_classes + 1)))
        if self._output_rpn:
            return cls, box, rois, rpn_cls, rpn_reg
        return cls, box, rois

    def detect(self, x, im_info, threshold=0.05, nms_threshold=0.3,
               nms_topk=-1):
        """Forward, per-class decode of each roi and NMS -> (B, R*C, 6)
        ``[class_id, score, x1, y1, x2, y2]`` in pixels, -1 rows invalid
        (JAX counterpart: ``models/rcnn.py:168``). NDArrays in, an NDArray
        out; tensors in, a tensor out."""
        with autograd.predict_mode(), torch.no_grad():
            out = self(x, im_info)
        cls, box, rois = (o._data if isinstance(o, NDArray) else o
                          for o in out[:3])
        info = im_info._data if isinstance(im_info, NDArray) else im_info
        B, R, C = x.shape[0], self._post, self._num_classes
        with torch.no_grad():
            deltas = box.reshape(B, R, C + 1, 4)[:, :, 1:, :]
            roib = rois.reshape(B, R, 5)[..., 1:5]
            anchors = roib[:, :, None, :].expand(B, R, C, 4).reshape(-1, 4)
            boxes = _bbox_pred(anchors, deltas.reshape(-1, 4)).reshape(
                B, R, C, 4)
            boxes = _clip_boxes(boxes, info[:, None, None, 0],
                                info[:, None, None, 1])
            ids = torch.arange(C, dtype=boxes.dtype, device=boxes.device
                               )[None, None, :, None].expand(B, R, C, 1)
            rows = torch.cat([ids, cls[:, :, 1:, None], boxes],
                             -1).reshape(B, R * C, 6)
            dets = box_nms(rows, overlap_thresh=nms_threshold,
                           valid_thresh=threshold, topk=nms_topk,
                           coord_start=2, score_index=1, id_index=0,
                           force_suppress=False)
        return NDArray(dets) if isinstance(x, NDArray) else dets


class FasterRCNNTargetLoss(HybridBlock):
    """The four-way two-stage objective (JAX counterpart:
    ``models/rcnn.py:208``): RPN CE and smooth L1 over ``rpn_target``'s
    labels, head CE (fg and bg normalised apart) and smooth L1 over
    ``proposal_target``'s. ``forward(cls, box, rois, rpn_cls, rpn_reg, gt,
    im_info)`` on the net's ``output_rpn=True`` outputs; gt (B, M, 5) in
    pixels, -1 padded. Returns the scalar sum."""

    def __init__(self, num_classes: int, scales=(2, 4), ratios=(0.5, 1, 2),
                 feature_stride=8, rpn_fg_overlap=0.7, rpn_bg_overlap=0.3,
                 head_fg_overlap=0.5, **kw):
        super().__init__(**kw)
        self._num_classes = num_classes
        self._scales, self._ratios = tuple(scales), tuple(ratios)
        self._stride = feature_stride
        self._rpn_fg, self._rpn_bg = rpn_fg_overlap, rpn_bg_overlap
        self._head_fg = head_fg_overlap

    def hybrid_forward(self, F, cls, box, rois, rpn_cls, rpn_reg, gt,
                       im_info):
        eps = 1e-8
        B, A2 = rpn_cls.shape[0], rpn_cls.shape[1]
        A = A2 // 2
        # RPN stage (AnchorTarget)
        lbl, rpn_t, rpn_m = F.rpn_target(
            rpn_cls, gt, im_info, feature_stride=self._stride,
            scales=self._scales, ratios=self._ratios,
            fg_overlap=self._rpn_fg, bg_overlap=self._rpn_bg)
        # probabilities in MultiProposal's (h, w, a) flat order
        p_bg = F.reshape(F.transpose(
            F.slice_axis(rpn_cls, axis=1, begin=0, end=A),
            axes=(0, 2, 3, 1)), (B, -1))
        p_fg = F.reshape(F.transpose(
            F.slice_axis(rpn_cls, axis=1, begin=A, end=2 * A),
            axes=(0, 2, 3, 1)), (B, -1))
        is_fg = F.equal(lbl, F.ones_like(lbl))
        is_bg = F.equal(lbl, F.zeros_like(lbl))
        rpn_cls_loss = -(is_fg * F.log(p_fg + eps)
                         + is_bg * F.log(p_bg + eps))
        n_lbl = F.sum(is_fg) + F.sum(is_bg) + 1.0
        rpn_cls_loss = F.sum(rpn_cls_loss) / n_lbl
        # deltas in the same flat order (B, HWA, 4)
        d = F.transpose(F.reshape(rpn_reg, (B, A, 4, rpn_reg.shape[2],
                                            rpn_reg.shape[3])),
                        axes=(0, 3, 4, 1, 2))
        d = F.reshape(d, (B, -1, 4))
        n_fg = F.sum(is_fg) + 1.0
        rpn_box_loss = F.sum(F.smooth_l1((d - rpn_t) * rpn_m,
                                         scalar=3.0)) / n_fg
        # head stage (ProposalTarget)
        cls_t, box_t, box_m = F.proposal_target(
            rois, gt, num_classes=self._num_classes,
            fg_overlap=self._head_fg)
        head_ce = -F.log(F.pick(cls, cls_t, axis=-1) + eps)   # (B, R)
        # background rois outnumber the rest ~R:1, so the fg and bg terms
        # normalise apart
        head_is_fg = F.greater(cls_t, F.zeros_like(cls_t))
        head_is_bg = F.ones_like(head_is_fg) - head_is_fg
        n_head_fg = F.sum(head_is_fg) + 1.0
        n_head_bg = F.sum(head_is_bg) + 1.0
        head_cls_loss = F.sum(head_ce * head_is_fg) / n_head_fg \
            + F.sum(head_ce * head_is_bg) / n_head_bg
        head_box_loss = F.sum(F.smooth_l1((box - box_t) * box_m,
                                          scalar=1.0)) / n_head_fg
        return rpn_cls_loss + rpn_box_loss + head_cls_loss + head_box_loss


# ---------------------------------------------------------------------------
# the example loop (JAX counterpart: examples/train_frcnn.py)
# ---------------------------------------------------------------------------

#: the example's model and loss configuration (``train_frcnn.py:99-107``):
#: a stride-4 trunk puts anchors on a 4 px grid for the 16-24 px objects
FRCNN_EXAMPLE = dict(num_classes=3, scales=(4, 6, 8), ratios=(0.5, 1, 2),
                     feature_stride=4)


def make_dataset(rng, n: int, size: int):
    """``(images (n, 3, S, S), labels (n, 1, 5))`` in pixels: one coloured
    rectangle on a dim noisy background, class = the lit channel (a copy
    of ``examples/train_frcnn.py:28``)."""
    imgs = 0.1 * rng.rand(n, 3, size, size).astype("float32")
    labels = onp.zeros((n, 1, 5), "float32")
    for i in range(n):
        cls = rng.randint(0, 3)
        w = rng.randint(size // 3, size // 2 + 1)
        h = rng.randint(size // 3, size // 2 + 1)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - h)
        imgs[i, cls, y0:y0 + h, x0:x0 + w] = 1.0
        labels[i, 0] = [cls, x0, y0, x0 + w - 1, y0 + h - 1]
    return imgs, labels


def frcnn_example(steps: int = 300, batch_size: int = 8,
                  image_size: int = 48, train_size: int = 192,
                  val_size: int = 64, lr: float = 0.003,
                  momentum: float = 0.9, seed: Optional[int] = None,
                  ctx=None) -> dict:
    """The JAX package's ``examples/train_frcnn.py`` loop: ``FasterRCNN``
    (3 classes, scales (4, 6, 8), stride 4, pre/post 128/24, min size 2,
    backbone (24, 48), ``output_rpn``) seeded through ``mx.random.seed``
    (``seed``, else ``MXNET_TEST_SEED``, else 42) and ``Xavier``,
    ``hybridize()``, SGD with momentum through ``gluon.Trainer``,
    ``autograd.record()`` -> ``net(x, info, gt)`` ->
    ``FasterRCNNTargetLoss`` (rpn fg 0.5, head fg 0.4) -> ``backward`` ->
    ``trainer.step(1)``; then ``detect`` and the top-detection hit rate on
    the held-out images. Runs on ``ctx`` (default: the current context).
    Returns ``{"losses": [per step], "accuracy": hit rate}``."""
    from .. import initializer, random
    from ..context import current_context
    from ..gluon import Trainer
    from ..ndarray import array

    ctx = ctx or current_context()
    random.seed(seed if seed is not None
                else int(os.environ.get("MXNET_TEST_SEED", "42")))
    rng = onp.random.RandomState(0)
    tr_x, tr_y = make_dataset(rng, train_size, image_size)
    va_x, va_y = make_dataset(rng, val_size, image_size)
    net = FasterRCNN(rpn_pre_nms_top_n=128, rpn_post_nms_top_n=24,
                     rpn_min_size=2, backbone_filters=(24, 48),
                     output_rpn=True, **FRCNN_EXAMPLE)
    net.initialize(initializer.Xavier(), ctx=ctx)
    net.hybridize()
    loss_fn = FasterRCNNTargetLoss(rpn_fg_overlap=0.5, head_fg_overlap=0.4,
                                   **FRCNN_EXAMPLE)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": lr, "momentum": momentum})
    S = image_size
    info = array(onp.tile([S, S, 1.0], (batch_size, 1)).astype("float32"),
                 ctx=ctx)
    losses = []
    for _ in range(steps):
        idx = rng.randint(0, train_size, batch_size)
        x, y = array(tr_x[idx], ctx=ctx), array(tr_y[idx], ctx=ctx)
        with autograd.record():
            cls, box, rois, rpn_cls, rpn_reg = net(x, info, y)
            loss = loss_fn(cls, box, rois, rpn_cls, rpn_reg, y, info)
        loss.backward()
        trainer.step(1)
        losses.append(loss._data.detach())
    hits = total = 0
    for s in range(0, val_size, 16):
        x = array(va_x[s:s + 16], ctx=ctx)
        vinfo = array(onp.tile([S, S, 1.0], (x.shape[0], 1)).astype(
            "float32"), ctx=ctx)
        det = net.detect(x, vinfo, threshold=0.01)
        h, n = hit_rate(det.asnumpy(), va_y[s:s + 16])
        hits, total = hits + h, total + n
    return {"losses": [float(v) for v in losses],
            "accuracy": hits / max(total, 1)}
