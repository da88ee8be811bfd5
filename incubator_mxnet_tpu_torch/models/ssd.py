"""SSD: single-shot detection, and the JAX package's SSD example loop.

Counterpart: the JAX package's ``models/ssd.py`` (``:19-131``) and
``examples/train_ssd.py`` (:func:`ssd_example`). Anchors, targets and
decoding go through the fixed-shape ``multibox_*`` ops of
:mod:`..ops.detection`, so a hybridized SSD and the fused training step
capture them.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as onp
import torch

from .. import autograd
from ..gluon.block import HybridBlock
from .. import nn

__all__ = ["SSD", "ssd_300", "SSDTargetLoss", "ssd_example"]


class _FeatureExtractor(HybridBlock):
    """Small VGG-style trunk emitting multi-scale maps (JAX counterpart:
    ``models/ssd.py:19``): per scale two 3x3 convolutions with ReLU and a
    2x2 max pool; every scale but the stem feeds a head."""

    def __init__(self, filters: Sequence[int] = (32, 64, 128, 128, 128),
                 **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.blocks = []
            for i, f in enumerate(filters):
                blk = nn.HybridSequential(prefix=f"scale{i}_")
                with blk.name_scope():
                    blk.add(nn.Conv2D(f, 3, padding=1, activation="relu"))
                    blk.add(nn.Conv2D(f, 3, padding=1, activation="relu"))
                    blk.add(nn.MaxPool2D(2, 2))
                self.register_child(blk, f"scale{i}")
                self.blocks.append(blk)

    def hybrid_forward(self, F, x):
        feats = []
        for blk in self.blocks:
            x = blk(x)
            feats.append(x)
        return tuple(feats[1:])


class SSD(HybridBlock):
    """``forward(x)`` -> ``(cls_preds (B, N, num_cls+1), box_preds (B,
    N*4), anchors (1, N, 4))`` (JAX counterpart: ``models/ssd.py:45``).
    Train with :class:`SSDTargetLoss`; :meth:`detect` decodes."""

    def __init__(self, num_classes: int,
                 sizes: Sequence[Sequence[float]] = ((0.2, 0.27),
                                                     (0.37, 0.44),
                                                     (0.54, 0.62),
                                                     (0.71, 0.79)),
                 ratios: Sequence[Sequence[float]] = ((1, 2, 0.5),) * 4,
                 filters: Sequence[int] = (32, 64, 128, 128, 128), **kw):
        super().__init__(**kw)
        self._num_classes = num_classes
        self._sizes = sizes
        self._ratios = ratios
        with self.name_scope():
            self.features = _FeatureExtractor(filters, prefix="features_")
            self.cls_preds = []
            self.box_preds = []
            for i, (s, r) in enumerate(zip(sizes, ratios)):
                a = len(s) + len(r) - 1
                cp = nn.Conv2D(a * (num_classes + 1), 3, padding=1,
                               prefix=f"cls{i}_")
                bp = nn.Conv2D(a * 4, 3, padding=1, prefix=f"box{i}_")
                self.register_child(cp, f"cls{i}")
                self.register_child(bp, f"box{i}")
                self.cls_preds.append(cp)
                self.box_preds.append(bp)

    def hybrid_forward(self, F, x):
        feats = self.features(x)
        B = x.shape[0]
        cls_out, box_out, anchors = [], [], []
        for feat, cp, bp, s, r in zip(feats, self.cls_preds, self.box_preds,
                                      self._sizes, self._ratios):
            c = cp(feat)   # (B, A*(C+1), H, W)
            b = bp(feat)   # (B, A*4, H, W)
            cls_out.append(F.reshape(F.transpose(c, axes=(0, 2, 3, 1)),
                                     (B, -1, self._num_classes + 1)))
            box_out.append(F.reshape(F.transpose(b, axes=(0, 2, 3, 1)),
                                     (B, -1)))
            anchors.append(F.multibox_prior(feat, sizes=tuple(s),
                                            ratios=tuple(r)))
        return (F.concat(*cls_out, dim=1), F.concat(*box_out, dim=1),
                F.concat(*anchors, dim=1))

    def detect(self, x, threshold=0.01, nms_threshold=0.45, nms_topk=400):
        """Forward, softmax, decode and NMS -> (B, N, 6) ``[id, score, x1,
        y1, x2, y2]``, -1 rows invalid (JAX counterpart:
        ``models/ssd.py:93``); NDArrays in, an NDArray out."""
        from .. import ndarray as F
        with autograd.predict_mode(), torch.no_grad():
            cls_preds, box_preds, anchor = self(x)
            cls_prob = F.transpose(F.softmax(cls_preds, axis=-1),
                                   axes=(0, 2, 1))
            return F.multibox_detection(
                cls_prob, box_preds, anchor, threshold=threshold,
                nms_threshold=nms_threshold, nms_topk=nms_topk)


class SSDTargetLoss(HybridBlock):
    """MultiBoxTarget, then softmax CE over the kept anchors and smooth L1
    over the positives, over the number of positives plus one (JAX
    counterpart: ``models/ssd.py:106``)."""

    def __init__(self, negative_mining_ratio: float = 3.0, **kw):
        super().__init__(**kw)
        self._ratio = negative_mining_ratio

    def hybrid_forward(self, F, cls_preds, box_preds, anchor, label):
        cls_pred_t = F.transpose(cls_preds, axes=(0, 2, 1))
        loc_t, loc_mask, cls_t = F.multibox_target(
            anchor, label, cls_pred_t, negative_mining_ratio=self._ratio,
            ignore_label=-1.0)
        # anchors that hard negative mining marks ignore (-1) drop out
        keep = F.greater_equal(cls_t, cls_t * 0.0)
        ce = -F.pick(F.log_softmax(cls_preds, axis=-1),
                     F.clip(cls_t, a_min=0.0), axis=-1)
        cls_loss = ce * keep
        num_pos = F.sum(F.greater(cls_t, cls_t * 0.0)) + 1.0
        box_loss = F.smooth_l1((box_preds - loc_t) * loc_mask, scalar=1.0)
        return (F.sum(cls_loss) + F.sum(box_loss)) / num_pos


def ssd_300(num_classes: int = 20, **kw) -> SSD:
    return SSD(num_classes, **kw)


# ---------------------------------------------------------------------------
# the example loop (JAX counterpart: examples/train_ssd.py)
# ---------------------------------------------------------------------------

def make_dataset(rng, n: int, size: int):
    """``(images (n, 3, S, S), labels (n, 1, 5))``: one coloured rectangle
    on a dim noisy background, class = the lit channel, box in [0, 1]
    (a copy of ``examples/train_ssd.py:27``)."""
    imgs = 0.1 * rng.rand(n, 3, size, size).astype("float32")
    labels = onp.zeros((n, 1, 5), "float32")
    for i in range(n):
        cls = rng.randint(0, 3)
        w = rng.randint(size // 4, size // 2 + 1)
        h = rng.randint(size // 4, size // 2 + 1)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - h)
        imgs[i, cls, y0:y0 + h, x0:x0 + w] = 1.0
        labels[i, 0] = [cls, x0 / size, y0 / size,
                        (x0 + w) / size, (y0 + h) / size]
    return imgs, labels


def _iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def hit_rate(dets: onp.ndarray, truth: onp.ndarray) -> tuple:
    """``(hits, images)``: images whose top detection (``dets`` (B, N, 6),
    -1 rows invalid) has the true class (``truth`` (B, 1, 5)) and IoU >
    0.5 with its box (the examples' mAP proxy)."""
    hits = 0
    for b in range(dets.shape[0]):
        rows = dets[b]
        rows = rows[rows[:, 0] >= 0]
        if rows.size == 0:
            continue
        best = rows[rows[:, 1].argmax()]
        t = truth[b, 0]
        if int(best[0]) == int(t[0]) and _iou(best[2:6], t[1:5]) > 0.5:
            hits += 1
    return hits, dets.shape[0]


def ssd_example(steps: int = 300, batch_size: int = 16, image_size: int = 48,
                train_size: int = 256, val_size: int = 64,
                lr: float = 0.005, momentum: float = 0.9,
                seed: Optional[int] = None, ctx=None) -> dict:
    """The JAX package's ``examples/train_ssd.py`` loop: ``SSD(3)`` seeded
    through ``mx.random.seed`` (``seed``, else ``MXNET_TEST_SEED``, else
    42) and ``Xavier``, ``hybridize()``, SGD with momentum through
    ``gluon.Trainer``, ``autograd.record()`` -> ``SSDTargetLoss`` ->
    ``backward`` -> ``trainer.step(1)`` on batches drawn from the fixed
    synthetic set (``RandomState(0)``); then the top-detection hit rate
    on the held-out images. Runs on ``ctx`` (default: the current
    context). Returns ``{"losses": [per step], "accuracy": hit rate}``.
    (``--ckpt-dir`` waits for ``fault/``.)"""
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
    net = SSD(num_classes=3)
    net.initialize(initializer.Xavier(), ctx=ctx)
    net.hybridize()
    loss_fn = SSDTargetLoss()
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": lr, "momentum": momentum})
    losses = []
    for _ in range(steps):
        idx = rng.randint(0, train_size, batch_size)
        x, y = array(tr_x[idx], ctx=ctx), array(tr_y[idx], ctx=ctx)
        with autograd.record():
            cp, bp, an = net(x)
            loss = loss_fn(cp, bp, an, y)
        loss.backward()
        trainer.step(1)
        losses.append(loss._data.detach())
    hits = total = 0
    for s in range(0, val_size, 16):
        det = net.detect(array(va_x[s:s + 16], ctx=ctx), threshold=0.01)
        h, n = hit_rate(det.asnumpy(), va_y[s:s + 16])
        hits, total = hits + h, total + n
    return {"losses": [float(v) for v in losses],
            "accuracy": hits / max(total, 1)}
