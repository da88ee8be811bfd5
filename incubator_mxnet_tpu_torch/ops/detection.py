"""Detection ops: box IoU and NMS, bipartite matching, SSD's MultiBox ops,
ROIAlign/ROIPooling, the RPN's proposals and targets, deformable
convolution and PS-ROI pooling.

Counterpart: the JAX package's ``ops/detection.py`` (``:28-753``), which
computes all of it in XLA (no Pallas kernel), so the port computes it in
plain PyTorch. Every op keeps the reference's fixed shapes, and each gives
the reference's integer answers, ties included:

- ``jnp.argsort`` is stable, so the port sorts with ``stable=True``;
  ``lax.top_k`` puts the lower index first on ties, which
  :func:`.nn.top_k`'s stable descending sort does too (``torch.topk``
  promises no order on ties); ``argmax`` takes the first maximum in both
  libraries, on the card too.
- No op reads a value back to the host, and no output's shape depends on
  the data (no boolean-mask indexing, no ``nonzero``): each op can be
  captured in a CUDA graph. The ``.at[idx].max`` scatters with repeated
  indices are ``scatter_reduce(..., "amax")`` on integers.
- Constants built on the host (the anchors of ``multibox_prior``,
  ``multi_proposal`` and ``rpn_target``, ROIAlign's sampling grid) are
  made once per (shape, attributes, device, dtype) and kept on the device
  (:func:`_constant`), so a step's first, uncaptured run leaves them there
  for its capture: a host-to-device copy from pageable memory cannot be
  captured.
- A division by a Python number whose result is floored, ceiled or
  compared (ROI bins, sampling grids) divides by a device scalar
  (:func:`_div`): PyTorch's CUDA division by a host scalar multiplies by
  its reciprocal, which can land one ulp off an integer and move a bin.
- The sequential loops (greedy NMS, the RPN's NMS scan, bipartite
  matching) are fixed-length Python loops of tensor ops, batched over the
  leading dimensions, as ``lax.fori_loop``/``lax.scan`` are there.

Where the reference has no gradient, the port has none: hard-negative
mining orders anchors by a detached loss.
"""
from __future__ import annotations

import math
import threading
from typing import Dict

import numpy as onp
import torch

from ..base import MXNetError
from .nn import top_k

__all__ = ["box_iou", "box_nms", "bipartite_matching", "multibox_prior",
           "multibox_target", "multibox_detection", "roi_align",
           "roi_pooling", "multi_proposal", "proposal",
           "deformable_convolution", "psroi_pooling", "rpn_target",
           "proposal_target"]

_INF = math.inf
_lock = threading.Lock()
_constants: Dict[tuple, torch.Tensor] = {}


def _constant(key: tuple, build, device, dtype) -> torch.Tensor:
    """The numpy array ``build()`` as a tensor on ``device``, made once per
    ``key``, device and dtype. A first use inside a CUDA graph capture
    raises: the step's uncaptured first run must make it."""
    device = torch.device(device)
    full = key + (str(device), dtype)
    t = _constants.get(full)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                f"detection constant {key} first needed inside a CUDA graph "
                "capture: run the step once uncaptured first")
        t = torch.from_numpy(onp.ascontiguousarray(build())).to(
            device=device, dtype=dtype)
        with _lock:
            t = _constants.setdefault(full, t)
    return t


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` rounded as IEEE division on every device (module
    docstring)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# box helpers
# ---------------------------------------------------------------------------

def _corner_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between corner-format boxes a (..., N, 4) and b (..., M, 4):
    (..., N, M) (JAX counterpart: ``:28``, the same operations in the same
    order)."""
    ax1, ay1, ax2, ay2 = (v.unsqueeze(-1) for v in a.unbind(-1))
    bx1, by1, bx2, by2 = (v.unsqueeze(-2) for v in b.unbind(-1))
    ix1 = torch.maximum(ax1, bx1)
    iy1 = torch.maximum(ay1, by1)
    ix2 = torch.minimum(ax2, bx2)
    iy2 = torch.minimum(ay2, by2)
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def _center_to_corner(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)


def _corner_to_center(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i], ...]`` for x (B, N, ...) and idx (B, K)."""
    tail = x.shape[2:]
    index = idx.reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return torch.gather(x, 1, index)


def box_iou(lhs, rhs, format="corner", **_):
    """Pairwise IoU (JAX counterpart: ``:54``)."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _corner_iou(lhs, rhs)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner",
            **_):
    """Fixed-shape greedy NMS (JAX counterpart: ``:61``). data (..., N, K)
    with K >= coord_start + 4; the output has its shape, survivors sorted
    by score (a stable sort: ties keep their input order) and every other
    row -1.

    With ``topk > 0`` only the first ``min(topk, N)`` sorted rows enter the
    suppression loop and the IoU matrix: the reference marks each later row
    invalid before its loop, and an invalid row neither survives nor
    suppresses (its ``keep[i] & svalid[i]`` is false), so cutting them
    leaves the output exactly the reference's."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    shape = data.shape
    N, K = shape[-2], shape[-1]
    flat = data.reshape(-1, N, K)
    scores = flat[..., score_index]
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (flat[..., id_index] != background_id)
    order = torch.argsort(-torch.where(valid, scores, -_INF), dim=-1,
                          stable=True)
    n = N if topk <= 0 else min(int(topk), N)
    order = order[:, :n]
    s = _gather_rows(flat, order)                          # (B, n, K)
    with torch.no_grad():
        svalid = torch.gather(valid, 1, order)
        boxes = s[..., coord_start:coord_start + 4]
        if in_format == "center":
            boxes = _center_to_corner(boxes)
        iou = _corner_iou(boxes, boxes)                    # (B, n, n)
        if not force_suppress and id_index >= 0:
            ids = s[..., id_index]
            iou = torch.where(ids[:, :, None] == ids[:, None, :], iou, 0.0)
        # row i suppresses the later rows j > i it overlaps
        over = (iou > overlap_thresh) & torch.ones(
            n, n, dtype=torch.bool, device=data.device).triu(1)
        # keep starts as svalid: row i's verdict is final once the rows
        # before it have run, and then keep[i] == keep[i] & svalid[i]
        keep = svalid.clone()
        for i in range(n):
            keep &= ~(over[:, i] & keep[:, i:i + 1])
    if out_format != in_format:
        coords = s[..., coord_start:coord_start + 4]
        conv = (_center_to_corner(coords) if out_format == "corner"
                else _corner_to_center(coords))
        s = torch.cat([s[..., :coord_start], conv,
                       s[..., coord_start + 4:]], -1)
    out = torch.where(keep[..., None], s, -1.0)
    if n < N:
        out = torch.cat([out, out.new_full((out.shape[0], N - n, K), -1.0)],
                        1)
    out = out.reshape(shape)
    return out[0] if squeeze else out


def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1, **_):
    """Greedy bipartite matching over a (..., N, M) score matrix (JAX
    counterpart: ``:111``): ``(row_match, col_match)``, each the matched
    index or -1, in ``data``'s dtype."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    B, N, M = data.shape
    sign = 1.0 if is_ascend else -1.0
    dev = data.device
    k = N if topk <= 0 else min(int(topk), N)
    row_m = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    col_m = torch.full((B, M), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(N, device=dev)
    cols = torch.arange(M, device=dev)
    with torch.no_grad():
        for _ in range(k):
            free = (row_m[:, :, None] < 0) & (col_m[:, None, :] < 0)
            masked = torch.where(free, data, sign * _INF).reshape(B, -1)
            idx = torch.argmax(-sign * masked, 1)[:, None]   # (B, 1)
            r, c = idx // M, idx % M
            # threshold the masked value: once rows or columns run out the
            # argmax lands on an inf slot, which must never match
            val = torch.gather(masked, 1, idx)
            ok = (val > threshold) if not is_ascend else (val < threshold)
            row_m = torch.where(ok & (rows == r), c, row_m)
            col_m = torch.where(ok & (cols == c), r, col_m)
    row_m, col_m = row_m.to(data.dtype), col_m.to(data.dtype)
    if squeeze:
        return row_m[0], col_m[0]
    return row_m, col_m


# ---------------------------------------------------------------------------
# SSD: MultiBoxPrior / MultiBoxTarget / MultiBoxDetection
# ---------------------------------------------------------------------------

def _prior_boxes(H, W, sizes, ratios, clip, steps, offsets) -> onp.ndarray:
    """The anchors of :func:`multibox_prior` in float32 numpy, with the
    reference's float32 operations (``:154-178``)."""
    f32 = onp.float32
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (onp.arange(H, dtype=f32) + f32(offsets[0])) * f32(step_y)
    cx = (onp.arange(W, dtype=f32) + f32(offsets[1])) * f32(step_x)
    cy, cx = onp.meshgrid(cy, cx, indexing="ij")
    centers = onp.stack([cx.reshape(-1), cy.reshape(-1)], -1)  # (HW, 2)
    # widths carry the reference's in_h/in_w aspect correction, so anchors
    # stay square in image space on non-square feature maps
    ar = H / W
    whs = [(s * ar, s) for s in sizes]
    s0 = sizes[0]
    for r in ratios[1:]:
        rr = float(r) ** 0.5
        whs.append((s0 * rr * ar, s0 / rr))
    whs = onp.asarray(whs, f32)                                # (A, 2)
    A = whs.shape[0]
    c = onp.repeat(centers[:, None, :], A, axis=1)             # (HW, A, 2)
    wh = onp.broadcast_to(whs[None], (centers.shape[0], A, 2))
    half = wh / f32(2)
    boxes = onp.concatenate([c - half, c + half], -1).reshape(1, -1, 4)
    if clip:
        boxes = onp.clip(boxes, f32(0.0), f32(1.0))
    return boxes


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5), **_):
    """SSD anchors for the (B, C, H, W) feature map ``data``: (1,
    H*W*(S+R-1), 4) corners (JAX counterpart: ``:150``). A fresh copy of
    the cached constant."""
    H, W = int(data.shape[-2]), int(data.shape[-1])
    sizes, ratios = tuple(sizes), tuple(ratios)
    steps, offsets = tuple(steps), tuple(offsets)
    key = ("multibox_prior", H, W, sizes, ratios, bool(clip), steps, offsets)
    return _constant(key, lambda: _prior_boxes(H, W, sizes, ratios, clip,
                                               steps, offsets),
                     data.device, data.dtype).clone()


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2), **_):
    """SSD training targets (JAX counterpart: ``:183``). anchor (1, N, 4)
    corners; label (B, M, 5) ``[cls, x1, y1, x2, y2]``, -1 padded;
    cls_pred (B, num_cls+1, N). Returns ``(loc_target (B, N*4), loc_mask
    (B, N*4), cls_target (B, N))``."""
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B = label.shape[0]
    gt_valid = label[..., 0] >= 0                          # (B, M)
    gt_boxes = label[..., 1:5]                             # (B, M, 4)
    with torch.no_grad():
        iou = _corner_iou(anchors[None], gt_boxes)          # (B, N, M)
        iou = torch.where(gt_valid[:, None, :], iou, 0.0)
        best_iou, _ = iou.max(dim=2)
        best_gt = torch.argmax(iou, 2)                        # (B, N)
        # force-match: each valid gt's best anchor is positive; "amax" so
        # a padding gt (whose argmax is anchor 0) cannot undo a real match
        best_anchor = torch.argmax(iou, 1)                    # (B, M)
        forced = torch.zeros((B, N), dtype=torch.int32,
                             device=anchor.device).scatter_reduce(
            1, best_anchor, gt_valid.to(torch.int32), "amax") > 0
        pos = (best_iou >= overlap_threshold) | forced
    matched = _gather_rows(gt_boxes, best_gt)               # (B, N, 4)
    # encode the regression target (center offsets over variances)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gw = (matched[..., 2] - matched[..., 0]).clamp(min=1e-8)
    gh = (matched[..., 3] - matched[..., 1]).clamp(min=1e-8)
    gcx = (matched[..., 0] + matched[..., 2]) / 2
    gcy = (matched[..., 1] + matched[..., 3]) / 2
    aw_c, ah_c = aw.clamp(min=1e-8), ah.clamp(min=1e-8)
    tx = _div((gcx - acx) / aw_c, variances[0])
    ty = _div((gcy - acy) / ah_c, variances[1])
    tw = _div(torch.log(gw / aw_c), variances[2])
    th = _div(torch.log(gh / ah_c), variances[3])
    loc_t = torch.stack([tx, ty, tw, th], -1)               # (B, N, 4)
    loc_mask = pos[..., None].expand(B, N, 4).to(anchor.dtype)
    pos_cls = torch.gather(label[..., 0], 1, best_gt) + 1.0
    if negative_mining_ratio > 0:
        # hard negative mining: keep the ratio * num_pos hardest background
        # anchors (largest background CE under the detached predictions);
        # the rest take ignore_label
        with torch.no_grad():
            neg_loss = -torch.log_softmax(cls_pred.detach(), dim=1)[:, 0]
            num_pos = pos.sum(dim=1, keepdim=True)
            max_neg = torch.clamp(num_pos * negative_mining_ratio,
                                  min=float(minimum_negative_samples))
            cand = torch.where(pos, -_INF, neg_loss)
            order = torch.argsort(-cand, dim=1, stable=True)
            rank = torch.argsort(order, dim=1)     # the inverse permutation
            sel_neg = (~pos) & (rank < max_neg)
        cls_t = torch.where(pos, pos_cls,
                            torch.where(sel_neg, 0.0, float(ignore_label)))
    else:
        cls_t = torch.where(pos, pos_cls, 0.0)
    return ((loc_t * loc_mask).reshape(B, -1).to(anchor.dtype),
            loc_mask.reshape(B, -1), cls_t.to(anchor.dtype))


def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1, **_):
    """SSD decode + NMS (JAX counterpart: ``:248``). cls_prob (B,
    num_cls+1, N), loc_pred (B, N*4), anchor (1, N, 4). Returns (B, N, 6)
    ``[id, score, x1, y1, x2, y2]``, -1 rows invalid."""
    B, C = cls_prob.shape[0], cls_prob.shape[1]
    N = anchor.shape[1]
    anchors = anchor.reshape(N, 4)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    loc = loc_pred.reshape(B, N, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    # best non-background class per anchor; output ids are 0-based over the
    # non-background classes (reference convention)
    if 0 <= background_id < C:
        bg = torch.arange(C, device=cls_prob.device)[None, :, None] \
            == background_id
        masked = torch.where(bg, -_INF, cls_prob)
        raw = torch.argmax(masked, 1)
        cls = torch.where(raw > background_id, raw - 1, raw)
        score = masked.max(dim=1).values
    else:
        cls = torch.argmax(cls_prob, 1)
        score = cls_prob.max(dim=1).values
    det = torch.cat([cls[..., None].to(boxes.dtype), score[..., None],
                     boxes], -1)
    return box_nms(det, overlap_thresh=nms_threshold,
                   valid_thresh=threshold, topk=nms_topk,
                   force_suppress=force_suppress, coord_start=2,
                   score_index=1, id_index=0)


# ---------------------------------------------------------------------------
# ROIAlign / ROIPooling
# ---------------------------------------------------------------------------

def _sample_offsets(P: int, sr: int) -> onp.ndarray:
    """A ROI bin's sampling points in bin units, ``P * sr`` of them, in the
    reference's float32 operations (``:317-320``)."""
    f32 = onp.float32
    return (onp.repeat(onp.arange(P), sr).astype(f32)
            + (onp.tile(onp.arange(sr), P).astype(f32) + f32(0.5))
            / f32(sr))


def _interp_weights(pos: torch.Tensor, size: int, P: int,
                    sr: int) -> torch.Tensor:
    """Each ROI bin's bilinear weights along one axis: (R, P, size), the
    mean over the bin's ``sr`` sampling positions ``pos`` (R, P*sr) of the
    weights that the reference's bilinear sample puts on its two
    neighbouring pixels (``:323-336``: floor, clipped to the image, the
    fraction clipped to [0, 1])."""
    p0 = torch.floor(pos).clamp(0, size - 1)
    p1 = (p0 + 1).clamp(0, size - 1)
    frac = (pos - p0).clamp(0, 1)
    grid = torch.arange(size, device=pos.device, dtype=pos.dtype)
    w = ((grid == p0[..., None]).to(pos.dtype) * (1 - frac)[..., None]
         + (grid == p1[..., None]).to(pos.dtype) * frac[..., None])
    return w.reshape(pos.shape[0], P, sr, size).mean(dim=2)


def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False, **_):
    """ROIAlign with bilinear sampling (JAX counterpart: ``:294``). data (B,
    C, H, W); rois (R, 5) ``[batch_idx, x1, y1, x2, y2]`` in image
    coordinates. Returns (R, C, PH, PW), or (R, C / (PH*PW), PH, PW) with
    ``position_sensitive`` (bin (ph, pw) of output channel o reads input
    channel o*PH*PW + ph*PW + pw).

    A bilinear sample is a product of a row and a column weight, so a
    bin's mean over its ``sr x sr`` samples is ``Ay[ph] @ image @
    Ax[pw]^T`` (:func:`_interp_weights`): two matrix products, the first
    over every image's rows at once (each roi's weights are zero outside
    its own image), instead of four gathers per sample. The backward is
    the products' transposes: no scatter-add, deterministic on the card.
    (A non-finite pixel anywhere in the batch therefore reaches every
    roi, where the reference would read it only if sampled.)"""
    B, C, H, W = data.shape
    PH, PW = pooled_size
    if position_sensitive and C % (PH * PW):
        raise ValueError(f"PS-ROIAlign needs channels divisible by "
                         f"PH*PW={PH * PW}, got {C}")
    sr = max(1, int(sample_ratio))
    off = 0.5 if aligned else 0.0
    R = rois.shape[0]
    dev, dt = data.device, data.dtype
    ft = torch.promote_types(dt, rois.dtype)
    bidx = rois[:, 0].to(torch.int32)
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    floor_wh = 1.0 if not aligned else 1e-6
    rw = (x2 - x1).clamp(min=floor_wh)
    rh = (y2 - y1).clamp(min=floor_wh)
    bin_w, bin_h = _div(rw, PW), _div(rh, PH)
    oy = _constant(("roi_grid", PH, sr), lambda: _sample_offsets(PH, sr),
                   dev, rois.dtype)
    ox = _constant(("roi_grid", PW, sr), lambda: _sample_offsets(PW, sr),
                   dev, rois.dtype)
    ay = _interp_weights(y1[:, None] + oy[None, :] * bin_h[:, None], H, PH,
                         sr).to(ft)                        # (R, PH, H)
    ax = _interp_weights(x1[:, None] + ox[None, :] * bin_w[:, None], W, PW,
                         sr).to(ft)                        # (R, PW, W)
    own = (bidx[:, None] == torch.arange(B, device=dev, dtype=torch.int32)
           ).to(ft)                                        # (R, B)
    a = (ay[:, :, None, :] * own[:, None, :, None]).reshape(R * PH, B * H)
    rows = data.to(ft).permute(0, 2, 1, 3).reshape(B * H, C * W)
    t = (a @ rows).reshape(R, PH, C, W)
    pooled = (t @ ax.transpose(1, 2)[:, None]).permute(0, 2, 1, 3)
    if not position_sensitive:
        return pooled.to(dt)                               # (R, C, PH, PW)
    cout = C // (PH * PW)
    ps = pooled.reshape(R, cout, PH * PW, PH * PW)
    # bin k = ph*PW + pw reads channel group k of its own bin
    ps = torch.diagonal(ps, dim1=2, dim2=3)                # (R, cout, PH*PW)
    return ps.reshape(R, cout, PH, PW).to(dt)


def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0, **_):
    """Max-pool ROI (JAX counterpart: ``:359``): each bin the max of its
    pixels (0 for an empty bin), coordinates rounded half to even. The max
    runs over rows, then columns: the same values (a gradient at tied
    maxima splits per stage instead of over all ties)."""
    B, C, H, W = data.shape
    PH, PW = pooled_size
    dev = data.device
    bidx = rois[:, 0].to(torch.int32).to(torch.int64)
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    rw = (x2 - x1 + 1).clamp(min=1.0)
    rh = (y2 - y1 + 1).clamp(min=1.0)

    def edges(start, extent, P):
        p = torch.arange(P, device=dev, dtype=start.dtype)
        lo = start[:, None] + torch.floor(_div(p[None] * extent[:, None], P))
        hi = start[:, None] + torch.ceil(
            _div((p[None] + 1) * extent[:, None], P))
        return lo, hi                                      # (R, P)

    ylo, yhi = edges(y1, rh, PH)
    xlo, xhi = edges(x1, rw, PW)
    ys = torch.arange(H, device=dev, dtype=data.dtype)
    xs = torch.arange(W, device=dev, dtype=data.dtype)
    in_x = (xs >= xlo[..., None]) & (xs < xhi[..., None])  # (R, PW, W)
    in_y = (ys >= ylo[..., None]) & (ys < yhi[..., None])  # (R, PH, H)
    img = data[bidx]                                       # (R, C, H, W)
    colmax = torch.where(in_x[:, None, None], img[:, :, :, None, :],
                         -_INF).amax(dim=-1)               # (R, C, H, PW)
    m = torch.where(in_y[:, None, :, :, None], colmax[:, :, None],
                    -_INF).amax(dim=3)                     # (R, C, PH, PW)
    return torch.where(torch.isfinite(m), m, 0.0).to(data.dtype)


# ---------------------------------------------------------------------------
# Faster-RCNN: Proposal / MultiProposal, DeformableConvolution, PSROIPooling
# ---------------------------------------------------------------------------

def _base_anchors(base_size, scales, ratios) -> onp.ndarray:
    """The reference's generate_anchors (rounded width/height enumeration):
    one (A, 4) corner anchor set centred on a base_size cell (a copy of the
    JAX package's numpy, ``:401``)."""
    base = onp.array([0, 0, base_size - 1, base_size - 1], onp.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    xc, yc = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    out = []
    for r in ratios:
        size_r = (w * h) / r
        ws = onp.round(onp.sqrt(size_r))
        hs = onp.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            out.append([xc - 0.5 * (wss - 1), yc - 0.5 * (hss - 1),
                        xc + 0.5 * (wss - 1), yc + 0.5 * (hss - 1)])
    return onp.array(out, onp.float32)


def _shifted_anchors(H, W, stride, base) -> onp.ndarray:
    """All anchors over an (H, W) feature map: (H*W*A, 4), row-major over
    (h, w, a), the reference's enumeration order (``:421``)."""
    sx = onp.arange(W, dtype=onp.float32) * stride
    sy = onp.arange(H, dtype=onp.float32) * stride
    shifts = onp.stack([onp.tile(sx, H), onp.repeat(sy, W),
                        onp.tile(sx, H), onp.repeat(sy, W)], axis=1)
    return (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)


def _rpn_anchors(H, W, stride, scales, ratios, device, dtype):
    key = ("rpn_anchors", H, W, stride, tuple(scales), tuple(ratios))
    return _constant(key, lambda: _shifted_anchors(
        H, W, stride, _base_anchors(stride, scales, ratios)), device, dtype)


def _bbox_pred(anchors, deltas, iou_loss=False):
    """Apply RPN regression deltas (reference: BBoxTransformInv; JAX
    counterpart: ``:438``); anchors (..., 4) broadcast against deltas."""
    ws = anchors[..., 2] - anchors[..., 0] + 1.0
    hs = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * (ws - 1.0)
    cy = anchors[..., 1] + 0.5 * (hs - 1.0)
    if iou_loss:
        return torch.stack([anchors[..., i] + deltas[..., i]
                            for i in range(4)], -1)
    pcx = deltas[..., 0] * ws + cx
    pcy = deltas[..., 1] * hs + cy
    pw = torch.exp(deltas[..., 2]) * ws
    ph = torch.exp(deltas[..., 3]) * hs
    return torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                        pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)], -1)


def _clip_boxes(boxes, imh, imw):
    """Clamp corner boxes (..., 4) to the image extent; ``imh``/``imw``
    broadcast against ``boxes[..., 0]`` (JAX counterpart: ``:457``)."""
    def clip(v, hi):
        return v.clamp(min=0.0).clamp(max=hi - 1.0)
    return torch.stack([clip(boxes[..., 0], imw), clip(boxes[..., 1], imh),
                        clip(boxes[..., 2], imw), clip(boxes[..., 3], imh)],
                       -1)


def _proposals(fg, deltas, im_info, anchors, pre, post, thresh, min_size,
               iou_loss):
    """The RPN's rois for a batch (JAX counterpart: ``_proposal_one``
    ``:467``, vmapped): top-k to ``pre`` (ties to the lower index), then
    ``post`` steps of greedy NMS, each emitting the best live box or, once
    none is left, zeros. Returns (B, post, 4) boxes and (B, post) scores.

    Each step is a handful of small kernels: the live scores (``-inf``
    once dead) are kept instead of an ``alive`` mask, so a step's box is
    live with a finite score iff its live score is finite; which boxes a
    pick kills (IoU above the threshold, or itself) is one precomputed
    (k, k) matrix whose row the step reads; score and box are gathered
    together."""
    B, N = fg.shape
    imh, imw, imscale = im_info[:, 0:1], im_info[:, 1:2], im_info[:, 2:3]
    boxes = _clip_boxes(_bbox_pred(anchors, deltas, iou_loss), imh, imw)
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    ms = min_size * imscale
    scores = torch.where((ws >= ms) & (hs >= ms), fg, -_INF)
    k = min(pre, N)
    top_scores, idx = top_k(scores, k)
    top_boxes = _gather_rows(boxes, idx)                   # (B, k, 4)
    cand = torch.cat([top_scores[..., None], top_boxes], -1)   # (B, k, 5)
    with torch.no_grad():
        kill = (_corner_iou(top_boxes, top_boxes) > thresh) | torch.eye(
            k, dtype=torch.bool, device=fg.device)         # (B, k, k)
        live = top_scores.detach().clone()
    picked = []
    for _ in range(post):
        with torch.no_grad():
            j = torch.argmax(live, 1)[:, None]             # (B, 1)
            ok = torch.isfinite(torch.gather(live, 1, j))
        picked.append(torch.where(ok, _gather_rows(cand, j)[:, 0], 0.0))
        # a step that emits nothing leaves nothing live with a finite
        # score, so its kills cannot change a later output
        with torch.no_grad():
            live.masked_fill_(_gather_rows(kill, j)[:, 0], -_INF)
    picked = torch.stack(picked, 1)                        # (B, post, 5)
    return picked[..., 1:], picked[..., 0]


def multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                   feature_stride=16, output_score=False, iou_loss=False,
                   **_):
    """Batched RPN proposals (JAX counterpart: ``:499``). cls_prob (B, 2A,
    H, W) [background scores, then foreground], bbox_pred (B, 4A, H, W),
    im_info (B, 3) [h, w, scale]. Returns rois (B*post, 5) ``[batch_idx,
    x1, y1, x2, y2]``, and scores (B*post, 1) with ``output_score``."""
    B, A2, H, W = cls_prob.shape
    A = A2 // 2
    anchors = _rpn_anchors(H, W, feature_stride, scales, ratios,
                           cls_prob.device, cls_prob.dtype)
    # fg scores: channels A..2A, (A, H, W) -> (H, W, A) -> flat (HWA,)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    # deltas: (4A, H, W) = A boxes x 4 coordinates -> (HWA, 4)
    dl = bbox_pred.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(
        B, -1, 4)
    post = int(rpn_post_nms_top_n)
    boxes, scores = _proposals(fg, dl, im_info, anchors,
                               int(rpn_pre_nms_top_n), post,
                               float(threshold), float(rpn_min_size),
                               iou_loss)
    # expand, not repeat_interleave: no index tensor to copy to the card
    bidx = torch.arange(B, device=boxes.device, dtype=boxes.dtype
                        )[:, None].expand(B, post).reshape(B * post, 1)
    rois = torch.cat([bidx, boxes.reshape(B * post, 4)], 1)
    if output_score:
        return rois, scores.reshape(B * post, 1)
    return rois


def proposal(cls_prob, bbox_pred, im_info, **kwargs):
    """Single-image RPN proposals: :func:`multi_proposal` (JAX counterpart:
    ``:536``)."""
    return multi_proposal(cls_prob, bbox_pred, im_info, **kwargs)


def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                           num_filter=0, num_group=1, num_deformable_group=1,
                           no_bias=False, **_):
    """Deformable convolution v1 (JAX counterpart: ``:544``): each tap
    samples the input at a learned fractional offset (bilinear, zero
    outside), then one contraction with the weight. data (B, C, H, W);
    offset (B, 2*ndg*Kh*Kw, Ho, Wo) ordered (group, tap, [y, x]); weight
    (O, C/num_group, Kh, Kw). Returns (B, O, Ho, Wo)."""
    B, C, H, W = data.shape
    Kh, Kw = kernel
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    Ho = (H + 2 * ph - dh * (Kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (Kw - 1) - 1) // sw + 1
    KK = Kh * Kw
    ndg = num_deformable_group
    cpg = C // ndg
    dev = data.device
    off = offset.float().reshape(B, ndg, KK, 2, Ho, Wo)
    oy = torch.arange(Ho, device=dev) * sh - ph
    ox = torch.arange(Wo, device=dev) * sw - pw
    ky = (torch.arange(Kh, device=dev) * dh)[:, None].expand(Kh, Kw
                                                             ).reshape(-1)
    kx = (torch.arange(Kw, device=dev) * dw).repeat(Kh)
    base_y = oy[None, :, None] + ky[:, None, None]         # (KK, Ho, 1)
    base_x = ox[None, None, :] + kx[:, None, None]         # (KK, 1, Wo)
    sy = base_y + off[:, :, :, 0]                # (B, ndg, KK, Ho, Wo)
    sx = base_x + off[:, :, :, 1]
    img = data.float().reshape(B, ndg, cpg, H * W)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy = (sy - y0).reshape(B, ndg, 1, -1)
    wx = (sx - x0).reshape(B, ndg, 1, -1)
    L = KK * Ho * Wo

    def at(yy, xx):
        inside = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        yi = yy.clamp(0, H - 1).to(torch.int64)
        xi = xx.clamp(0, W - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(B, ndg, 1, L).expand(B, ndg, cpg, L)
        v = torch.gather(img, 3, idx)
        return torch.where(inside.reshape(B, ndg, 1, L), v, 0.0)

    patches = (at(y0, x0) * (1 - wy) * (1 - wx)
               + at(y0, x0 + 1) * (1 - wy) * wx
               + at(y0 + 1, x0) * wy * (1 - wx)
               + at(y0 + 1, x0 + 1) * wy * wx)             # (B, ndg, cpg, L)
    O = weight.shape[0]
    cg = C // num_group
    og = O // num_group
    w = weight.float().reshape(num_group, og, cg, KK)
    p = patches.reshape(B, num_group, cg, KK, Ho, Wo)
    out = torch.einsum("gock,bgckhw->bgohw", w, p).reshape(B, O, Ho, Wo)
    if not no_bias and bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    return out.to(data.dtype)


def psroi_pooling(data, rois, output_dim, pooled_size, spatial_scale=1.0,
                  group_size=None, **_):
    """Position-sensitive ROI pooling (reference: R-FCN; JAX counterpart:
    ``:627``): ROIAlign's sampling with ``position_sensitive=True``."""
    ps = (pooled_size, pooled_size) if isinstance(pooled_size, int) \
        else tuple(pooled_size)
    if group_size is not None and tuple(
            (group_size, group_size) if isinstance(group_size, int)
            else group_size) != ps:
        raise NotImplementedError(
            "psroi_pooling: group_size != pooled_size is unsupported "
            "(the score-map grid here is the pooled grid)")
    C = data.shape[1]
    if C != output_dim * ps[0] * ps[1]:
        raise ValueError(
            f"psroi_pooling: data needs output_dim*PH*PW = "
            f"{output_dim * ps[0] * ps[1]} channels, got {C}")
    return roi_align(data, rois, pooled_size=ps, spatial_scale=spatial_scale,
                     sample_ratio=2, position_sensitive=True)


# ---------------------------------------------------------------------------
# AnchorTarget / ProposalTarget
# ---------------------------------------------------------------------------

def _encode_boxes(ref_boxes, gt):
    """Regression targets that :func:`_bbox_pred` inverts exactly (the +1
    pixel convention) (JAX counterpart: ``:649``)."""
    ws = ref_boxes[..., 2] - ref_boxes[..., 0] + 1.0
    hs = ref_boxes[..., 3] - ref_boxes[..., 1] + 1.0
    cx = ref_boxes[..., 0] + 0.5 * (ws - 1.0)
    cy = ref_boxes[..., 1] + 0.5 * (hs - 1.0)
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + 0.5 * (gw - 1.0)
    gcy = gt[..., 1] + 0.5 * (gh - 1.0)
    ws = ws.clamp(min=1.0)
    hs = hs.clamp(min=1.0)
    return torch.stack([(gcx - cx) / ws, (gcy - cy) / hs,
                        torch.log(gw.clamp(min=1.0) / ws),
                        torch.log(gh.clamp(min=1.0) / hs)], -1)


def rpn_target(cls_prob, gt_boxes, im_info, feature_stride=16,
               scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), fg_overlap=0.7,
               bg_overlap=0.3, **_):
    """RPN anchor targets (JAX counterpart: ``:668``). cls_prob (B, 2A, H,
    W) gives the feature shape; gt_boxes (B, M, 5) ``[cls, x1, y1, x2,
    y2]`` in pixels, -1 padded; im_info (B, 3). Returns ``(labels (B, HWA)
    in {1 fg, 0 bg, -1 ignore}, bbox_targets (B, HWA, 4), bbox_mask (B,
    HWA, 4))`` in MultiProposal's (h, w, a) order; no fg/bg subsampling."""
    B, A2, H, W = cls_prob.shape
    dt = cls_prob.dtype
    anchors = _rpn_anchors(H, W, feature_stride, scales, ratios,
                           cls_prob.device, gt_boxes.dtype)
    N = anchors.shape[0]
    valid = gt_boxes[..., 0] >= 0                          # (B, M)
    boxes = gt_boxes[..., 1:5]
    with torch.no_grad():
        iou = _corner_iou(anchors[None], boxes)            # (B, N, M)
        iou = torch.where(valid[:, None, :], iou, 0.0)
        best_gt = torch.argmax(iou, 2)
        best_iou = iou.max(dim=2).values
        inside = ((anchors[:, 0] >= 0.0) & (anchors[:, 1] >= 0.0)
                  & (anchors[None, :, 2] <= im_info[:, 1:2] - 1.0)
                  & (anchors[None, :, 3] <= im_info[:, 0:1] - 1.0))
        # forced per-gt best anchor over inside anchors only: a border gt
        # whose best anchor straddles the image still matches its best
        # inside anchor
        iou_in = torch.where(inside[:, :, None], iou, -1.0)
        best_anchor = torch.argmax(iou_in, 1)                # (B, M)
        has_inside = iou_in.max(dim=1).values > 0.0
        forced = torch.zeros((B, N), dtype=torch.int32,
                             device=anchors.device).scatter_reduce(
            1, best_anchor, (valid & has_inside).to(torch.int32),
            "amax") > 0
        fg = (forced | (best_iou >= fg_overlap)) & inside
        bg = (best_iou < bg_overlap) & inside & ~fg
        labels = torch.where(fg, 1.0, torch.where(bg, 0.0, -1.0))
    t = _encode_boxes(anchors, _gather_rows(boxes, best_gt))
    mask = fg[..., None].expand(B, N, 4).to(dt)
    return labels.to(dt), (t * mask).to(dt), mask


def proposal_target(rois, gt_boxes, num_classes=None, fg_overlap=0.5, **_):
    """ROI head targets (JAX counterpart: ``:720``); every roi gets one, no
    subsampling. rois (B*R, 5) in pixels; gt_boxes (B, M, 5), -1 padded.
    Returns ``(cls_target (B, R) in {0..num_classes}, box_target (B, R,
    4*(C+1)), box_mask (B, R, 4*(C+1)))``, only the matched class's four
    slots live."""
    B = gt_boxes.shape[0]
    R = rois.shape[0] // B
    C1 = int(num_classes) + 1
    rb = rois.reshape(B, R, 5)[..., 1:5]
    valid = gt_boxes[..., 0] >= 0
    boxes = gt_boxes[..., 1:5]
    with torch.no_grad():
        iou = _corner_iou(rb, boxes)                       # (B, R, M)
        iou = torch.where(valid[:, None, :], iou, 0.0)
        best = torch.argmax(iou, 2)
        fg = iou.max(dim=2).values >= fg_overlap
    cls = torch.where(fg, torch.gather(gt_boxes[..., 0], 1, best) + 1.0, 0.0)
    t4 = _encode_boxes(rb, _gather_rows(boxes, best))      # (B, R, 4)
    # one_hot as jax.nn.one_hot: an out-of-range class is all zeros
    onehot = (cls.to(torch.int32)[..., None] == torch.arange(
        C1, device=rois.device, dtype=torch.int32)).to(rois.dtype)
    mask = onehot * fg[..., None].to(rois.dtype)            # (B, R, C1)
    t = (onehot[..., None] * t4[..., None, :]).reshape(B, R, 4 * C1)
    mask4 = mask[..., None].expand(B, R, C1, 4).reshape(B, R, 4 * C1)
    return cls.to(rois.dtype), (t * mask4).to(rois.dtype), mask4
