"""``mx.image`` detection augmenters and ``ImageDetIter``.

Counterpart: the JAX package's ``image/detection.py`` (reference:
``python/mxnet/image/detection.py``: the ``DetAugmenter`` zoo,
``CreateDetAugmenter``, ``ImageDetIter``). Labels ride
with the images: every augmenter maps ``(src, label) -> (src, label)``
where ``label`` is an ``(M, 5)`` float array of
``[class, xmin, ymin, xmax, ymax]`` rows with coordinates normalized to
[0, 1] (the reference's object format after header stripping).

All augmentation is host-side numpy feeding device batches, as in
``image/__init__.py``; ``ImageDetIter`` reads an ``imglist`` or a
``.rec`` file (``path_imgrec``).
"""
from __future__ import annotations

import json
import os
import random as pyrandom
from typing import List, Optional, Sequence, Tuple

import numpy as onp

from .. import recordio
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import array as _array
from . import (Augmenter, CastAug, ColorNormalizeAug, ForceResizeAug,
               ResizeAug, _cv2, array, imread)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Detection augmenter base (reference: detection.py DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src: NDArray, label: onp.ndarray):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline — the
    label passes through untouched (reference: DetBorrowAug)."""

    def __init__(self, augmenter: Augmenter):
        super().__init__(augmenter=type(augmenter).__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick ONE augmenter from ``aug_list`` (or skip entirely
    with ``skip_prob``) per sample (reference: DetRandomSelectAug)."""

    def __init__(self, aug_list: Sequence[DetAugmenter], skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or pyrandom.random() < self.skip_prob:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and boxes with probability p (reference:
    DetHorizontalFlipAug): x -> 1 - x, swapping xmin/xmax."""

    def __init__(self, p: float = 0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = array(onp.ascontiguousarray(src.asnumpy()[:, ::-1, :]))
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


def _box_coverage(label: onp.ndarray, crop: Tuple[float, float, float, float]):
    """Fraction of each object's area inside ``crop`` (normalized xywh)."""
    cx1, cy1, cw, ch = crop
    cx2, cy2 = cx1 + cw, cy1 + ch
    ix1 = onp.maximum(label[:, 1], cx1)
    iy1 = onp.maximum(label[:, 2], cy1)
    ix2 = onp.minimum(label[:, 3], cx2)
    iy2 = onp.minimum(label[:, 4], cy2)
    inter = onp.clip(ix2 - ix1, 0, None) * onp.clip(iy2 - iy1, 0, None)
    area = onp.clip(label[:, 3] - label[:, 1], 1e-12, None) * \
        onp.clip(label[:, 4] - label[:, 2], 1e-12, None)
    return inter / area


def _update_labels_crop(label, crop, min_eject_coverage):
    """Clip boxes to the crop, renormalize, eject low-coverage objects
    (reference: detection.py _update_labels)."""
    cx1, cy1, cw, ch = crop
    cov = _box_coverage(label, crop)
    keep = cov >= min_eject_coverage
    if not keep.any():
        return None
    out = label[keep].copy()
    out[:, 1] = onp.clip((out[:, 1] - cx1) / cw, 0, 1)
    out[:, 2] = onp.clip((out[:, 2] - cy1) / ch, 0, 1)
    out[:, 3] = onp.clip((out[:, 3] - cx1) / cw, 0, 1)
    out[:, 4] = onp.clip((out[:, 4] - cy1) / ch, 0, 1)
    return out


class DetRandomCropAug(DetAugmenter):
    """Constrained random crop (reference: DetRandomCropAug): sample a
    normalized crop from ``area_range``/``aspect_ratio_range`` until some
    object keeps >= ``min_object_covered`` of its area; objects below
    ``min_eject_coverage`` are dropped, the rest clipped+renormalized.
    Falls through unchanged after ``max_attempts`` failures."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample_crop(self, label):
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            w = min(1.0, (area * ratio) ** 0.5)
            h = min(1.0, (area / ratio) ** 0.5)
            x = pyrandom.uniform(0, 1 - w)
            y = pyrandom.uniform(0, 1 - h)
            crop = (x, y, w, h)
            if label.size == 0:
                return crop, label
            if _box_coverage(label, crop).max() >= self.min_object_covered:
                new_label = _update_labels_crop(label, crop,
                                                self.min_eject_coverage)
                if new_label is not None:
                    return crop, new_label
        return None

    def __call__(self, src, label):
        sampled = self._sample_crop(label)
        if sampled is None:
            return src, label
        crop, new_label = sampled
        img = src.asnumpy()
        H, W = img.shape[:2]
        x, y, w, h = crop
        x0, y0 = int(round(x * W)), int(round(y * H))
        x1 = min(W, x0 + max(1, int(round(w * W))))
        y1 = min(H, y0 + max(1, int(round(h * H))))
        return array(onp.ascontiguousarray(img[y0:y1, x0:x1, :])), new_label


class DetRandomPadAug(DetAugmenter):
    """Random expansion/pad (reference: DetRandomPadAug): place the image
    on a larger ``pad_val``-filled canvas sampled from ``area_range``
    (expansion factor) and ``aspect_ratio_range``, renormalizing boxes."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        img = src.asnumpy()
        H, W = img.shape[:2]
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            nw = (area * ratio) ** 0.5
            nh = (area / ratio) ** 0.5
            if nw < 1.0 or nh < 1.0:
                continue
            newW, newH = int(round(nw * W)), int(round(nh * H))
            x0 = pyrandom.randint(0, newW - W)
            y0 = pyrandom.randint(0, newH - H)
            canvas = onp.empty((newH, newW, img.shape[2]), img.dtype)
            canvas[:] = onp.asarray(self.pad_val, img.dtype)
            canvas[y0:y0 + H, x0:x0 + W, :] = img
            new_label = label.copy()
            if new_label.size:
                new_label[:, 1] = (new_label[:, 1] * W + x0) / newW
                new_label[:, 3] = (new_label[:, 3] * W + x0) / newW
                new_label[:, 2] = (new_label[:, 2] * H + y0) / newH
                new_label[:, 4] = (new_label[:, 4] * H + y0) / newH
            return array(canvas), new_label
        return src, label


def CreateDetAugmenter(data_shape: Tuple[int, int, int], resize: int = 0,
                       rand_crop: float = 0, rand_pad: float = 0,
                       rand_mirror: bool = False, mean=None, std=None,
                       brightness: float = 0, contrast: float = 0,
                       saturation: float = 0, pca_noise: float = 0,
                       hue: float = 0, inter_method: int = 2,
                       min_object_covered: float = 0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0),
                       min_eject_coverage: float = 0.3,
                       max_attempts: int = 50,
                       pad_val=(127, 127, 127)) -> List[DetAugmenter]:
    """Standard detection augmenter pipeline (reference: detection.py
    CreateDetAugmenter): geometric det augs first, then borrowed
    image-only augs, then resize-to-shape, normalize, cast."""
    auglist: List[DetAugmenter] = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(
            min_object_covered=min_object_covered,
            aspect_ratio_range=aspect_ratio_range,
            area_range=(min(area_range[0], 1.0), min(area_range[1], 1.0)),
            min_eject_coverage=min_eject_coverage,
            max_attempts=max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range=aspect_ratio_range,
                              area_range=(max(1.0, area_range[0]),
                                          max(1.0, area_range[1])),
                              max_attempts=max_attempts, pad_val=pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # force to the network's input size (boxes are normalized: unaffected)
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        mean = onp.asarray(mean if mean is not None else [0, 0, 0],
                           onp.float32)
        std = onp.asarray(std if std is not None else [1, 1, 1], onp.float32)
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter:
    """Detection data iterator (reference: detection.py ImageDetIter).

    Yields ``DataBatch`` with data ``(B, C, H, W)`` and label
    ``(B, max_objects, 5)`` rows ``[class, xmin, ymin, xmax, ymax]``
    normalized to [0, 1], padded with -1 rows.

    Sources: ``path_imgrec`` (an im2rec ``.rec`` whose header label is the
    flat det format ``[header_width, object_width, obj0..., obj1...]``),
    or ``imglist`` of ``(label_rows, path_or_array)``, an array in place
    of the path for in-memory datasets; a label is (M, 5) rows or the
    flat format."""

    def __init__(self, batch_size: int, data_shape: Tuple[int, int, int],
                 path_imgrec: Optional[str] = None,
                 imglist: Optional[Sequence] = None, path_root: str = "",
                 aug_list: Optional[List[DetAugmenter]] = None,
                 shuffle: bool = False, max_objects: Optional[int] = None,
                 **kwargs):
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        self._shuffle = shuffle
        self._items: List = []
        if path_imgrec:
            rec = recordio.MXRecordIO(path_imgrec, "r")
            while True:
                raw = rec.read()
                if raw is None:
                    break
                header, img = recordio.unpack_img(raw, iscolor=1)
                label = self._parse_label(onp.asarray(header.label,
                                                      onp.float32))
                cv2 = _cv2()
                img = onp.ascontiguousarray(
                    cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
                self._items.append((label, img))
            rec.close()
        elif imglist:
            for label, src in imglist:
                label = self._parse_label(onp.asarray(label, onp.float32))
                if isinstance(src, str):
                    self._items.append((label, os.path.join(path_root, src)))
                else:
                    self._items.append(
                        (label, onp.asarray(src.asnumpy() if isinstance(
                            src, NDArray) else src)))
        else:
            raise MXNetError("ImageDetIter needs path_imgrec or imglist")
        self.max_objects = max_objects or max(
            (lab.shape[0] for lab, _ in self._items), default=1)
        self.reset()

    @staticmethod
    def _parse_label(flat: onp.ndarray) -> onp.ndarray:
        """Accept (M, 5) rows or the flat lst/rec det format
        ``[header_width, object_width, header..., obj0..., ...]``."""
        flat = onp.asarray(flat, onp.float32)
        if flat.ndim == 2:
            if flat.shape[1] != 5:
                raise MXNetError(f"det label rows must be "
                                 f"[cls, x1, y1, x2, y2]; got {flat.shape}")
            return flat
        if flat.size >= 2 and float(flat[0]) >= 2 and float(flat[1]) >= 5:
            hw, ow = int(flat[0]), int(flat[1])
            body = flat[hw:]
            n = body.size // ow
            return body[:n * ow].reshape(n, ow)[:, :5]
        if flat.size % 5 == 0 and flat.size:
            return flat.reshape(-1, 5)
        raise MXNetError(f"cannot parse det label of size {flat.size}")

    def reset(self):
        self._order = list(range(len(self._items)))
        if self._shuffle:
            pyrandom.shuffle(self._order)
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        from ..io import DataBatch
        if self._pos + self.batch_size > len(self._order):
            raise StopIteration
        data, labels = [], []
        for i in self._order[self._pos:self._pos + self.batch_size]:
            label, src = self._items[i]
            img = imread(src) if isinstance(src, str) else array(src)
            for aug in self.auglist:
                img, label = aug(img, label)
            arr = img.asnumpy()
            if arr.dtype != onp.float32:
                arr = arr.astype(onp.float32)
            data.append(arr.transpose(2, 0, 1))
            padded = onp.full((self.max_objects, 5), -1.0, onp.float32)
            m = min(label.shape[0], self.max_objects)
            padded[:m] = label[:m]
            labels.append(padded)
        self._pos += self.batch_size
        return DataBatch([_array(onp.stack(data))],
                         [_array(onp.stack(labels))])
