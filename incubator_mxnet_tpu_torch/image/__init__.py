"""``mx.image``: image decode, the augmenters and ``ImageIter``.

Counterpart: the JAX package's ``image/__init__.py`` (reference:
``src/io/image_io.cc`` and ``python/mxnet/image/image.py``). Host-side
numpy and OpenCV work, drawing from Python's ``random`` as the reference
does; ``cv2`` is imported at first use. Each image is an NDArray on the
CPU while it is augmented; a batch lands on the current context (the card
unless a ``with mx.cpu():`` says otherwise). ``ImageIter`` and
``ImageDetIter`` read an ``imglist`` or an im2rec ``.rec`` file
(``path_imgrec``, through ``recordio``).
"""
from __future__ import annotations

import os
import random as pyrandom
from typing import List, Optional, Sequence, Tuple

import numpy as onp

from .. import recordio
from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray
from ..ndarray import array as _array

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize", "random_size_crop",
           "Augmenter", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "CenterCropAug", "HorizontalFlipAug", "ColorNormalizeAug",
           "CastAug", "CreateAugmenter", "ImageIter"]


def _cv2():
    import cv2
    return cv2


def array(a) -> NDArray:
    """One image (or label) as an NDArray on the CPU."""
    return _array(a, ctx=cpu())


def imdecode(buf, flag: int = 1, to_rgb: bool = True) -> NDArray:
    """Decode jpeg/png bytes (reference: MXImgDecode → cv2.imdecode)."""
    cv2 = _cv2()
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = cv2.imdecode(onp.frombuffer(buf, dtype=onp.uint8), flag)
    if img is None:
        raise MXNetError("imdecode failed: invalid image data")
    if to_rgb and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return array(img)


def imread(filename: str, flag: int = 1, to_rgb: bool = True) -> NDArray:
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src: NDArray, w: int, h: int, interp: int = 1) -> NDArray:
    cv2 = _cv2()
    out = cv2.resize(src.asnumpy(), (w, h),
                     interpolation=cv2.INTER_LINEAR if interp
                     else cv2.INTER_NEAREST)
    return array(out)


def resize_short(src: NDArray, size: int, interp: int = 2) -> NDArray:
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src: NDArray, x0: int, y0: int, w: int, h: int,
               size: Optional[Tuple[int, int]] = None,
               interp: int = 2) -> NDArray:
    out = array(src.asnumpy()[y0:y0 + h, x0:x0 + w])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src: NDArray, size: Tuple[int, int], interp: int = 2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src: NDArray, size: Tuple[int, int], interp: int = 2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0, y0 = (w - new_w) // 2, (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src: NDArray, size: Tuple[int, int], area, ratio,
                     interp: int = 2, max_attempts: int = 10):
    """Inception-style random area/aspect crop (reference parity)."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(max_attempts):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        aspect = onp.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round((target_area * aspect) ** 0.5))
        new_h = int(round((target_area / aspect) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src: NDArray, mean, std=None) -> NDArray:
    x = src.asnumpy().astype(onp.float32)
    mean = onp.asarray(mean.asnumpy() if isinstance(mean, NDArray) else mean)
    x = x - mean
    if std is not None:
        std = onp.asarray(std.asnumpy() if isinstance(std, NDArray) else std)
        x = x / std
    return array(x)


# ---------------------------------------------------------------------------
# Augmenter zoo (reference: image.Augmenter subclasses)
# ---------------------------------------------------------------------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        import json
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src: NDArray) -> NDArray:
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size: int, interp: int = 2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size: Tuple[int, int], interp: int = 2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p: float = 0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return array(src.asnumpy()[:, ::-1])
        return src


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class CastAug(Augmenter):
    def __init__(self, typ: str = "float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def CreateAugmenter(data_shape: Tuple[int, int, int], resize: int = 0,
                    rand_crop: bool = False, rand_resize: bool = False,
                    rand_mirror: bool = False, mean=None, std=None,
                    inter_method: int = 2, **kwargs) -> List[Augmenter]:
    """Standard augmenter list builder (reference: image.CreateAugmenter)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean,
                                         std if std is not None else 1.0))
    return auglist


class ImageIter:
    """Image iterator over the records of a ``.rec`` file (``path_imgrec``:
    ``recordio.unpack_img``, BGR to RGB) or an ``imglist`` of ``(label,
    path)`` (JAX counterpart: ``image/__init__.py:226``; reference:
    python/mxnet/image/image.py ImageIter)."""

    def __init__(self, batch_size: int, data_shape: Tuple[int, int, int],
                 path_imgrec: Optional[str] = None,
                 imglist: Optional[Sequence] = None,
                 path_root: str = "",
                 aug_list: Optional[List[Augmenter]] = None,
                 shuffle: bool = False, **kwargs):
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self._shuffle = shuffle
        self._items: List = []
        if path_imgrec:
            rec = recordio.MXRecordIO(path_imgrec, "r")
            while True:
                raw = rec.read()
                if raw is None:
                    break
                self._items.append(("rec", raw))
            rec.close()
        elif imglist:
            for entry in imglist:
                self._items.append(("file", (float(entry[0]), os.path.join(
                    path_root, entry[-1]))))
        else:
            raise MXNetError("ImageIter needs path_imgrec or imglist")
        self.reset()

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
            kind, payload = self._items[i]
            if kind == "rec":
                header, img = recordio.unpack_img(payload, iscolor=1)
                cv2 = _cv2()
                img = array(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
                label = float(header.label) if not onp.ndim(header.label) \
                    else header.label
            else:
                label, path = payload
                img = imread(path)
            for aug in self.auglist:
                img = aug(img)
            data.append(img.asnumpy().transpose(2, 0, 1))
            labels.append(label)
        self._pos += self.batch_size
        return DataBatch([_array(onp.stack(data))],
                         [_array(onp.asarray(labels, onp.float32))])

    next = __next__


# detection augmenters and ImageDetIter (reference:
# python/mxnet/image/detection.py), imported last: the submodule borrows
# the image-only augmenters above
from .detection import (  # noqa: E402,F401
    DetAugmenter, DetBorrowAug, DetRandomSelectAug, DetHorizontalFlipAug,
    DetRandomCropAug, DetRandomPadAug, CreateDetAugmenter, ImageDetIter)

__all__ += ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
            "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
            "CreateDetAugmenter", "ImageDetIter"]
