"""Vision transforms (JAX counterpart: ``gluon/data/vision/transforms.py``;
reference: ``python/mxnet/gluon/data/vision/transforms.py``).

Each transform is a Gluon ``Block`` whose ``forward`` computes on numpy
(an ``NDArray`` input is read to the host first) and returns numpy: no
tensor is made, so they run in forked ``DataLoader`` workers. The random
ones draw from numpy's global stream in the JAX package's order. ``Resize``
and ``RandomResizedCrop`` resize bilinearly in numpy (no ``cv2``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as onp

from ....ndarray import NDArray
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting"]


def _to_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return onp.asarray(x)


class Compose(Sequential):
    """Chain transforms (reference: transforms.Compose)."""

    def __init__(self, transforms: Sequence):
        super().__init__(prefix="")
        for t in transforms:
            self.add(t if isinstance(t, Block) else _FuncTransform(t))


class _FuncTransform(Block):
    def __init__(self, fn):
        super().__init__(prefix="")
        self._fn = fn

    def forward(self, x):
        return self._fn(x)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__(prefix="")
        self._dtype = dtype

    def forward(self, x):
        return _to_numpy(x).astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference: ToTensor)."""

    def forward(self, x):
        x = _to_numpy(x).astype(onp.float32) / 255.0
        if x.ndim == 3:
            return onp.transpose(x, (2, 0, 1))
        return onp.transpose(x, (0, 3, 1, 2))


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__(prefix="")
        self._mean = onp.asarray(mean, dtype=onp.float32)
        self._std = onp.asarray(std, dtype=onp.float32)

    def forward(self, x):
        x = _to_numpy(x).astype(onp.float32)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return (x - mean) / std


def _resize_hwc(img, size):
    """Nearest+bilinear host resize without external deps."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        ow, oh = size, size
    else:
        ow, oh = size
    ys = onp.linspace(0, h - 1, oh)
    xs = onp.linspace(0, w - 1, ow)
    y0 = onp.floor(ys).astype(int)
    x0 = onp.floor(xs).astype(int)
    y1 = onp.minimum(y0 + 1, h - 1)
    x1 = onp.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(onp.float32)
    out = (img[y0][:, x0] * (1 - wy) * (1 - wx) + img[y0][:, x1] * (1 - wy) * wx
           + img[y1][:, x0] * wy * (1 - wx) + img[y1][:, x1] * wy * wx)
    return out


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__(prefix="")
        self._size = size

    def forward(self, x):
        return _resize_hwc(_to_numpy(x), self._size)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__(prefix="")
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        x = _to_numpy(x)
        h, w = x.shape[:2]
        cw, ch = self._size
        x0 = max(0, (w - cw) // 2)
        y0 = max(0, (h - ch) // 2)
        return x[y0:y0 + ch, x0:x0 + cw]


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__(prefix="")
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        x = _to_numpy(x)
        if self._pad:
            p = self._pad
            x = onp.pad(x, ((p, p), (p, p), (0, 0)), mode="constant")
        h, w = x.shape[:2]
        cw, ch = self._size
        x0 = onp.random.randint(0, max(1, w - cw + 1))
        y0 = onp.random.randint(0, max(1, h - ch + 1))
        return x[y0:y0 + ch, x0:x0 + cw]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__(prefix="")
        self._size = size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        x = _to_numpy(x)
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = onp.random.uniform(*self._scale) * area
            log_ratio = (onp.log(self._ratio[0]), onp.log(self._ratio[1]))
            aspect = onp.exp(onp.random.uniform(*log_ratio))
            cw = int(round((target_area * aspect) ** 0.5))
            ch = int(round((target_area / aspect) ** 0.5))
            if cw <= w and ch <= h:
                x0 = onp.random.randint(0, w - cw + 1)
                y0 = onp.random.randint(0, h - ch + 1)
                crop = x[y0:y0 + ch, x0:x0 + cw]
                return _resize_hwc(crop, self._size)
        return _resize_hwc(x, self._size)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        x = _to_numpy(x)
        if onp.random.rand() < 0.5:
            return x[:, ::-1].copy()
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        x = _to_numpy(x)
        if onp.random.rand() < 0.5:
            return x[::-1].copy()
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__(prefix="")
        self._b = brightness

    def forward(self, x):
        x = _to_numpy(x).astype(onp.float32)
        alpha = 1.0 + onp.random.uniform(-self._b, self._b)
        return x * alpha


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__(prefix="")
        self._c = contrast

    def forward(self, x):
        x = _to_numpy(x).astype(onp.float32)
        alpha = 1.0 + onp.random.uniform(-self._c, self._c)
        gray = x.mean()
        return x * alpha + gray * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__(prefix="")
        self._s = saturation

    def forward(self, x):
        x = _to_numpy(x).astype(onp.float32)
        alpha = 1.0 + onp.random.uniform(-self._s, self._s)
        gray = x.mean(axis=-1, keepdims=True)
        return x * alpha + gray * (1 - alpha)


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise."""

    _eigval = onp.asarray([55.46, 4.794, 1.148])
    _eigvec = onp.asarray([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha):
        super().__init__(prefix="")
        self._alpha = alpha

    def forward(self, x):
        x = _to_numpy(x).astype(onp.float32)
        alpha = onp.random.normal(0, self._alpha, size=(3,))
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return x + rgb
