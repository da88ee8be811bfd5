"""Vision datasets (JAX counterpart: ``gluon/data/vision/datasets.py``;
reference: ``python/mxnet/gluon/data/vision/datasets.py``).

Nothing is downloaded: MNIST and FashionMNIST read the idx files under
``root`` (plain or ``.gz``), CIFAR-10/100 the binary batches, and where
the files are missing each makes the JAX package's seeded stand-in, bit
for bit (the same shapes and classes). ``ImageRecordDataset`` reads an
im2rec pack through ``recordio.MXIndexedRecordIO`` (the JAX class names
an ``IndexedRecordIO`` its ``recordio`` lacks); ``ImageFolderDataset`` a
folder of class folders. Samples are numpy arrays.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ....base import MXNetError
from ..dataset import ArrayDataset, Dataset, _RecordReader

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageRecordDataset",
           "ImageFolderDataset"]


def _imdecode(buf: bytes, flag: int) -> onp.ndarray:
    """``mx.image.imdecode`` on numpy (RGB for colour): no NDArray, so a
    forked worker may call it."""
    import cv2
    img = cv2.imdecode(onp.frombuffer(buf, dtype=onp.uint8), flag)
    if img is None:
        raise MXNetError("imdecode failed: invalid image data")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def _read_idx_images(path):
    with gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = onp.frombuffer(f.read(), dtype=onp.uint8)
        return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path):
    with gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        return onp.frombuffer(f.read(), dtype=onp.uint8).astype(onp.int32)


def _synthetic_digits(num: int, seed: int, image_size: int = 28):
    """Deterministic MNIST stand-in: each class is a distinct oriented-bar +
    blob glyph with noise — linearly non-trivial, conv-easy (so the LeNet
    convergence gate at ≥97% is meaningful)."""
    rng = onp.random.RandomState(seed)
    labels = rng.randint(0, 10, size=num).astype(onp.int32)
    xs = onp.zeros((num, image_size, image_size, 1), dtype=onp.uint8)
    yy, xx = onp.mgrid[0:image_size, 0:image_size]
    for i in range(num):
        c = labels[i]
        angle = c * onp.pi / 10.0
        # oriented bar through the center
        d = onp.abs((xx - 14) * onp.sin(angle) - (yy - 14) * onp.cos(angle))
        img = (d < 2.0).astype(onp.float32) * 200.0
        # class-dependent blob position
        bx, by = 6 + (c % 5) * 4, 6 + (c // 5) * 12
        blob = onp.exp(-(((xx - bx) ** 2 + (yy - by) ** 2) / 8.0)) * 255.0
        img = onp.clip(img + blob, 0, 255)
        jx, jy = rng.randint(-2, 3), rng.randint(-2, 3)
        img = onp.roll(onp.roll(img, jx, axis=1), jy, axis=0)
        img = img + rng.randn(image_size, image_size) * 12.0
        xs[i, :, :, 0] = onp.clip(img, 0, 255).astype(onp.uint8)
    return xs, labels


class MNIST(ArrayDataset):
    """MNIST (reference: gluon.data.vision.MNIST). Loads the standard idx
    files from ``root`` when present; synthesizes a stand-in otherwise."""

    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }
    _synthetic_sizes = {True: 20000, False: 4000}

    def __init__(self, root: str = os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train: bool = True, transform=None):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        data, label = self._get_data()
        super().__init__(data, label)

    def _get_data(self):
        imgf, lblf = self._files[self._train]
        for ext in ("", ".gz"):
            ip = os.path.join(self._root, imgf + ext)
            lp = os.path.join(self._root, lblf + ext)
            if os.path.exists(ip) and os.path.exists(lp):
                return _read_idx_images(ip), _read_idx_labels(lp)
        return _synthetic_digits(self._synthetic_sizes[self._train],
                                 seed=42 if self._train else 43)

    def __getitem__(self, idx):
        data, label = super().__getitem__(idx)
        data = data.astype(onp.float32)
        if self._transform is not None:
            return self._transform(data, label)
        return data, label


class FashionMNIST(MNIST):
    _synthetic_sizes = {True: 20000, False: 4000}

    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root: str = os.path.join("~", ".mxnet", "datasets",
                                                "fashion-mnist"),
                 train: bool = True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(ArrayDataset):
    """CIFAR10 (reference: gluon.data.vision.CIFAR10); local bin files or a
    32×32×3 procedural stand-in."""

    _num_classes = 10

    def __init__(self, root: str = os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train: bool = True, transform=None):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        data, label = self._get_data()
        super().__init__(data, label)

    def _load_bins(self, files):
        xs, ys = [], []
        for fn in files:
            raw = onp.fromfile(fn, dtype=onp.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0].astype(onp.int32))
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        return onp.concatenate(xs), onp.concatenate(ys)

    def _get_data(self):
        base = os.path.join(self._root, "cifar-10-batches-bin")
        if self._train:
            files = [os.path.join(base, f"data_batch_{i}.bin") for i in range(1, 6)]
        else:
            files = [os.path.join(base, "test_batch.bin")]
        if all(os.path.exists(f) for f in files):
            return self._load_bins(files)
        n = 10000 if self._train else 2000
        rng = onp.random.RandomState(7 if self._train else 8)
        labels = rng.randint(0, self._num_classes, size=n).astype(onp.int32)
        xs = onp.zeros((n, 32, 32, 3), dtype=onp.uint8)
        for i in range(n):
            c = labels[i]
            img = rng.randn(32, 32, 3) * 20 + 60
            img[:, :, c % 3] += 80 + 10 * (c // 3)
            img[(c * 3) % 28:(c * 3) % 28 + 4, :, :] += 60
            xs[i] = onp.clip(img, 0, 255).astype(onp.uint8)
        return xs, labels

    def __getitem__(self, idx):
        data, label = super().__getitem__(idx)
        data = data.astype(onp.float32)
        if self._transform is not None:
            return self._transform(data, label)
        return data, label


class CIFAR100(CIFAR10):
    _num_classes = 100

    def __init__(self, root: str = os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label: bool = False, train: bool = True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)


class ImageRecordDataset(Dataset):
    """``(image, label)`` of each record of an im2rec pack, decoded with
    ``cv2`` (``flag`` 1: three channels, RGB; 0: grey), by position in
    the ``.idx`` file (reference: ``gluon.data.vision.ImageRecordDataset``).
    """

    def __init__(self, filename: str, flag: int = 1, transform=None):
        self._reader = _RecordReader(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._reader.keys)

    def __getitem__(self, idx):
        from .... import recordio
        header, img = recordio.unpack(self._reader.read(idx))
        arr = _imdecode(img, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(arr, label)
        return arr, label


class ImageFolderDataset(Dataset):
    """Folder-of-class-folders dataset (reference: ImageFolderDataset)."""

    def __init__(self, root: str, flag: int = 1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if filename.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, filename), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        fn, label = self.items[idx]
        if fn.endswith(".npy"):
            img = onp.load(fn)
        else:
            with open(fn, "rb") as f:
                img = _imdecode(f.read(), self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
