"""im2rec: pack an image folder into RecordIO (JAX counterpart: the repo's
``tools/im2rec.py``; reference: MXNet's ``tools/im2rec.py``). Its
``.lst``, ``.rec`` and ``.idx`` files are byte-identical to the JAX
tool's for the same folder and arguments.

Two phases, same CLI contract as the reference:

1. ``--list``: walk an image root, write ``prefix.lst``
   (``index \\t label \\t relpath`` rows; one label per subdirectory, in
   sorted order — the standard ImageNet-style folder layout).
2. default: read ``prefix.lst`` + root, encode each image (resize/quality
   options) and write ``prefix.rec`` + ``prefix.idx`` via
   ``MXIndexedRecordIO`` — consumable by ``io.ImageRecordIter`` and
   ``gluon.data.vision.ImageRecordDataset``.

Images decode through cv2 when available, else PIL (``.npy`` inputs load
with numpy); without cv2 the resize is torch's bilinear interpolation on
the CPU (the JAX tool's is ``jax.image.resize``), and encoding needs cv2.

Usage::

    python -m incubator_mxnet_tpu_torch.tools.im2rec --list prefix image_root
    python -m incubator_mxnet_tpu_torch.tools.im2rec prefix image_root \
        [--resize 256] [--quality 95]
"""
from __future__ import annotations

import argparse
import os
import random
import sys
from typing import List, Optional, Tuple

import numpy as onp

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".npy"}


def _find_images(root: str) -> List[Tuple[str, int]]:
    """(relpath, label) pairs; label = sorted subdirectory index (files
    directly under root get label 0)."""
    root = os.path.abspath(root)
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    label_of = {c: i for i, c in enumerate(classes)}
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        rel_dir = os.path.relpath(dirpath, root)
        top = rel_dir.split(os.sep)[0]
        label = label_of.get(top, 0)
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in _EXTS:
                rel = os.path.normpath(os.path.join(rel_dir, f))
                out.append((rel, label))
    return out


def make_list(prefix: str, root: str, shuffle: bool = False,
              train_ratio: float = 1.0, seed: int = 0) -> List[str]:
    """Write ``prefix.lst`` (and ``prefix_val.lst`` when train_ratio < 1)."""
    pairs = _find_images(root)
    if shuffle:
        rng = random.Random(seed)
        rng.shuffle(pairs)
    n_train = int(len(pairs) * train_ratio)
    written = []

    def _write(path, rows, start=0):
        with open(path, "w") as f:
            for i, (rel, label) in enumerate(rows):
                f.write(f"{start + i}\t{float(label)}\t{rel}\n")
        written.append(path)

    _write(prefix + ".lst", pairs[:n_train])
    if train_ratio < 1.0:
        _write(prefix + "_val.lst", pairs[n_train:], start=n_train)
    return written


def read_list(path: str):
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            label = [float(x) for x in parts[1:-1]]
            yield idx, (label[0] if len(label) == 1 else label), parts[-1]


def _load_image(path: str) -> onp.ndarray:
    if path.lower().endswith(".npy"):
        return onp.load(path)
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"cv2 failed to read {path}")
        return img
    except ImportError:
        from PIL import Image
        return onp.asarray(Image.open(path).convert("RGB"))[:, :, ::-1]


def _resize(img: onp.ndarray, size: int) -> onp.ndarray:
    """Short-side resize (reference --resize semantics)."""
    if size <= 0:
        return img
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    if h < w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    try:
        import cv2
        return cv2.resize(img, (nw, nh))
    except ImportError:
        import torch
        x = torch.from_numpy(onp.ascontiguousarray(img, "float32"))
        x = x.reshape(img.shape[:2] + (-1,)).permute(2, 0, 1)[None]
        out = torch.nn.functional.interpolate(
            x, size=(nh, nw), mode="bilinear", align_corners=False,
            antialias=True)[0].permute(1, 2, 0).reshape(
                (nh, nw) + img.shape[2:])
        return out.numpy().astype(img.dtype)


def make_record(prefix: str, root: str, lst_path: Optional[str] = None,
                resize: int = 0, quality: int = 95, img_fmt: str = ".jpg",
                use_native: Optional[bool] = None) -> Tuple[str, str]:
    """Pack ``prefix.lst`` into ``prefix.rec``/``prefix.idx``.

    The per-record hot loop (IRHeader pack + dmlc framing + index) runs in
    C++ when the native shim is available (reference: tools/im2rec.cc),
    byte-identical to the Python path; image encode stays on cv2 either
    way. Force a path with ``use_native`` (or ``MXTPU_IM2REC_NATIVE=0/1``).
    """
    from .. import native, recordio

    if use_native is None:
        env = os.environ.get("MXTPU_IM2REC_NATIVE")
        use_native = native.available() if env is None else env == "1"
    lst_path = lst_path or prefix + ".lst"
    rec_path, idx_path = prefix + ".rec", prefix + ".idx"
    if use_native:
        rec = native.NativeIm2RecWriter(rec_path, idx_path)
    else:
        rec = recordio.MXIndexedRecordIO(idx_path, rec_path, "w")
    n = 0
    try:
        for idx, label, rel in read_list(lst_path):
            img = _load_image(os.path.join(root, rel))
            img = _resize(img, resize)
            if use_native:
                # encode only; everything after the encode is native
                payload = recordio.encode_img(img, quality=quality,
                                              img_fmt=img_fmt)
                rec.write(idx, label, idx, payload)
            else:
                header = recordio.IRHeader(0, label, idx, 0)
                payload = recordio.pack_img(header, img, quality=quality,
                                            img_fmt=img_fmt)
                rec.write_idx(idx, payload)
            n += 1
    finally:
        rec.close()
    print(f"im2rec: packed {n} images -> {rec_path}")
    return rec_path, idx_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Pack images into RecordIO (reference: tools/im2rec.py)")
    ap.add_argument("prefix", help="output prefix (prefix.lst / prefix.rec)")
    ap.add_argument("root", help="image root directory")
    ap.add_argument("--list", action="store_true",
                    help="generate prefix.lst instead of packing")
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--train-ratio", type=float, default=1.0)
    ap.add_argument("--resize", type=int, default=0,
                    help="short-side resize before packing")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--encoding", default=".jpg", choices=[".jpg", ".png"])
    args = ap.parse_args(argv)
    if args.list:
        for p in make_list(args.prefix, args.root, shuffle=args.shuffle,
                           train_ratio=args.train_ratio):
            print(f"im2rec: wrote {p}")
        return 0
    make_record(args.prefix, args.root, resize=args.resize,
                quality=args.quality, img_fmt=args.encoding)
    return 0


if __name__ == "__main__":
    sys.exit(main())
