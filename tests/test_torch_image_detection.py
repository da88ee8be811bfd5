"""PyTorch port: ``mx.image``'s detection augmenters and ``ImageDetIter``
held against the JAX package on the CPU.

The cases of ``tests/test_image_detection.py``, run on the port, and each
augmenter and iterator against the JAX package's with the same
``random.seed``: the same pixels and labels, exactly (host-side numpy and
OpenCV in both, drawing from Python's ``random`` in the same order); after
``ColorNormalizeAug`` within 1e-5 (float32 arithmetic of numpy in both, on
arrays that passed through each package's NDArray).
"""
import json
import random as pyrandom

import numpy as onp
import pytest

from incubator_mxnet_tpu import image as jimage

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import image, nd
from incubator_mxnet_tpu_torch.image import (
    CreateDetAugmenter, DetBorrowAug, DetHorizontalFlipAug, DetRandomCropAug,
    DetRandomPadAug, DetRandomSelectAug, ImageDetIter)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _img_np(h=40, w=60, seed=0):
    rng = onp.random.RandomState(seed)
    return rng.randint(0, 255, (h, w, 3)).astype("uint8")


def _img(h=40, w=60, seed=0):
    return nd.array(_img_np(h, w, seed))


def _label():
    # two objects: [cls, x1, y1, x2, y2] normalised
    return onp.array([[1, 0.1, 0.2, 0.5, 0.6],
                      [3, 0.6, 0.1, 0.9, 0.4]], "float32")


def _vs_jax(port_aug, jax_aug, seed, img=None, label=None):
    """Both augmenters on the same image and label after the same
    ``random.seed``: equal pixels and labels."""
    img = _img_np() if img is None else img
    label = _label() if label is None else label
    pyrandom.seed(seed)
    src, lab = port_aug(nd.array(img), label.copy())
    pyrandom.seed(seed)
    jsrc, jlab = jax_aug(_jarray(img), label.copy())
    onp.testing.assert_array_equal(src.asnumpy(), jsrc.asnumpy())
    onp.testing.assert_array_equal(lab, jlab)
    return src, lab


def _jarray(a):
    from incubator_mxnet_tpu import nd as jnd
    return jnd.array(a)


def test_det_horizontal_flip_flips_boxes():
    aug = DetHorizontalFlipAug(p=1.0)
    src, lab = aug(_img(), _label())
    onp.testing.assert_allclose(lab[0, [1, 3]], [0.5, 0.9], atol=1e-6)
    onp.testing.assert_allclose(lab[1, [1, 3]], [0.1, 0.4], atol=1e-6)
    assert (lab[:, 1] < lab[:, 3]).all()
    src2, lab2 = aug(src, lab)
    onp.testing.assert_allclose(src2.asnumpy(), _img().asnumpy())
    assert src.context == mx.cpu()


def test_det_random_crop_keeps_coverage_and_renormalizes():
    aug = DetRandomCropAug(min_object_covered=0.5, area_range=(0.5, 1.0),
                           min_eject_coverage=0.3, max_attempts=100)
    jaug = jimage.DetRandomCropAug(min_object_covered=0.5,
                                   area_range=(0.5, 1.0),
                                   min_eject_coverage=0.3, max_attempts=100)
    for seed in range(5):
        src, lab = _vs_jax(aug, jaug, seed)
        assert lab.shape[1] == 5 and lab.shape[0] >= 1
        assert (lab[:, 1:] >= 0).all() and (lab[:, 1:] <= 1).all()
        assert (lab[:, 1] <= lab[:, 3]).all()
        assert (lab[:, 2] <= lab[:, 4]).all()
    # negative images (no gt box) pass through the crop
    empty = onp.zeros((0, 5), "float32")
    src, lab = _vs_jax(DetRandomCropAug(max_attempts=3),
                       jimage.DetRandomCropAug(max_attempts=3), 1,
                       label=empty)
    assert lab.shape == (0, 5)
    assert src.shape[2] == 3


def test_det_random_pad_shrinks_boxes():
    src, lab = _vs_jax(DetRandomPadAug(area_range=(2.0, 2.5)),
                       jimage.DetRandomPadAug(area_range=(2.0, 2.5)), 0)
    assert src.shape[0] >= 40 and src.shape[1] >= 60
    orig = _label()
    area = (lab[:, 3] - lab[:, 1]) * (lab[:, 4] - lab[:, 2])
    oarea = (orig[:, 3] - orig[:, 1]) * (orig[:, 4] - orig[:, 2])
    assert (area < oarea).all()
    assert (lab[:, 1:] >= 0).all() and (lab[:, 1:] <= 1).all()


def test_det_random_select_skip_prob_one_is_identity():
    aug = DetRandomSelectAug([DetHorizontalFlipAug(1.0)], skip_prob=1.0)
    src, lab = aug(_img(), _label())
    onp.testing.assert_allclose(src.asnumpy(), _img().asnumpy())
    onp.testing.assert_allclose(lab, _label())
    # a coin flip per sample, as the JAX package draws it
    for seed in range(4):
        _vs_jax(DetRandomSelectAug([DetHorizontalFlipAug(1.0)], 0.5),
                jimage.DetRandomSelectAug([jimage.DetHorizontalFlipAug(1.0)],
                                          0.5), seed)


def test_create_det_augmenter_pipeline_runs():
    kw = dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
              mean=[123, 117, 104], std=[58, 57, 57])
    augs = CreateDetAugmenter((3, 32, 32), **kw)
    jaugs = jimage.CreateDetAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in augs] == [type(a).__name__
                                                 for a in jaugs]
    for seed in range(3):
        pyrandom.seed(seed)
        src, lab = _img(), _label()
        for a in augs:
            src, lab = a(src, lab)
        pyrandom.seed(seed)
        jsrc, jlab = _jarray(_img_np()), _label()
        for a in jaugs:
            jsrc, jlab = a(jsrc, jlab)
        assert src.shape == (32, 32, 3)
        assert str(src.asnumpy().dtype) == "float32"
        assert lab.shape[1] == 5
        onp.testing.assert_allclose(src.asnumpy(), jsrc.asnumpy(),
                                    rtol=1e-6, atol=1e-5)
        onp.testing.assert_array_equal(lab, jlab)


def test_image_det_iter_batches_and_pads():
    items = [(_label(), _img(seed=i).asnumpy()) for i in range(4)] + \
            [(_label()[:1], _img(seed=9).asnumpy())]
    pyrandom.seed(3)
    it = ImageDetIter(batch_size=2, data_shape=(3, 32, 32), imglist=items,
                      rand_mirror=True, shuffle=True)
    batches = list(it)
    pyrandom.seed(3)
    jbatches = list(jimage.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                                        imglist=items, rand_mirror=True,
                                        shuffle=True))
    assert len(batches) == len(jbatches) == 2    # 5 items, batch 2
    for b, jb in zip(batches, jbatches):
        assert b.data[0].shape == (2, 3, 32, 32)
        assert b.label[0].shape == (2, 2, 5)
        assert b.data[0].context == mx.cpu()
        onp.testing.assert_allclose(b.data[0].asnumpy(),
                                    jb.data[0].asnumpy(), atol=1e-5)
        onp.testing.assert_array_equal(b.label[0].asnumpy(),
                                       jb.label[0].asnumpy())
    it.reset()
    assert next(it).data[0].shape == (2, 3, 32, 32)
    it2 = ImageDetIter(batch_size=1, data_shape=(3, 32, 32),
                       imglist=[(_label()[:1], _img().asnumpy())],
                       max_objects=3)
    lab = next(it2).label[0].asnumpy()
    assert lab.shape == (1, 3, 5)
    assert (lab[0, 1:] == -1).all()


def test_labels_dumps_and_recordio_refused(tmp_path):
    """The flat lst/rec det label format parses; every augmenter dumps the
    JAX package's JSON; ``path_imgrec`` reads a ``.rec`` file (written by
    the JAX ``recordio``) whose header holds the flat det label, in
    ``ImageDetIter`` and ``ImageIter``."""
    flat = onp.array([2, 5, 1, 0.1, 0.2, 0.5, 0.6, 3, 0.6, 0.1, 0.9, 0.4],
                     "float32")
    onp.testing.assert_allclose(ImageDetIter._parse_label(flat), _label())
    onp.testing.assert_allclose(ImageDetIter._parse_label(_label().ravel()),
                                _label())
    for a, ja in ((DetHorizontalFlipAug(0.5),
                   jimage.DetHorizontalFlipAug(0.5)),
                  (DetRandomCropAug(), jimage.DetRandomCropAug()),
                  (DetRandomPadAug(), jimage.DetRandomPadAug()),
                  (DetBorrowAug(image.CastAug()),
                   jimage.DetBorrowAug(jimage.CastAug()))):
        name, _ = json.loads(a.dumps())
        assert name == type(a).__name__
        assert json.loads(a.dumps()) == json.loads(ja.dumps())
    from incubator_mxnet_tpu import recordio as jrec
    rec = str(tmp_path / "det.rec")
    w = jrec.MXRecordIO(rec, "w")
    img = onp.random.RandomState(0).randint(0, 255, (8, 8, 3)).astype("uint8")
    w.write(jrec.pack_img(jrec.IRHeader(0, flat, 0, 0), img, img_fmt=".png"))
    w.close()
    with mx.cpu():
        b = next(ImageDetIter(batch_size=1, data_shape=(3, 8, 8),
                              path_imgrec=rec))
        onp.testing.assert_allclose(b.label[0].asnumpy()[0], _label())
        onp.testing.assert_array_equal(
            b.data[0].asnumpy()[0].transpose(1, 2, 0), img[:, :, ::-1])
        b = next(image.ImageIter(batch_size=1, data_shape=(3, 8, 8),
                                 path_imgrec=rec))
        onp.testing.assert_array_equal(b.data[0].asnumpy()[0].transpose(
            1, 2, 0), img[:, :, ::-1])


def test_image_iter_and_augmenters_match_jax(tmp_path):
    """``ImageIter`` over image files with ``CreateAugmenter`` (resize,
    random crop, mirror, normalise): the same batches as the JAX
    package's."""
    import cv2
    paths = []
    for i in range(3):
        p = tmp_path / f"im{i}.png"
        cv2.imwrite(str(p), _img_np(30 + 4 * i, 40, seed=i))
        paths.append(p.name)
    imglist = [(float(i), p) for i, p in enumerate(paths)]
    kw = dict(resize=36, rand_crop=True, rand_mirror=True, mean=True,
              std=True)
    pyrandom.seed(5)
    b = next(image.ImageIter(3, (3, 24, 24), imglist=imglist,
                             path_root=str(tmp_path), shuffle=True, **kw))
    pyrandom.seed(5)
    jb = next(jimage.ImageIter(3, (3, 24, 24), imglist=imglist,
                               path_root=str(tmp_path), shuffle=True, **kw))
    assert b.data[0].shape == (3, 3, 24, 24)
    onp.testing.assert_allclose(b.data[0].asnumpy(), jb.data[0].asnumpy(),
                                rtol=1e-6, atol=1e-5)
    onp.testing.assert_array_equal(b.label[0].asnumpy(),
                                   jb.label[0].asnumpy())
