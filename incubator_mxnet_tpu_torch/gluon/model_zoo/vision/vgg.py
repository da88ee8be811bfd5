"""VGG 11/13/16/19, with or without BatchNorm (JAX counterpart:
``gluon/model_zoo/vision/vgg.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from .... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn"]

_SPEC = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    """Stages of 3x3 convolutions (ReLU, optional BatchNorm), each closed
    by a 2x2 max pool, then three Dense layers with dropout."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for i, num in enumerate(layers):
                for _ in range(num):
                    self.features.add(nn.Conv2D(filters[i], 3, padding=1))
                    if batch_norm:
                        self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(2, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _vgg(n, bn=False, pretrained=False, **kw):
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load a "
                         ".params file instead")
    layers, filters = _SPEC[n]
    return VGG(layers, filters, batch_norm=bn, **kw)


def vgg11(**kw):
    return _vgg(11, **kw)


def vgg13(**kw):
    return _vgg(13, **kw)


def vgg16(**kw):
    return _vgg(16, **kw)


def vgg19(**kw):
    return _vgg(19, **kw)


def vgg11_bn(**kw):
    return _vgg(11, bn=True, **kw)


def vgg13_bn(**kw):
    return _vgg(13, bn=True, **kw)


def vgg16_bn(**kw):
    return _vgg(16, bn=True, **kw)


def vgg19_bn(**kw):
    return _vgg(19, bn=True, **kw)
