"""SqueezeNet 1.0 and 1.1 (JAX counterpart:
``gluon/model_zoo/vision/squeezenet.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from .... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    """A 1x1 squeeze, then 1x1 and 3x3 expansions concatenated."""

    def __init__(self, squeeze, expand1x1, expand3x3, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.squeeze = nn.Conv2D(squeeze, 1, activation="relu")
            self.left = nn.Conv2D(expand1x1, 1, activation="relu")
            self.right = nn.Conv2D(expand3x3, 3, padding=1,
                                   activation="relu")

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.left(x), self.right(x), dim=1)


class SqueezeNet(HybridBlock):
    """SqueezeNet ``version`` "1.0" or "1.1"."""

    def __init__(self, version="1.0", classes=1000, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, 7, 2, activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(16, 64), (16, 64), (32, 128)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(32, 128), (48, 192), (48, 192), (64, 256)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, 3, 2, activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(16, 64), (16, 64)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(32, 128), (32, 128)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for s, e in [(48, 192), (48, 192), (64, 256), (64, 256)]:
                    self.features.add(_Fire(s, e, e))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="output_")
            self.output.add(nn.Conv2D(classes, 1, activation="relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, **kw):
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load a "
                         ".params file instead")
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load a "
                         ".params file instead")
    return SqueezeNet("1.1", **kw)
