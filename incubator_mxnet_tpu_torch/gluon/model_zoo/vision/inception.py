"""Inception V3 (JAX counterpart: ``gluon/model_zoo/vision/inception.py``).

The reference's blocks (A: 35x35, B: grid reduction, C: 17x17 with
factorised 7x7 convolutions, D: reduction, E: 8x8 with split 3x3
branches), NCHW, 299x299 input. Every branch is conv-BN-ReLU; parallel
branches are ``gluon.contrib.nn.HybridConcurrent`` on the channel axis.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...contrib.nn import HybridConcurrent
from .... import nn

__all__ = ["Inception3", "inception_v3"]


def _conv(out_channels, kernel, stride=1, padding=0):
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(out_channels, kernel, stride, padding, use_bias=False))
    seq.add(nn.BatchNorm(epsilon=0.001))
    seq.add(nn.Activation("relu"))
    return seq


def _branch(*convs):
    seq = nn.HybridSequential(prefix="")
    for args in convs:
        if args[0] == "pool_avg":
            seq.add(nn.AvgPool2D(3, 1, 1))
        elif args[0] == "pool_max":
            seq.add(nn.MaxPool2D(3, 2))
        else:
            seq.add(_conv(*args))
    return seq


def _concurrent():
    return HybridConcurrent(axis=1)


def _inception_a(pool_features):
    out = _concurrent()
    out.add(_branch((64, 1)))
    out.add(_branch((48, 1), (64, 5, 1, 2)))
    out.add(_branch((64, 1), (96, 3, 1, 1), (96, 3, 1, 1)))
    out.add(_branch(("pool_avg",), (pool_features, 1)))
    return out


def _inception_b():
    out = _concurrent()
    out.add(_branch((384, 3, 2)))
    out.add(_branch((64, 1), (96, 3, 1, 1), (96, 3, 2)))
    out.add(_branch(("pool_max",)))
    return out


def _inception_c(channels_7x7):
    c = channels_7x7
    out = _concurrent()
    out.add(_branch((192, 1)))
    out.add(_branch((c, 1), (c, (1, 7), 1, (0, 3)),
                    (192, (7, 1), 1, (3, 0))))
    out.add(_branch((c, 1), (c, (7, 1), 1, (3, 0)), (c, (1, 7), 1, (0, 3)),
                    (c, (7, 1), 1, (3, 0)), (192, (1, 7), 1, (0, 3))))
    out.add(_branch(("pool_avg",), (192, 1)))
    return out


def _inception_d():
    out = _concurrent()
    out.add(_branch((192, 1), (320, 3, 2)))
    out.add(_branch((192, 1), (192, (1, 7), 1, (0, 3)),
                    (192, (7, 1), 1, (3, 0)), (192, 3, 2)))
    out.add(_branch(("pool_max",)))
    return out


class _SplitBranch(HybridBlock):
    """A stem, then two parallel heads concatenated (the E block's 3x3
    split)."""

    def __init__(self, stem, heads, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.stem = stem
            self.heads = _concurrent()
            for h in heads:
                self.heads.add(h)

    def hybrid_forward(self, F, x):
        return self.heads(self.stem(x))


def _inception_e():
    out = _concurrent()
    out.add(_branch((320, 1)))
    out.add(_SplitBranch(
        _branch((384, 1)),
        [_branch((384, (1, 3), 1, (0, 1))),
         _branch((384, (3, 1), 1, (1, 0)))]))
    out.add(_SplitBranch(
        _branch((448, 1), (384, 3, 1, 1)),
        [_branch((384, (1, 3), 1, (0, 1))),
         _branch((384, (3, 1), 1, (1, 0)))]))
    out.add(_branch(("pool_avg",), (192, 1)))
    return out


class Inception3(HybridBlock):
    """Inception V3 at 299x299 input."""

    def __init__(self, classes=1000, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_conv(32, 3, 2))
            self.features.add(_conv(32, 3))
            self.features.add(_conv(64, 3, 1, 1))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_conv(80, 1))
            self.features.add(_conv(192, 3))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_inception_a(32))
            self.features.add(_inception_a(64))
            self.features.add(_inception_a(64))
            self.features.add(_inception_b())
            self.features.add(_inception_c(128))
            self.features.add(_inception_c(160))
            self.features.add(_inception_c(160))
            self.features.add(_inception_c(192))
            self.features.add(_inception_d())
            self.features.add(_inception_e())
            self.features.add(_inception_e())
            self.features.add(nn.AvgPool2D(8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(F.flatten(x))


def inception_v3(pretrained=False, **kw):
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load a "
                         ".params file instead")
    return Inception3(**kw)
