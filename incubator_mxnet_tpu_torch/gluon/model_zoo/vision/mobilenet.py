"""MobileNet v1 and v2 (JAX counterpart:
``gluon/model_zoo/vision/mobilenet.py``).

Depthwise convolutions are grouped ``Conv2D``s (``groups=channels``). As
in the JAX file, every activation is ``relu`` where upstream MXNet has
``relu6`` on v2. The layer tables and parameter names are the
reference's.
"""
from __future__ import annotations

from ...block import HybridBlock
from .... import nn

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


def _add_conv(out, channels, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.Activation("relu"))  # relu for relu6, as the reference


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class MobileNet(HybridBlock):
    """MobileNet v1 at width ``multiplier`` (JAX counterpart:
    ``mobilenet.py:29``)."""

    def __init__(self, multiplier=1.0, classes=1000, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                           + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6
                        + [1024] * 2]
            strides = [1, 2] * 3 + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dwc, c, s)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class _LinearBottleneck(HybridBlock):
    """1x1 expansion, 3x3 depthwise, 1x1 linear projection, and the
    shortcut where shapes allow."""

    def __init__(self, in_channels, channels, t, stride, **kw):
        super().__init__(**kw)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True)
            _add_conv(self.out, in_channels * t, 3, stride, 1,
                      num_group=in_channels * t, relu6=True)
            _add_conv(self.out, channels, active=False)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNetV2(HybridBlock):
    """MobileNet v2 at width ``multiplier`` (JAX counterpart:
    ``mobilenet.py:74``)."""

    def __init__(self, multiplier=1.0, classes=1000, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1,
                      relu6=True)
            in_c = [int(multiplier * x) for x in
                    [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                    + [160] * 3]
            channels = [int(multiplier * x) for x in
                        [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                        + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
            for ic, c, t, s in zip(in_c, channels, ts, strides):
                self.features.add(_LinearBottleneck(ic, c, t, s))
            last = int(1280 * multiplier) if multiplier > 1.0 else 1280
            _add_conv(self.features, last, relu6=True)
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            self.output.add(nn.Conv2D(classes, 1, use_bias=False))
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _mk(cls, multiplier, pretrained=False, **kw):
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load a "
                         ".params file instead")
    return cls(multiplier, **kw)


def mobilenet1_0(**kw):
    return _mk(MobileNet, 1.0, **kw)


def mobilenet0_75(**kw):
    return _mk(MobileNet, 0.75, **kw)


def mobilenet0_5(**kw):
    return _mk(MobileNet, 0.5, **kw)


def mobilenet0_25(**kw):
    return _mk(MobileNet, 0.25, **kw)


def mobilenet_v2_1_0(**kw):
    return _mk(MobileNetV2, 1.0, **kw)


def mobilenet_v2_0_75(**kw):
    return _mk(MobileNetV2, 0.75, **kw)


def mobilenet_v2_0_5(**kw):
    return _mk(MobileNetV2, 0.5, **kw)


def mobilenet_v2_0_25(**kw):
    return _mk(MobileNetV2, 0.25, **kw)
