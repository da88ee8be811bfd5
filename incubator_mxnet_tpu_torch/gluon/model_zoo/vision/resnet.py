"""ResNet v1 and v2 (JAX counterpart: ``gluon/model_zoo/vision/resnet.py``,
the backbone of ``bench.py``'s ResNet-50 workload).

v1 is post-activation (conv-BN-relu, the shortcut added before the last
relu); v2 is pre-activation (BN-relu-conv). The block and channel tables
and the parameter names are the reference's, so converted weights and
``.params`` files line up name for name. :func:`resnet_sharding_rules` is
the JAX package's channel-parallel table for ``parallel.ShardedTrainer``.
"""
from __future__ import annotations

from ...block import HybridBlock
from .... import nn

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2", "resnet_sharding_rules"]


def _conv3x3(channels, stride, in_channels, prefix):
    """3x3 convolution, padding 1, no bias."""
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, prefix=prefix)


class BasicBlockV1(HybridBlock):
    """Two 3x3 conv-BN pairs and the shortcut, then relu (JAX counterpart:
    ``resnet.py:24``)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(_conv3x3(channels, stride, in_channels, "conv1_"))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(_conv3x3(channels, 1, channels, "conv2_"))
            self.body.add(nn.BatchNorm())
            if downsample:
                self.downsample = nn.HybridSequential(prefix="down_")
                self.downsample.add(nn.Conv2D(channels, 1, strides=stride,
                                              use_bias=False,
                                              in_channels=in_channels))
                self.downsample.add(nn.BatchNorm())
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.body(x) + residual)


class BottleneckV1(HybridBlock):
    """1x1 (stride), 3x3, 1x1 conv-BN with a 4x bottleneck and the
    shortcut, then relu (JAX counterpart: ``resnet.py:48``)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(channels // 4, 1, strides=stride,
                                    use_bias=False))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(_conv3x3(channels // 4, 1, channels // 4, "conv2_"))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(channels, 1, use_bias=False))
            self.body.add(nn.BatchNorm())
            if downsample:
                self.downsample = nn.HybridSequential(prefix="down_")
                self.downsample.add(nn.Conv2D(channels, 1, strides=stride,
                                              use_bias=False,
                                              in_channels=in_channels))
                self.downsample.add(nn.BatchNorm())
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.body(x) + residual)


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block (JAX counterpart: ``resnet.py:76``)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.bn1 = nn.BatchNorm()
            self.conv1 = _conv3x3(channels, stride, in_channels, "conv1_")
            self.bn2 = nn.BatchNorm()
            self.conv2 = _conv3x3(channels, 1, channels, "conv2_")
            self.downsample = nn.Conv2D(channels, 1, strides=stride,
                                        use_bias=False,
                                        in_channels=in_channels,
                                        prefix="down_") if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(F.relu(self.bn2(x)))
        return x + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck (JAX counterpart: ``resnet.py:99``)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.bn1 = nn.BatchNorm()
            self.conv1 = nn.Conv2D(channels // 4, 1, use_bias=False)
            self.bn2 = nn.BatchNorm()
            self.conv2 = _conv3x3(channels // 4, stride, channels // 4,
                                  "conv2_")
            self.bn3 = nn.BatchNorm()
            self.conv3 = nn.Conv2D(channels, 1, use_bias=False)
            self.downsample = nn.Conv2D(channels, 1, strides=stride,
                                        use_bias=False,
                                        in_channels=in_channels,
                                        prefix="down_") if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(F.relu(self.bn2(x)))
        x = self.conv3(F.relu(self.bn3(x)))
        return x + residual


#: num_layers -> (block_type, layers-per-stage, stage channels)
RESNET_SPEC = {
    18: ("basic", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


class ResNetV1(HybridBlock):
    """Stem (7x7/2 conv, BN, relu, 3x3/2 max pool; a 3x3 conv for
    ``thumbnail``), four stages, global average pool, Dense (JAX
    counterpart: ``resnet.py:135``)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, "conv0_"))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                stage = nn.HybridSequential(prefix=f"stage{i + 1}_")
                with stage.name_scope():
                    stage.add(block(channels[i + 1], stride,
                                    channels[i + 1] != channels[i],
                                    in_channels=channels[i]))
                    for _ in range(num_layer - 1):
                        stage.add(block(channels[i + 1], 1, False,
                                        in_channels=channels[i + 1]))
                self.features.add(stage)
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """Pre-activation ResNet: a BN on the input, the stem, four stages, a
    final BN-relu, global average pool, Dense (JAX counterpart:
    ``resnet.py:167``)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, "conv0_"))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                stage = nn.HybridSequential(prefix=f"stage{i + 1}_")
                with stage.name_scope():
                    stage.add(block(channels[i + 1], stride,
                                    channels[i + 1] != in_channels,
                                    in_channels=in_channels))
                    for _ in range(num_layer - 1):
                        stage.add(block(channels[i + 1], 1, False,
                                        in_channels=channels[i + 1]))
                self.features.add(stage)
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


_BLOCKS = {1: {"basic": BasicBlockV1, "bottle": BottleneckV1},
           2: {"basic": BasicBlockV2, "bottle": BottleneckV2}}
_NETS = {1: ResNetV1, 2: ResNetV2}


def get_resnet(version: int, num_layers: int, pretrained: bool = False,
               **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` layers (JAX
    counterpart: ``resnet.py:209``); ``pretrained`` weights are not
    downloaded."""
    if pretrained:
        raise ValueError("pretrained weights need network access; use "
                         "load_parameters with a converted .params file")
    btype, layers, channels = RESNET_SPEC[num_layers]
    return _NETS[version](_BLOCKS[version][btype], layers, channels, **kwargs)


def resnet18_v1(**kw):
    """resnet18_v1 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    """resnet34_v1 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    """resnet50_v1 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    """resnet101_v1 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    """resnet152_v1 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(1, 152, **kw)


def resnet18_v2(**kw):
    """resnet18_v2 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(2, 18, **kw)


def resnet34_v2(**kw):
    """resnet34_v2 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(2, 34, **kw)


def resnet50_v2(**kw):
    """resnet50_v2 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(2, 50, **kw)


def resnet101_v2(**kw):
    """resnet101_v2 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(2, 101, **kw)


def resnet152_v2(**kw):
    """resnet152_v2 (JAX counterpart: ``resnet.py:228-265``)."""
    return get_resnet(2, 152, **kw)


def resnet_sharding_rules(extra=()):
    """Channel-parallel ``tp`` rules (JAX counterpart: ``resnet.py:218``):
    conv weights (O, I, kh, kw) split their output channels, dense weights
    their input dim; BatchNorm stays replicated."""
    from ....parallel.sharding import P, ShardingRules
    return ShardingRules(list(extra) + [
        (r".*conv.*weight", P("tp", None, None, None)),
        (r".*dense.*weight", P(None, "tp")),
    ])
