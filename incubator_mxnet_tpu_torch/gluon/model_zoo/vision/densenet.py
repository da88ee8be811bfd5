"""DenseNet 121/161/169/201 (JAX counterpart:
``gluon/model_zoo/vision/densenet.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from .... import nn

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]

_SPEC = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


class _DenseLayer(HybridBlock):
    """BN-ReLU-1x1 conv, BN-ReLU-3x3 conv, the output concatenated to the
    input."""

    def __init__(self, growth_rate, bn_size, dropout, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.bn1 = nn.BatchNorm()
            self.conv1 = nn.Conv2D(bn_size * growth_rate, 1, use_bias=False)
            self.bn2 = nn.BatchNorm()
            self.conv2 = nn.Conv2D(growth_rate, 3, padding=1, use_bias=False)
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return F.concat(x, out, dim=1)


class DenseNet(HybridBlock):
    """Dense stages joined by BN-ReLU-1x1 conv-avg pool transitions."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, 7, 2, 3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                stage = nn.HybridSequential(prefix=f"stage{i + 1}_")
                with stage.name_scope():
                    for _ in range(num_layers):
                        stage.add(_DenseLayer(growth_rate, bn_size, dropout))
                self.features.add(stage)
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                    self.features.add(nn.Conv2D(num_features // 2, 1,
                                                use_bias=False))
                    self.features.add(nn.AvgPool2D(2, 2))
                    num_features //= 2
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _densenet(n, pretrained=False, **kw):
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load a "
                         ".params file instead")
    init_f, growth, cfg = _SPEC[n]
    return DenseNet(init_f, growth, cfg, **kw)


def densenet121(**kw):
    return _densenet(121, **kw)


def densenet161(**kw):
    return _densenet(161, **kw)


def densenet169(**kw):
    return _densenet(169, **kw)


def densenet201(**kw):
    return _densenet(201, **kw)
