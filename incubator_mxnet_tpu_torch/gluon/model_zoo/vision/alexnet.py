"""AlexNet (JAX counterpart: ``gluon/model_zoo/vision/alexnet.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from .... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """Five convolutions (ReLU, three max pools) and three Dense layers
    with dropout."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(192, 5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(384, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; load a "
                         ".params file instead")
    return AlexNet(**kwargs)
