"""LeNet-5, the ``train_mnist.py`` smoke model, as a Gluon ``HybridBlock``
(JAX counterpart: ``models/lenet.py:16-40``). The symbol-API builders
``lenet_symbol``/``mlp_symbol`` come with ``symbol/``."""
from __future__ import annotations

from ..gluon.block import HybridBlock
from .. import nn

__all__ = ["LeNet", "lenet"]


class LeNet(HybridBlock):
    """Two 5x5 conv-tanh-maxpool stages, Dense(500, tanh), Dense(classes)
    (JAX counterpart: ``models/lenet.py:16``)."""

    def __init__(self, classes: int = 10, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(20, kernel_size=5, activation="tanh"))
            self.features.add(nn.MaxPool2D(2, 2))
            self.features.add(nn.Conv2D(50, kernel_size=5, activation="tanh"))
            self.features.add(nn.MaxPool2D(2, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(500, activation="tanh"))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def lenet(**kwargs) -> LeNet:
    """A :class:`LeNet` (JAX counterpart: ``models/lenet.py:35``)."""
    return LeNet(**kwargs)
