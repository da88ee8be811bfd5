"""LeNet-5 and the MLP of ``train_mnist.py``: a Gluon ``HybridBlock``, the
symbol-API constructors and the example's loop.

Counterpart: the JAX package's ``models/lenet.py`` (``LeNet`` at ``:16``,
``lenet_symbol`` at ``:37``, ``mlp_symbol`` at ``:57``) and
``examples/train_mnist.py``, whose ``main`` (``:76-105``) is
:func:`mnist_example` here, argument for argument: the same synthetic
blobs (``:52-73``), ``Module.fit`` with SGD momentum 0.9 and a
``Speedometer``, then ``score``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as onp

from ..gluon.block import HybridBlock
from .. import nn

__all__ = ["LeNet", "lenet", "lenet_symbol", "mlp_symbol", "mnist_iters",
           "mnist_example"]


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


def lenet_symbol(classes: int = 10):
    """Module-era LeNet ending in ``SoftmaxOutput`` (JAX counterpart:
    ``models/lenet.py:37``)."""
    from .. import symbol as sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    t1 = sym.Activation(c1, act_type="tanh", name="tanh1")
    p1 = sym.Pooling(t1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                     name="pool1")
    c2 = sym.Convolution(p1, kernel=(5, 5), num_filter=50, name="conv2")
    t2 = sym.Activation(c2, act_type="tanh", name="tanh2")
    p2 = sym.Pooling(t2, pool_type="max", kernel=(2, 2), stride=(2, 2),
                     name="pool2")
    f = sym.flatten(p2, name="flatten")
    fc1 = sym.FullyConnected(f, num_hidden=500, name="fc1")
    t3 = sym.Activation(fc1, act_type="tanh", name="tanh3")
    fc2 = sym.FullyConnected(t3, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                             name="softmax")


def mlp_symbol(classes: int = 10):
    """``train_mnist.py``'s default MLP, 128-64-``classes`` with ReLUs
    (JAX counterpart: ``models/lenet.py:57``)."""
    from .. import symbol as sym
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(sym.flatten(data, name="flat"), num_hidden=128,
                             name="fc1")
    a1 = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(a1, num_hidden=64, name="fc2")
    a2 = sym.Activation(fc2, act_type="relu", name="relu2")
    fc3 = sym.FullyConnected(a2, num_hidden=classes, name="fc3")
    return sym.SoftmaxOutput(fc3, sym.Variable("softmax_label"),
                             name="softmax")


def mnist_iters(batch_size: int, flat: bool, data_dir: Optional[str],
                n: int):
    """``(train, val)`` iterators (JAX counterpart:
    ``examples/train_mnist.py:52``): ``MNISTIter`` over the idx files in
    ``data_dir`` when they exist (``val`` None), else ``n`` samples of 10
    Gaussian blobs in pixel space drawn from ``RandomState(0)``, split
    9:1, the training one shuffled. Arrays land on the current
    context."""
    from .. import io as mio
    img = os.path.join(data_dir or "", "train-images-idx3-ubyte")
    lab = os.path.join(data_dir or "", "train-labels-idx1-ubyte")
    if data_dir and os.path.exists(img) and os.path.exists(lab):
        return (mio.MNISTIter(img, lab, batch_size=batch_size, flat=flat,
                              shuffle=True), None)
    rng = onp.random.RandomState(0)
    protos = rng.rand(10, 28 * 28).astype("float32")
    y = rng.randint(0, 10, n)
    x = protos[y] + 0.15 * rng.randn(n, 28 * 28).astype("float32")
    x = x if flat else x.reshape(n, 1, 28, 28)
    split = int(0.9 * n)
    train = mio.NDArrayIter(x[:split], y[:split].astype("float32"),
                            batch_size=batch_size, shuffle=True)
    val = mio.NDArrayIter(x[split:], y[split:].astype("float32"),
                          batch_size=batch_size)
    return train, val


def mnist_example(network: str = "mlp", num_epochs: int = 5,
                  batch_size: int = 64, lr: float = 0.1,
                  num_synthetic: int = 2000, seed: Optional[int] = None,
                  data_dir: Optional[str] = "data/mnist", ctx=None) -> float:
    """The example's loop on ``ctx`` (default: the current context):
    ``mx.random.seed`` (``seed``, else ``MXNET_TEST_SEED``, else 42), the
    ``mlp`` or ``lenet`` symbol under ``Module.fit`` (SGD, momentum 0.9,
    ``Speedometer(batch_size, 20)``), then the accuracy of ``score`` on the
    held-out split, which it returns."""
    from .. import callback, metric, random
    from ..context import current_context
    from ..module import Module

    if network not in ("mlp", "lenet"):
        raise ValueError(f"network must be 'mlp' or 'lenet', got "
                         f"{network!r}")
    ctx = ctx or current_context()
    random.seed(seed if seed is not None
                else int(os.environ.get("MXNET_TEST_SEED", "42")))
    flat = network == "mlp"
    with ctx:
        train, val = mnist_iters(batch_size, flat, data_dir, num_synthetic)
        mod = Module(mlp_symbol() if flat else lenet_symbol(),
                     data_names=("data",), label_names=("softmax_label",),
                     context=ctx)
        mod.fit(train, eval_data=val, num_epoch=num_epochs,
                optimizer="sgd",
                optimizer_params=(("learning_rate", lr), ("momentum", 0.9)),
                batch_end_callback=callback.Speedometer(batch_size, 20))
        res = mod.score(val if val is not None else train, metric.Accuracy())
    acc = dict(res)["accuracy"]
    print(f"final accuracy: {acc:.4f}")
    return acc
