"""``mx.npx``: the numpy-extension ops.

Counterpart: the JAX package's ``numpy_extension.py``: the operator-style
ops that NumPy lacks (``softmax``, ``log_softmax``, ``relu``, ``sigmoid``,
``batch_norm``, ``fully_connected``, ``convolution``, ``pooling``,
``one_hot``, ``pick``, ``topk``), ``waitall``, ``seed`` and the
``set_np``/``reset_np`` switches of :mod:`.util`, over the port's ``mx.nd``.
"""
from __future__ import annotations

from . import ndarray as _nd
from .util import is_np_array, is_np_shape, reset_np, set_np  # noqa: F401

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape", "softmax",
           "log_softmax", "relu", "sigmoid", "batch_norm", "fully_connected",
           "convolution", "pooling", "one_hot", "pick", "topk", "waitall",
           "seed"]

softmax = _nd.softmax
log_softmax = _nd.log_softmax
relu = _nd.relu
sigmoid = _nd.sigmoid
batch_norm = _nd.BatchNorm
fully_connected = _nd.FullyConnected
convolution = _nd.Convolution
pooling = _nd.Pooling
one_hot = _nd.one_hot
pick = _nd.pick
topk = _nd.topk
waitall = _nd.waitall


def seed(s):
    from . import random as random_mod
    random_mod.seed(int(s))
