"""Layers of the port (JAX counterpart: ``gluon/nn/``); ``gluon.nn`` is
this module under its Gluon name."""
from ..gluon.block import Block, HybridBlock  # noqa: F401
from .activations import (  # noqa: F401
    ELU, GELU, LeakyReLU, PReLU, SELU, SiLU, Swish, Activation,
)
from .basic_layers import (  # noqa: F401
    BatchNorm, Dense, Dropout, Embedding, Flatten, GroupNorm, HybridLambda,
    HybridSequential, Identity, InstanceNorm, Lambda, LayerNorm, Sequential,
    SyncBatchNorm, set_dropout_generator,
)
from .conv_layers import *  # noqa: F401,F403
from . import activations, basic_layers, conv_layers

__all__ = (["Block", "HybridBlock"] + activations.__all__
           + basic_layers.__all__ + conv_layers.__all__)
