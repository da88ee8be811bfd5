"""Layers of the port (JAX counterpart: ``gluon/nn/``); ``gluon.nn`` is
this module under its Gluon name."""
from ..gluon.block import Block, HybridBlock  # noqa: F401
from .basic_layers import (  # noqa: F401
    Activation, Dense, Dropout, Embedding, HybridSequential, LayerNorm,
    Sequential, set_dropout_generator,
)

__all__ = ["Block", "HybridBlock", "Activation", "Dense", "Dropout",
           "Embedding", "HybridSequential", "LayerNorm", "Sequential",
           "set_dropout_generator"]
