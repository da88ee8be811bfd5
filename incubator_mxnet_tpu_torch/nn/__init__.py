"""Layers of the port (JAX counterpart: ``gluon/nn/``)."""
from .basic_layers import (  # noqa: F401
    Activation, Dense, Dropout, Embedding, LayerNorm, set_dropout_generator,
)
