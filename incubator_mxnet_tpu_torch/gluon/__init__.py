"""Gluon pieces of the port (JAX counterpart: ``gluon/``). The training
slice carries the loss the BERT pretraining step uses."""
from . import loss  # noqa: F401
