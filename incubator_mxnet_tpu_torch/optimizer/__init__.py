"""Optimizers of the port (JAX counterpart: ``optimizer/``)."""
from .optimizer import Adam, AdamW, Optimizer, create, register  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW", "create", "register"]
