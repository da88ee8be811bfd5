"""Optimizers of the port (JAX counterpart: ``optimizer/``)."""
from .optimizer import (  # noqa: F401
    SGD, Adam, AdamW, Optimizer, Updater, create, get_updater, register,
    update_groups,
)

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Updater", "create",
           "get_updater", "register", "update_groups"]
