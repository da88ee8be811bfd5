"""Trainers of the port (JAX counterpart: ``parallel/``). This
slice carries the single-device subset of ``ShardedTrainer``."""
from .trainer import ShardedTrainer  # noqa: F401

__all__ = ["ShardedTrainer"]
