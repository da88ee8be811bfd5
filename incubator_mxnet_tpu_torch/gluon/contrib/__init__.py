"""``gluon.contrib`` of the port (JAX counterpart: ``gluon/contrib/``):
the parallel-branch layers of :mod:`.nn`."""
from . import nn  # noqa: F401

__all__ = ["nn"]
