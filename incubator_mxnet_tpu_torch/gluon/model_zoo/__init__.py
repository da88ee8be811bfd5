"""Model zoo of the port (JAX counterpart: ``gluon/model_zoo/``)."""
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
