"""Gluon of the port (JAX counterpart: ``gluon/``): ``Parameter``,
``ParameterDict``, ``Block``, ``HybridBlock``, ``Trainer``, ``nn``,
``loss``, ``rnn``, ``utils``, ``model_zoo``, ``contrib`` and ``data``."""
from .parameter import (  # noqa: F401
    Constant, DeferredInitializationError, Parameter, ParameterDict,
)
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import loss  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import utils  # noqa: F401
from . import model_zoo  # noqa: F401
from . import contrib  # noqa: F401
from . import data  # noqa: F401

__all__ = ["Constant", "DeferredInitializationError", "Parameter",
           "ParameterDict", "Block", "HybridBlock", "Trainer", "loss", "nn",
           "rnn", "utils", "model_zoo", "contrib", "data"]
