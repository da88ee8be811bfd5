"""Optimizers of the port (JAX counterpart: ``optimizer/``)."""
from .optimizer import (  # noqa: F401
    DCASGD, FTML, FTRL, LAMB, LARS, NAG, SGD, SGLD, AdaDelta, AdaGrad, Adam,
    Adamax, AdamW, Ftrl, Nadam, Optimizer, RMSProp, Signum, Updater, create,
    get_updater, register, update_groups,
)
from .optimizer import __all__  # noqa: F401
