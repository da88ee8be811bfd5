"""``gluon.nn``: the layers of :mod:`incubator_mxnet_tpu_torch.nn`, under
their Gluon name (JAX counterpart: ``gluon/nn/``)."""
from ...nn import *  # noqa: F401,F403
from ...nn import __all__  # noqa: F401
