"""``gluon.contrib`` of the port (JAX counterpart: ``gluon/contrib/``):
the parallel-branch layers and ``SparseEmbedding`` of :mod:`.nn`, the
experimental cells of :mod:`.rnn`, the ``Estimator`` fit loop of
:mod:`.estimator`, and ``SyncBatchNorm``."""
from ...nn import SyncBatchNorm  # noqa: F401
from . import estimator  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from .estimator import Estimator  # noqa: F401

__all__ = ["SyncBatchNorm", "estimator", "nn", "rnn", "Estimator"]
