"""``gluon.data``: datasets, samplers and the ``DataLoader`` (JAX
counterpart: ``gluon/data/``, which imports no JAX; the port keeps its own
copy). Samples stay host (numpy) arrays until the ``DataLoader`` hands a
batch to the consumer."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
