"""Serving runtime of the port (JAX counterpart: ``serve/``): bucket table,
bucketed inference, the dynamic batcher, and decode serving
(``serve.decode``: paged KV cache, continuous batching). The registry,
router, replicas and the TCP server come with later slices."""
from .batcher import (  # noqa: F401
    DynamicBatcher, QueueFullError, ServeFuture, stack_examples,
)
from .buckets import BucketOverflow, BucketTable, round_up_pow2  # noqa: F401
from .compiled import CompiledModel  # noqa: F401
from .metrics import ServeMetrics  # noqa: F401
from . import decode  # noqa: F401
from .decode import (  # noqa: F401
    BlockPool, CacheExhausted, DecodeBatcher, DecodeEngine, DecodeMetrics,
    TokenStream,
)
