"""Serving runtime of the port (JAX counterpart: ``serve/``).

========================  ==============================================
:class:`BucketTable`      powers-of-two padded shape buckets per axis
:class:`CompiledModel`    bucketed inference; on the card one CUDA graph
                          per bucket, captured at ``warmup()``; the
                          counters make "zero post-warmup compiles" an
                          assertable contract
:class:`DynamicBatcher`   deadline-bounded coalescing of single requests
                          into bucket batches; bounded-queue backpressure
:class:`ModelRegistry`    versioned multi-model load and unload on
                          ``fault.checkpoint`` and ``fault.retry``; a
                          failed load never disturbs the serving version
:class:`Server`           in-process and JSON-lines TCP front end (the
                          JAX package's wire protocol)
:class:`Replica`          one independent worker (a private registry and
                          batchers); crash and restart lifecycle, the
                          restart from the artifact cache
:class:`ArtifactCache`    CRC-checked on-disk cache of exported bundles
                          (``export_for_serving``); a corrupt entry is
                          evicted and served as a miss
:class:`Router`           health-checked failover routing, retries and
                          hedging, admission control and load shedding,
                          the training-to-serving weight pipe
:class:`DecodeEngine`     generation: a bucketed prefill and one captured
                          decode step over a paged KV cache
                          (``serve.decode``)
:class:`DecodeBatcher`    continuous batching at token boundaries,
                          streaming through :class:`TokenStream`
========================  ==============================================

Minimal end to end::

    table = serve.BucketTable({"batch": (1, 8), "seq": (8, 512)})
    reg = serve.ModelRegistry()
    reg.load("bert", table=table, input_axes=spec["input_axes"],
             factory=make_bert, output_axes=spec["output_axes"])
    srv = serve.Server(reg).start()     # TCP on srv.port
    serve.client_call("127.0.0.1", srv.port,
                      {"model": "bert", "inputs": [ids, types, [n]]})

From an artifact, no Python model at serving time::

    serve.export_for_serving(net, "deploy/bert", table, spec["input_axes"])
    reg.load("bert", table=table, input_axes=spec["input_axes"],
             artifacts="deploy/bert", output_axes=spec["output_axes"])
"""
from .batcher import (  # noqa: F401
    DynamicBatcher, QueueFullError, ServeFuture, make_registry_batcher,
    stack_examples,
)
from .buckets import BucketOverflow, BucketTable, round_up_pow2  # noqa: F401
from .artifact_cache import (ArtifactCache,  # noqa: F401
                             ArtifactCorruptError, signature_key)
from .compiled import CompiledModel, export_for_serving  # noqa: F401
from .metrics import ServeMetrics  # noqa: F401
from .registry import (ModelRegistry, ModelVersion,  # noqa: F401
                       apply_weights, map_checkpoint_arrays)
from .server import Server, client_call, client_generate  # noqa: F401
from .replica import Replica, ReplicaCrashed, ReplicaUnavailable  # noqa: F401
from .router import (DeadlineExceeded, ReplicaSet,  # noqa: F401
                     Router, ShedError, TokenRateBudget)
from . import decode  # noqa: F401
from .decode import (  # noqa: F401
    BlockPool, CacheExhausted, DecodeBatcher, DecodeEngine, DecodeMetrics,
    TokenStream,
)

__all__ = ["BucketTable", "BucketOverflow", "round_up_pow2",
           "CompiledModel", "export_for_serving",
           "ArtifactCache", "ArtifactCorruptError", "signature_key",
           "DynamicBatcher", "QueueFullError", "ServeFuture",
           "ServeMetrics", "ModelRegistry", "ModelVersion",
           "apply_weights", "map_checkpoint_arrays",
           "Server", "client_call", "client_generate",
           "Replica", "ReplicaUnavailable", "ReplicaCrashed",
           "Router", "ReplicaSet", "ShedError", "DeadlineExceeded",
           "TokenRateBudget",
           "DecodeEngine", "DecodeBatcher", "TokenStream", "BlockPool",
           "CacheExhausted", "DecodeMetrics"]
