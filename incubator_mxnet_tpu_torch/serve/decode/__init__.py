"""``serve.decode``: autoregressive decode serving (JAX counterpart:
``serve/decode/``).

======================  ====================================================
:mod:`.blocks`          paged KV-cache allocator: uniform pages, per-sequence
                        block tables, seat-based admission whose capacity is
                        priced from ``MXTPU_HBM_BUDGET``
:mod:`.engine`          the prefill/decode split: a bucketed prefill
                        ``CompiledModel`` on the flash kernel, and ONE
                        fixed-shape decode step captured as a CUDA graph at
                        ``warmup()`` (pages written in place)
:mod:`.batcher`         continuous batching: requests join and leave the
                        running batch at token boundaries, streaming tokens
                        through :class:`TokenStream`
:mod:`.metrics`         ``DecodeMetrics``: TTFT, ITL, tokens, occupancy
======================  ====================================================
"""
from .blocks import (BlockPool, CacheExhausted, block_bytes,  # noqa: F401
                     blocks_per_sequence, price_capacity)
from .engine import DecodeEngine, PrefillEntry  # noqa: F401
from .batcher import DecodeBatcher, ShedError, TokenStream  # noqa: F401
from .metrics import DecodeMetrics  # noqa: F401

__all__ = [
    "BlockPool", "CacheExhausted", "blocks_per_sequence", "block_bytes",
    "price_capacity", "DecodeEngine", "PrefillEntry", "DecodeBatcher",
    "ShedError", "TokenStream", "DecodeMetrics",
]
