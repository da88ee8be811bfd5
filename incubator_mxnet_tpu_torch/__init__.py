"""PyTorch/CUDA port of the JAX package, for NVIDIA Hopper.

The JAX package stays the reference; this package is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and never
``jax``. Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``.

The first slice serves BERT: ``models.get_bert`` → ``serve.CompiledModel``
over a ``serve.BucketTable`` → ``serve.DynamicBatcher``, with every
attention call on the hand-written flash-attention forward kernel
(``ops/cuda/flash_attention.py``, ``csrc/flash_attention_fwd.cu``). The
second trains it: ``parallel.ShardedTrainer`` with
``models.bert_pretrain_loss`` and ``optimizer.AdamW``, each attention
backward on the dK/dV and dQ kernels (``csrc/flash_attention_bwd_*.cu``);
``bench`` runs ``bench.py``'s BERT pretraining workload.
"""
from .base import MXNetError  # noqa: F401
from .context import resolve_device  # noqa: F401
from . import (  # noqa: F401
    ops, nn, initializer, models, serve, convert, gluon, optimizer, parallel,
)

__all__ = ["MXNetError", "resolve_device", "ops", "nn", "initializer",
           "models", "serve", "convert", "gluon", "optimizer", "parallel"]
