"""PyTorch/CUDA port of the JAX package, for NVIDIA Hopper.

The JAX package stays the reference; this package is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and never
``jax``. Entry points run on the card (``device="cuda"``, context
``gpu(0)``) unless the caller asks for the CPU.

``import incubator_mxnet_tpu_torch as mx`` reads like the JAX package
imported as ``mx``: ``mx.nd``, ``mx.autograd``,
``mx.gluon``, ``mx.random``, ``mx.init``, ``mx.cpu()``/``mx.gpu()``. The
slices so far: serving BERT (``models.get_bert`` → ``serve.CompiledModel``
→ ``serve.DynamicBatcher``) on the hand-written flash-attention forward
kernel (``ops/cuda/flash_attention.py``, ``csrc/flash_attention_fwd.cu``);
training it with ``parallel.ShardedTrainer`` (``bench`` runs ``bench.py``'s
workload), each attention backward on the dK/dV and dQ kernels
(``csrc/flash_attention_bwd_*.cu``); the Gluon loop — ``net.initialize``,
``gluon.Trainer``, ``autograd.record()``, ``loss.backward()``,
``trainer.step`` and ``.params`` files shared with the JAX package; and the
fused step: ``ShardedTrainer`` replays one CUDA graph per step
(``fused=``, ``MXTPU_FUSED_STEP``), ``HybridBlock.hybridize()`` replays
captured forward and backward graphs (:mod:`.ops.cuda.graphs`), and both
trainers update every parameter at once (``Optimizer.update_multi``), with
``lr_scheduler`` and the ``mx.nd`` update ops (:mod:`.ops.optimizer_ops`);
and vision: convolution, pooling and BatchNorm (cuDNN through torch, as the
JAX package left them to XLA), ``gluon.nn``'s conv layers, the ResNet
model zoo (``gluon.model_zoo.vision``), ``models.LeNet``, ``mx.io``'s
``NDArrayIter`` and ``mx.metric`` (``bench`` runs ``bench.py``'s
``resnet`` workload too); and Transformer NMT with decode serving:
``models.NMTModel`` trained on the kernels' causal and cross-attention
paths, ``models.beam_search``, and ``serve.DecodeEngine`` (paged KV cache,
the decode step as one CUDA graph) under ``serve.DecodeBatcher``
(continuous batching).
"""
from .base import MXNetError  # noqa: F401
from .context import (  # noqa: F401
    Context, cpu, current_context, gpu, num_gpus, resolve_device,
)
from . import (  # noqa: F401
    autograd, random, ndarray, initializer, gluon, ops, nn, models, serve,
    convert, optimizer, parallel, lr_scheduler, metric, io,
)

nd = ndarray
init = initializer

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "resolve_device", "autograd", "random", "ndarray",
           "nd", "initializer", "init", "gluon", "ops", "nn", "models",
           "serve", "convert", "optimizer", "parallel", "lr_scheduler",
           "metric", "io"]
