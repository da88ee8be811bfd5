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
(continuous batching); and detection: the ops of ``ops/detection.py``
(``mx.nd`` and ``contrib.nd``), ``models.SSD`` and ``models.FasterRCNN``
with their losses and example loops (``bench`` runs ``bench.py``'s
``ssd`` and ``frcnn`` workloads), and ``mx.image``'s augmenters and
``ImageDetIter``; and mixed precision and int8: ``amp.init("bfloat16")``
casting the inputs of the matmul-class ops of ``mx.nd`` (the flash
kernels then run in bf16), and ``quantization`` (calibration,
``quantize_net``, ``quantize_model``) on the int8 ops of
``ops/quantization.py`` (``torch._int_mm`` on the card); and the op
surface: every op of the JAX registry, in one registry
(``ops/registry.py``; ``ops/tensor.py``, ``ops/nn.py``, ``ops/vision.py``)
that ``mx.nd``, ``F`` and ``amp.init`` read, the samplers of
``mx.nd.random``, ``mx.waitall``, and the whole vision model zoo
(MobileNet, AlexNet, VGG, SqueezeNet, DenseNet, Inception, ResNet);
and fault tolerance: ``mx.fault`` (checkpoints in the JAX package's
layout, ``StepGuard``, ``Watchdog``, retry, seeded chaos), resumable
``ShardedTrainer`` and ``gluon.Trainer``, and ``ShardedTrainer``'s guarded
fused step; and data: ``recordio`` and ``native`` (the C++ shim built
with ``g++`` at first use), the rest of ``mx.io`` (``ImageRecordIter``,
``PrefetchIter`` placing batches on a stream of its own), ``gluon.data``
(datasets, samplers, transforms, the multi-worker ``DataLoader`` over
shared memory) and ``tools.im2rec``; and the serving tier; and the
symbolic API: ``mx.sym`` (``Symbol``, ``Executor`` replaying CUDA graphs
on the card), ``mx.name``, ``mx.AttrScope``, ``mx.module.Module`` with
``fit``, ``mx.model``, ``mx.callback``, ``mx.monitor`` and ``mx.viz``;
and the deploy path: ``HybridBlock.export`` (``torch.export`` programs
with the flash forward as the op ``mxtpu::flash_attention_fwd``),
``gluon.SymbolBlock``, ``mx.subgraph`` and ``optimize_for``, and serving
from an artifact (``serve.export_for_serving``, ``serve.ArtifactCache``);
and several ranks: ``parallel.dist`` (one process per rank over
``torch.distributed``: NCCL on the card, gloo on the CPU), meshes,
sharding rules and collectives, ring attention over ``sp`` on the flash
kernels (``ops.cuda.flash_attention.flash_block``), ``ShardedTrainer``
over a mesh (rule-sharded parameters, ZeRO-1, checkpoints in the
multi-host layout), ``mx.kv`` and the kvstore seams of ``gluon.Trainer``
and ``Module``; and the rest of the surface: control flow
(``contrib.nd``/``contrib.sym`` ``foreach``, ``while_loop``, ``cond``),
``mx.operator`` and ``mx.nd.Custom``, the ``interleaved_matmul_*`` ops,
``nd.sparse``, ``mx.np``, ``mx.npx``, ``mx.util``'s numpy switches,
``mx.test_utils``, ``mx.runtime``, ``mx.profiler`` (over
``torch.profiler``) and ``mx.autotune`` (the flash tiles the trainer and
``serve.CompiledModel`` apply).
"""
from .base import MXNetError  # noqa: F401
from .context import (  # noqa: F401
    Context, cpu, cpu_pinned, cpu_shared, current_context, gpu,
    gpu_memory_info, memory_stats, num_gpus, resolve_device,
)
from . import (  # noqa: F401
    autograd, engine, random, ndarray, initializer, gluon, ops, nn, models, serve,
    convert, optimizer, parallel, lr_scheduler, metric, io, contrib, image,
    amp, quantization, fault, lockcheck, native, recordio,
)
from . import (  # noqa: F401
    name, attribute, symbol, model, callback, module, monitor, visualization,
    subgraph,
)
from .attribute import AttrScope  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import (  # noqa: F401
    operator, profiler, autotune, runtime, test_utils, util, numpy_extension,
)
from . import numpy as np  # noqa: F401

from .engine import waitall  # noqa: F401
from .ndarray import NDArray  # noqa: F401

nd = ndarray
init = initializer
sym = symbol
viz = visualization
npx = numpy_extension

__all__ = ["MXNetError", "Context", "cpu", "gpu", "cpu_pinned",
           "cpu_shared", "current_context", "num_gpus", "gpu_memory_info",
           "memory_stats", "resolve_device", "waitall", "NDArray", "engine", "autograd", "random", "ndarray",
           "nd", "initializer", "init", "gluon", "ops", "nn", "models",
           "serve", "convert", "optimizer", "parallel", "lr_scheduler",
           "metric", "io", "contrib", "image", "amp", "quantization",
           "fault", "lockcheck", "native", "recordio", "name", "attribute",
           "AttrScope", "symbol", "sym", "model", "callback", "module",
           "monitor", "visualization", "viz", "subgraph", "operator",
           "profiler", "autotune", "runtime", "test_utils", "util", "np",
           "npx", "numpy_extension"]
