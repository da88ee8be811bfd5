#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run (non-zero exit, no result line):

1. card: name and power limit (``nvidia-smi``); no CUDA device -> error;
2. build: every CUDA kernel of the port from the sources in the checkout,
   one ``nvcc`` per source, all started together;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, in float32 and bfloat16: the forward at every sequence bucket the
   serving path gives it (ragged key mask with an empty row, no mask,
   causal, causal + window), at the training shape with every key valid,
   across lengths, under a key mask that is not a prefix (keys only in the
   middle tile, a row with none), with small tiles, and at the NMT
   training's masked cross-attention shapes (target 112 over source 128,
   128 over 96, 16 heads, a row that sees no key); the two backward
   kernels (dK/dV, dQ) at the training shape and at masked, causal,
   windowed, cross-length (causal, and the NMT masked shapes), ragged and
   small-tile cases; all three, untimed, at the MT gate's shapes (batch
   32, 4 heads of head dim 16: 5 over 5, causal 6 over 6, 6 over 5 with
   and without a key mask) and at the decode serving prefill's (batch 1,
   16 heads, one ragged row of source 128); with per-shape
   times of the kernel (CUDA events, and device time from
   ``torch.profiler``), the plain version, one PyTorch library call as a
   yardstick (SDPA, never used by the port; the forward's by events and
   in device time, the backward's in device time) and the least time the
   card could take (the bound);
4. serve: BERT-base (``bert_12_768_12``, full width and depth, float32,
   seeded random weights) through ``serve.CompiledModel`` over the
   ``{"batch": (1, 32), "seq": (8, 512)}`` bucket table (one CUDA graph
   per bucket, all 42 captured at ``warmup``, none after) and
   ``serve.DynamicBatcher`` (5 ms deadline), fed ragged requests from four
   client threads; the forward kernel must have launched on that run
   (replays counted) and the backward kernels not, and served outputs must
   match unbatched forwards on the plain attention path;
5. profile: one serving forward at the largest bucket, timed with CUDA
   events and split by kernel with ``torch.profiler``;
6. train: the port bench (``incubator_mxnet_tpu_torch/bench.py``, the
   configuration of ``bench.py``'s default workload: BERT-base pretraining
   in bfloat16, dropout 0.1, batch 8, sequence 512, AdamW with fp32 master
   weights) through the fused ``ShardedTrainer`` step (one CUDA-graph
   replay per step, the default) and the eager step, timed in turns:
   each path's step ms, tokens/s, captures, graphs per step and losses;
   the fused path's JSON line; every step's loss finite and the last below
   the first; each of the three kernels launched 12 times per step,
   replays counted; then one step of each split by kernel with
   ``torch.profiler`` (wall ms, device ms, idle share);
7. train gate: the fused step against the eager one on the bench's
   configuration at full width and 2 layers, under
   ``torch.use_deterministic_algorithms``: at dropout 0, 3 steps' losses
   and the weights after them equal to 1e-5 of each parameter's largest
   value; at dropout 0.1, whether the captured masks are the eager ones;
8. train gradients: one step's parameter gradients of a 2-layer BERT at
   full width (float32, dropout 0) on the kernels, against the same step
   on the plain attention path (``MXTPU_ATTN_IMPL=xla``);
9. gluon: the MXNet Gluon loop on the port's ``mx.nd``, ``autograd`` and
   ``gluon.Trainer`` (multi-tensor Adam): BERT-base (float32, dropout 0.1)
   initialised with ``net.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
   force_reinit=True)``, the bench's batch as ``mx.nd`` arrays on the
   card, plain and ``net.hybridize()``-d (CUDA graphs for the forward and
   the backward); 2 warm and 5 timed steps of each of
   ``autograd.record()`` -> ``loss.backward()`` -> ``trainer.step(1)``:
   every loss finite and the last below the first, each kernel launched 12
   times per step; step ms and tokens/s of both in turns with the
   forward/backward/update split, beside ``ShardedTrainer``'s on the same
   model and optimizer; a hybridized (replayed) backward's gradients
   against those ``ShardedTrainer.step`` leaves (2 layers at full width,
   dropout 0); a ``.params`` round trip (``save_parameters`` ->
   ``load_parameters`` into a fresh model) whose forward is bitwise equal,
   and ``save_states`` / ``load_states`` restoring the update count;
10. vision: (a) the port
    bench's ``resnet`` workload at full size (``resnet50_v1``, bfloat16,
    batch 32, 224x224, SGD momentum with fp32 masters) through the fused
    and the eager step, timed in turns: imgs/s, step ms, MFU, the first
    step apart, peak memory, and one profiled step of each with its idle
    share and its device time in cuDNN convolutions, BatchNorm,
    elementwise kernels and the rest; the attention kernels must not
    launch; (b) at resnet18_v1, float32, batch 8, 64x64, under
    deterministic algorithms, the fused step against the eager one: the
    losses, weights and running statistics after 3 steps within 1e-5 of
    each largest value; (c) one step's gradients on the card against the
    CPU's, within 1e-3 of each parameter's largest; (d) the Gluon LeNet
    loop (``io.NDArrayIter``, hybridized, ``gluon.Trainer``,
    ``metric.Accuracy``) on the 8x8 digits, held-out accuracy >= 0.95;
11. nmt train: Transformer-big (Vaswani et al. 2017, Table 3 "big": units
    1024, hidden 4096, 6 + 6 layers, 16 heads; a shared vocabulary of
    37,000; dropout 0.1; seeded Xavier weights) through
    ``ShardedTrainer`` (Adam lr 1e-4, float32, label-smoothed
    cross-entropy, eps 0.1) on 32 pairs of source 128 (valid 32-128) and
    target 112, fused and eager in turns: step ms, target tokens/s, the
    first and warm steps apart, peak memory, a profiled step of each by
    group (GEMMs, flash kernels, elementwise, optimizer); losses finite
    and falling, each kernel 18 launches per step (encoder, causal and
    cross-attention, replays counted); one step's gradients at 2 + 2
    layers on the kernels against ``MXTPU_ATTN_IMPL=xla`` within 1e-3 of
    each parameter's largest, twice: with the plain path's ReLUs taking
    the kernel path's signs, and free on the sequences where no ReLU
    takes another sign in the two paths (the others' loss weighted 0: a
    pre-activation that the two paths round to opposite signs moves its
    token's contribution between the gradients); the share of such
    sign flips among all FFN units at most 1e-5;
12. nmt decode: at full width, a seeded 32-token prefix through
    ``nmt_step`` (contiguous cache), ``nmt_paged_step`` (scattered pages)
    and the full decoder on the kernels, logits within 1e-3 of the largest
    at every position; ``beam_search`` (K = 4, 32 tokens) against
    ``beam_search_reference`` on 4 prompts (sequences, scores and the
    first divergence printed);
13. nmt serve: ``serve.DecodeEngine`` (prompt table batch 1, source
    8-128; 32 rows, pages of 16, 128 tokens) whose decode step is one
    CUDA graph, under ``serve.DecodeBatcher``: 256 seeded requests
    (prompts 8-127, 16-127 new tokens) from 4 threads, then all at once:
    tokens/s, ITL p50/p99, TTFT p50, occupancy, the step's ms replayed
    against eager (CUDA events), the pool and the capacity; every stream
    completes, no capture or first bucket run after warmup, the forward
    kernel launched in prefill and the backward ones not, the capacity
    equal to the pool's admission limit (also under a budget, priced
    again to the same report), and 4 streams' greedy tokens equal to
    ``beam_search(K=1)``'s unless the two tokens' logits are within 1e-3;
14. mt gate: the JAX package's ``examples/machine_translation.py`` loop
    (copy task, 300 steps, vocabulary 12, length 5, batch 32, Adam
    through ``gluon.Trainer``, label smoothing 0.1) on the card, then
    ``beam_search`` (K = 4): exact match above 0.8;
15. detection: (a) the detection ops on the card against the same port
    code on the CPU at full-width shapes: ``multibox_target`` over
    SSD-300's 29,596 anchors with tied negative losses, ``multi_proposal``
    at the frcnn bench's shape (7,056 anchors, top 1000, 128 after NMS,
    tied scores), ``box_nms`` with ``topk=400`` and ``roi_align`` at
    1,056 rois x 128 channels x 7x7 (and its gradient): integer outputs
    equal, floats within stated tolerances; (b) the port bench's ``ssd``
    (batch 16, 300x300) and ``frcnn`` (batch 8, 224x224, 128 rois)
    workloads through the fused and the eager step, timed in turns: imgs/s,
    step ms, first and capture steps, peak memory, one profiled step of
    each split into convolutions, the detection ops' sorts, scatters and
    gathers, elementwise kernels and the optimizer, and its idle share;
    ``SSD.detect`` and ``FasterRCNN.detect`` at those sizes, timed; (c)
    both models' fused step against the eager one at batch 2, 64x64,
    bitwise under deterministic algorithms; (d) one step's gradients on
    the card against the CPU's within 1e-3; (e) the JAX package's two
    detection examples on the card (SSD 150 steps above 0.8, Faster-RCNN
    400 steps above 0.25); the attention kernels launch on none of it;
16. int8 serve (after the profile, on phase 4's model): calibration with
    ``quantization.observe_net`` on one batch of 32 ragged requests
    (drawn as phase 4 draws, from another seed), ``quantization.
    quantize_model`` into a quantized ``CompiledModel`` over the same
    table, ``warmup`` (a CUDA graph per bucket for each model) and
    ``DynamicBatcher``; the float and int8 models
    serve phase 4's requests in turns (paced, then all at once): every
    request answered, no post-warmup compile, the 48 encoder Dense layers
    and the pooler ``QuantizedDense``, served outputs within 1e-3 of the
    largest of unbatched int8 forwards, the forward kernel launched and
    the backward ones not; layer 0's four products (qkv, proj, ffn1,
    ffn2) at one 512-token request and at 8 rows, the card
    (``torch._int_mm``) against the CPU (int32 ``@``): quantized inputs,
    int32 accumulators and dequantized outputs bitwise equal; printed, not
    gated: the mean relative error against the float model, parameter
    bytes, p50/p99 and throughput, the (32, 512) forward by CUDA events
    and its device time by int8 op (quantize, ``_int_mm``, bias,
    dequantize), the flash kernel and the rest; the ``bert_encoder``
    smoke twin within 0.05 of its float twin (the JAX package's gate);
17. amp: (a) BERT-base at the bench's configuration with float32 weights
    under ``amp.init("bfloat16")``, through the fused and the eager
    ``ShardedTrainer`` step, timed in turns against the same steps
    without AMP: step ms, tokens/s, losses finite and falling, 12
    launches per kernel per step, the dtype of q at the kernels' launch
    wrapper (bf16 under AMP), one profiled step of each by group (flash
    kernels, GEMMs, casts, optimizer, reductions, elementwise) and its
    idle share; (b) at full width and 2 layers, dropout 0, under
    deterministic algorithms, the AMP fused step against the eager one
    over 3 steps, within 1e-5 of each parameter's largest; (c) one AMP
    step's gradients at 2 layers, batch 2x512, on the card against the
    CPU's within 5e-2 of each parameter's largest (bf16 roundings that
    fall on the other side); (d) ResNet-50 v1 (1000 classes, batch 32,
    224x224, float32 weights) through the image-classification example
    loop, hybridized, with ``--amp`` and without, in turns: imgs/s and
    step ms of the last epoch; (e) the example's gate with ``--amp``
    (resnet18_v1, 2 epochs, 4 classes, batch 16): accuracy above 0.5.

18. nd ops: every op of the registry's ``ops/tensor.py``, ``ops/nn.py``
    and ``ops/vision.py`` (194 ops, 267 cases) on the card and on the CPU
    on the same seeded inputs ((64, 4096) float32 for elementwise ops and
    reductions, (32, 30522) with forced ties for ``argmax``/``sort``/
    ``topk``): dtypes and shapes equal, integer and index results equal,
    floats within the family's tolerance (1e-5; special functions and
    linear algebra 1e-4), gradients of the differentiable ones, custom
    gradients included, within 1e-5; each sampler's draws repeated under
    one seed on the card and its mean and variance over 1,000,000 draws
    within 5 standard errors; ``boolean_mask`` and ``bincount`` refuse a
    CUDA graph capture, naming the op;
19. mobilenet: (a) ``mobilenetv2_1.0`` and ``mobilenet1.0`` (1000
    classes, batch 32, 224x224) through the image-classification example
    loop, hybridized, SGD momentum, float32 and ``--amp`` in turns: step ms
    and imgs/s of the last epoch; (b) one hybridized step of v2 under
    ``torch.profiler``, float32 and AMP: device time by group (depthwise
    convolutions, the other convolutions, BatchNorm, elementwise,
    optimizer) and idle share; (c) at mobilenet0.25 (float32, batch 8,
    64x64) the hybridized loop against the eager one under deterministic
    algorithms, 3 steps, within 1e-5, and two eager loops without them
    (printed); (d) one step's gradients at mobilenet0.25 (batch 8, 64x64)
    on the card against the CPU's float64 step: float64 within 1e-9 and
    float32 within 1e-4 of the largest; (e) the
    JAX package's example test (``--model mobilenet0.25 --epochs 2
    --classes 4 --batch-size 16``): accuracy above 0.5;
20. zoo: AlexNet, VGG-11, SqueezeNet 1.1, DenseNet-121 (224x224) and
    Inception v3 (299x299), 1000 classes: the hybridized forward against
    the eager one within 1e-5, and training steps at batch 8 with finite
    losses, timed;
21. lm: an LSTM word language model (``models.word_language_model.
    RNNModel``) at the widths of the reference's PTB "medium" recipe
    (vocabulary 10,000, embedding and hidden 650, 2 layers, tied decoder,
    dropout 0.5, bptt 35, batch 32; SGD lr 20 through ``gluon.Trainer``,
    ``clip_global_norm(0.25)`` every step) on the example's synthetic
    Markov corpus, float32, through the Gluon loop, eager and with the
    LSTM layer hybridized (CUDA graphs) in turns, each one of the
    example's epochs over the same 8 chunks (48 steps in all):
    step ms (median over turns) and tokens/s, the loss falling (the last
    turn's mean below the first's); one profiled step of each: idle share
    and device ms by group (recurrent GEMMs, input and decoder GEMMs, LSTM
    elementwise, the clip, the optimizer); one step hybridized = eager
    within 1e-5 under deterministic algorithms; one step's gradients at
    dropout 0 on the card against the CPU's float64 step (float64 within
    1e-9, float32 within 1e-4 of each parameter's largest); torch's fused
    LSTM (cuDNN) with the same weights at the same shape, forward and
    backward, as a yardstick (the port never calls it);
22. example gates: the JAX package's ``examples/word_language_model.py
    --steps 40 --epochs 2`` (perplexity below 12) and ``examples/dcgan.py
    --steps 300`` (moments within 0.3 and 0.4) as port functions on the
    card; and (in phase 18's table) ``RNN`` (four modes, 2 layers,
    bidirectional, T 35, N 32, hidden 650) and ``CTCLoss`` (both blank
    conventions, with lengths) card = CPU with their gradients (1e-4);
23. optimizers: each of NAG, RMSProp (plain, centered), AdaGrad,
    AdaDelta, FTRL, Signum, LAMB, LARS, DCASGD, SGLD, Adamax, Nadam and
    FTML on a small net: ``update_multi`` against per-parameter
    ``update`` within 1e-6, and ``ShardedTrainer``'s fused step (one CUDA
    graph) against its eager one within 1e-5 over 6 steps (SGLD with its
    generator seeded alike). No attention kernel launches in 21-23;
24. fault: the slice's entry point (``models/bert_pretraining.py``'s
    ``build``) at the bench's configuration (BERT-base, bf16 weights with
    fp32 masters under AdamW, dropout 0.1, batch 8 x 512) through the fused
    ``ShardedTrainer``, under ``torch.use_deterministic_algorithms`` for
    (a) and (b): (a) run U takes 8 steps and saves after step 4 (timed,
    with its bytes); run K saves after step 4 and dies by ``ChaosCrash`` at
    ``checkpoint.arrays`` while saving after step 6, after which only step
    4 is listed and it verifies; a new model and trainer restore it
    (timed) and run steps 5-8: losses, parameters and optimizer states
    bitwise equal to U's, 12 launches per kernel per step on the fused
    path (checkpoints in a temporary directory, ``keep=2``, removed at the
    end); (b) under ``StepGuard("skip_and_rollback")`` a step on a batch
    whose MLM weights are NaN trips the guard and is rolled back bitwise
    (parameters, states, ``num_update``) without a new capture, and the
    next clean step equals a clean run's bitwise; ``nan_batch`` through
    the chaos hook is reported (it poisons ``valid_length``, which masks
    every key); ``StepGuard("halt")`` raises ``NonFiniteError``; (c)
    printed, not gated: the fused step's ms unguarded, guarded with a
    snapshot every step and every 100 steps, and under a ``Watchdog``, in
    turns; (d) ``StackedTransformerEncoder`` at BERT-base widths (12
    layers, 768, 3072, 12 heads, float32, batch 8 x 512): the card's
    forward within 1e-4 of the CPU's (the first 2 rows, relative to the
    largest output), and one ``ShardedTrainer`` step with a finite loss;
25. data: workers and prefetch sized to the cores and ``/dev/shm``
    (printed first); (a) 2,048 seeded 256x256x3 uint8 images packed raw
    by ``recordio.MXIndexedRecordIO`` and ``pack`` (1,000 classes) ->
    ``gluon.data.RecordFileDataset`` -> ``transform`` (header and pixels)
    -> ``transform_first(Compose([RandomResizedCrop(224),
    RandomFlipLeftRight(), ToTensor(), Normalize]))`` -> ``DataLoader``
    (batch 32, shuffled, forked workers over shared memory, pinned) ->
    ``io.PrefetchIter(place=trainer.place)`` -> the fused ResNet-50 v1
    step of the bench's ``resnet`` workload (bf16, batch 32, 224): losses
    finite, one capture, the fused path, no worker died; (b) the same with
    a center crop, twice under deterministic algorithms, placed through
    ``PrefetchIter`` while the step runs and on the main thread: the
    step's static input buffers after every load and the losses bitwise
    equal; (c) 4,096 token sequences of lengths 64-512 through
    ``FixedBucketSampler`` (batch 8, keys 128/256/512, shuffled), a
    ``DataLoader`` padding each batch to its bucket and ``PrefetchIter``
    into BERT-base (the bench's trainer: bf16, AdamW with fp32 masters,
    dropout 0.1): 3 captures, each at its bucket's second step, 12
    launches per kernel per step; a run saved at step 6 with
    ``data_state`` and resumed by a new loader, iterator, model and
    trainer (``restore_checkpoint``, ``restore_shard``) gives steps 7-12's
    losses and batches bitwise, no sample replayed; (d) printed, not
    gated: the pipeline alone in images/s (0, 4 and 8 workers, shared
    memory and pipe), one batch's H2D pageable and pinned, the ResNet-50
    step fed by the pipeline against a placed batch, the consumer's wait
    p50/p95, the idle share of 6 profiled steps, BERT step ms per bucket;
    (e) when ``cv2`` imports, 512 JPEGs packed by the port's ``im2rec``
    (short side 256) and read by ``ImageRecordIter`` (random crop,
    mirror, mean/std): images/s; no ``/dev/shm/mxtpu_dl_*`` segment of the
    phase's workers is left;
26. serve tier: two ``serve.Replica``s of BERT-base (each loader builds
    the seeded model and captures 28 graphs over ``{"batch": (1, 8),
    "seq": (8, 512)}``) behind ``serve.Router`` and ``serve.Server`` on
    TCP; 4 client threads send 32 seeded ragged requests (4-511 tokens)
    with ``serve.client_call`` with nothing held or killed (the tier's
    steady req/s and latency, the share of the window in which neither
    replica's ``predict`` ran, and the reply's wire encoding re-timed on
    one thread), then 64 more, and after 16 replies (r0's next flush
    held until a request waits in its queue) r0 dies by the
    ``replica_kill`` chaos site in its request path, its queued requests
    failing over to r1: every accepted request gets an ``ok`` reply, r0 restarts (fresh registry, captures
    again) and is healthy, no capture after warmup, sampled replies (and
    r0's after its restart) within 1e-3 of the eager plain-attention
    forward; perturbed weights written with ``fault.checkpoint`` and
    applied by ``Router.sync_weights_once`` to both replicas with no
    capture, each serving the new weights; a burst of 64 short requests
    over shed depth 1 answered or shed with ``retry_after``, no accepted
    request lost; Transformer-big generation through
    ``serve.client_generate`` equal to the in-process ``DecodeBatcher``
    tokens, an over-budget tenant (``TokenRateBudget``) shed on the wire,
    ``decode_replica_death`` failing its streams and the next request
    served; printed: req/s and p50/p99 over the wire (the steady window
    and the kill window apart), failovers, the restart's and the weight
    sync's seconds, and the forward kernel's launches by the replicas
    (gated against their batches) and by the generation apart;
27. symbol: the Module API on the card. (a) ``models.mnist_example`` (the
    JAX package's ``examples/train_mnist.py``: synthetic MNIST blobs,
    ``Module.fit`` with SGD momentum 0.9, ``score``) on ``gpu(0)`` with the
    JAX gate's arguments (3 epochs, 600 samples, lr 0.05), ``mlp`` and
    ``lenet``: accuracy above 0.9 each; (b) ``lenet_symbol`` bound by
    ``simple_bind`` at batch 64: the Executor's replayed forward+backward
    (one CUDA graph) within 1e-5 of its eager one under deterministic
    algorithms on two batches, with one capture; its gradients within
    1e-4 of each largest of the CPU Executor's float64 run; a 20-step
    ``Module.fit`` with ``eval_data`` capturing exactly one graph per
    (shapes, ``is_train``); (c) that Module's checkpoint loaded into a CPU
    Module whose ``predict`` agrees within 1e-5; (d) negative-step
    indexing and assignment with its gradient on a CUDA NDArray equal to
    the CPU's, ``mx.gpu_memory_info(0)`` against
    ``torch.cuda.mem_get_info(0)``, arrays moved or made on ``cpu_pinned``
    page-locked; (e) printed, not gated: the fit step (forward_backward,
    update, update_metric) eager and replayed in turns for ``mlp`` and
    ``lenet`` at batch 64, and a profiled window of 5 steps of each:
    device ms and idle share per step ("not measured" when its traces
    record no device event). No attention kernel launches in the phase;
28. artifacts: BERT-base served from an exported artifact, on the tier's
    table (``{"batch": (1, 8), "seq": (8, 512)}``, 28 buckets). (a)
    ``serve.export_for_serving``: one ``torch.export`` program that all
    28 manifest entries name, its seconds and files' bytes; (b) the
    program holds 12 ``mxtpu::flash_attention_fwd`` nodes and no weights;
    (c) ``ModelRegistry.load(artifacts=)`` cold-loads it (``SymbolBlock``)
    and warms 28 bucket graphs, timed; (d) four batches in four buckets
    within 1e-3 of a factory-built ``CompiledModel`` over the same weights
    (bitwise printed), 12 forward launches a batch (the phase's count in
    the ``kernels`` line), a (8, 512) replay with no copy to the host in
    its profile; (e) perturbed weights from a ``fault.checkpoint`` through
    ``SymbolBlock.set_weights``: replies follow (within 1e-3 of the
    factory model given them, moved from the old), no capture; (f) a
    ``Replica``'s load timed from the factory, through an
    ``ArtifactCache`` on a miss (factory, export, put, load) and on a hit
    (no model built), then a corrupted entry (the ``corrupt_artifact``
    chaos site) evicted as a miss; (g) ``optimize_for("INT8")`` of a small
    conv net card vs CPU (the same int8 weights, outputs within one int8
    step) and a ``DENSE_ACT`` partition card vs CPU (1e-5 of the largest
    output); (h) ``models.serving_example`` (the JAX
    ``examples/serving.py``) on the card, 0 captures after warmup.
29. parallel: what one card runs of the multi-rank path (the card count
    is 1, and NCCL refuses two ranks on one device; the multi-rank
    meaning is held against the JAX package on the CPU by the tests).
    (a) ``ops.cuda.flash_attention.flash_block``, the ring's hop, at one
    hop of BERT-base over sp=4 (8, 12, 128 of 512, 64), float32 and
    bfloat16, modes 0 (full) and 1 (causal diagonal), under a ragged key
    mask in which one batch row has no key in the block: ``o``, ``lse``
    (rows with a key; the others at about -1e30) and dq/dk/dv under a
    non-zero lse cotangent against the plain versions, with the forward
    and backward kernels' ms (CUDA events, and device time from
    ``torch.profiler``) beside the plain versions'; (b) the 4-hop ring
    schedule run serially in one process at the train shape (8, 12, 512,
    64): each of the 4 ranks' query blocks meets the K/V blocks in the
    order that rank sees them, through the port's own ``ring._hop_attn``
    and ``ring._merge`` (a key mask with one row keyless in one shard),
    full and causal: the gathered output and the q/k/v gradients against
    ``flash_attention`` of the whole sequence, each of the three kernels
    launched once per live hop (16 full, 10 causal) and none for the 6
    masked hops (the phase's count in the ``kernels`` line,
    ``launches_by_path["parallel"]``); (c) a one-rank NCCL group
    (``parallel.dist.initialize(backend="nccl")``): the collectives over
    it on CUDA tensors, ``mx.kv.create("nccl")`` push/pull, and BERT-base
    at full width and depth (float32, dropout 0, batch 8 x 128, Adam)
    trained 3 steps through ``ShardedTrainer(mesh=make_mesh(),
    rules=bert_sharding_rules(), zero1=True)`` and the mesh-less fused
    trainer under deterministic algorithms: losses and weights bitwise
    equal, one graph per step (``launches_by_path["parallel_trainer"]``,
    the mesh trainer's launches alone). At one rank ``rules`` and
    ``zero1`` change nothing (every parameter stays whole, and the mesh
    trainer takes the fused path): (c) shows that a one-rank mesh is the
    mesh-less path on the card, and runs none of the multi-rank step,
    which the CPU tests hold against the JAX package on gloo ranks.

The last three lines are the ``kernels`` JSON line, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import gc
import glob
import json
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from unittest import mock

import numpy as onp
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, bench, fault, gluon, models
from incubator_mxnet_tpu_torch import nd, parallel, recordio, serve
from incubator_mxnet_tpu_torch.fault import inject
from incubator_mxnet_tpu_torch.models import bert_pretraining
from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
from incubator_mxnet_tpu_torch.ops.cuda import _build
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from incubator_mxnet_tpu_torch.ops.nn import fully_connected
from incubator_mxnet_tpu_torch.models import nmt
from incubator_mxnet_tpu_torch.util import getenv

# Published peaks of one H100 SXM (NVIDIA data sheet, dense) and HBM3
# bandwidth. bf16: the tensor cores' 989 TFLOP/s. float32: the fastest rate
# at fp32 accuracy, the TF32 tensor cores' 495 TFLOP/s over the three
# products of the 3xTF32 split (all three kernels run it).
PEAK_OPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# forward kernel vs plain version, on the card: (atol, rtol). float32: the
# kernel's two products run in 3xTF32 on the tensor cores (about fp32
# accuracy: each operand is a TF32 pair, the lo.lo term is dropped) and its
# online softmax over 64-key tiles sums in another order than the plain
# version's GEMMs; in bfloat16 the output's own rounding (one ulp is 2**-8
# relative) and P's rounding at another running maximum dominate.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}
LSE_ATOL = 1e-4
# backward kernels vs plain backward, on the card: (atol, rtol). float32:
# the kernels' products run in 3xTF32 on the tensor cores (about fp32
# accuracy: each operand is a TF32 pair, the lo.lo term is dropped) and sum
# up to 512 query rows (dQ: 512 keys) in another order than the plain
# version's GEMMs, so errors are no longer 0; bfloat16: one ulp of the
# output (2**-8..2**-7 relative), P and dS rounded at the same places.
TOL_BWD = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}
# train gradients on the kernels vs on the plain attention path, float32:
# another summation order and another formula for the softmax gradient
# (delta = rowsum(dO o) against autograd through softmax), through two
# layers: per parameter, max abs err <= GRAD_RTOL * max |grad|
GRAD_RTOL = 1e-3
# served (padded, batched, flash kernel) vs unbatched (plain attention)
# forwards of BERT-base in float32 without TF32: other GEMM shapes and the
# kernel's summation order, through 12 layers
SERVE_ATOL = 1e-3

SEQ_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
# serving phase: 320 ragged requests, paced at 160 req/s over 4 clients
# (about half the measured capacity), then all at once
N_REQUESTS, OFFERED_RATE = 320, 160.0
HEADS, HEAD_DIM = 12, 64
# the training phase's attention shape: bench.py's batch 8, sequence 512
TRAIN_SHAPE = (8, 512)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, target_ms: float = 40.0) -> float:
    """Mean device time of ``fn`` over enough launches to fill about
    ``target_ms``, measured with CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    iters = int(min(200, max(5, target_ms / max(e0.elapsed_time(e1), 1e-3))))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the time of the CUDA kernels it
    launches, from ``torch.profiler`` over ``reps`` calls after a warm-up,
    over ``reps``. Host time between launches is not counted, so a call
    that the host cannot keep fed reads the same as one that it can. The
    profiler now and then records no device event at all; such a trace is
    taken again, up to three times."""
    for _ in range(3):
        fn()
    for _ in range(3):
        _, per_kernel = device_split(lambda: [fn() for _ in range(reps)])
        if per_kernel:
            break
    return sum(per_kernel.values()) / reps


def visible_pairs(B, Lq, Lk, key_mask, causal, window, device) -> int:
    """(query, key) pairs the softmax sees: the work this run's data needs."""
    vis = torch.ones((B, Lq, Lk), dtype=torch.bool, device=device)
    if key_mask is not None:
        vis &= key_mask.bool()[:, None, :]
    if causal:
        vis &= fa._band(Lq, Lk, window, device)[None]
    return int(vis.sum().item())


def bound_ms(B, H, Lq, Lk, D, dtype, pairs, masked) -> tuple:
    """Least time for the work: the larger of operations over the peak for
    the input type and bytes (q, k, v, mask read once; o, lse written once)
    over HBM bandwidth."""
    e = torch.tensor([], dtype=dtype).element_size()
    ops = 4.0 * H * D * pairs
    nbytes = B * H * (2 * Lq + 2 * Lk) * D * e + B * H * Lq * 4
    if masked:
        nbytes += B * Lk * 4
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_case(gen, dtype, B, Lq, Lk, case, timed, results, H=HEADS,
                D=HEAD_DIM):
    """Kernel vs plain version on one shape; returns its result record."""
    dev = "cuda"
    q = torch.randn(B, H, Lq, D, device=dev, generator=gen).to(dtype)
    k = torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
    v = torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
    key_mask, causal, window = None, False, None
    if case in ("mask", "full"):
        vl = torch.randint(1, Lk + 1, (B,), device=dev, generator=gen)
        if case == "full":     # the training path: every key valid
            vl[:] = Lk
        elif B > 1:            # (at batch 1 one ragged row, as in prefill)
            vl[0] = 0          # rows that see no key: o is the mean of V
            vl[-1] = Lk
        key_mask = (torch.arange(Lk, device=dev)[None] < vl[:, None]
                    ).to(torch.int32)
    elif case == "holes":
        # not a prefix: batch 0 keeps no key, batch 1 only the keys of the
        # second 64-key tile, the others a random half
        key_mask = (torch.rand(B, Lk, device=dev, generator=gen) < 0.5
                    ).to(torch.int32)
        key_mask[0] = 0
        key_mask[1] = 0
        key_mask[1, 64:128] = 1
    elif case in ("causal", "causal_window"):
        causal = True
        window = max(1, Lk // 4) if case == "causal_window" else None
    scale = D ** -0.5
    o, lse = fa._fwd(q, k, v, key_mask, causal, scale, window)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, key_mask, causal, scale,
                                            window)
    err = (o.float() - ro.float()).abs().max().item()
    atol, rtol = TOL[dtype]
    check(torch.allclose(o.float(), ro.float(), atol=atol, rtol=rtol),
          f"{fa.KERNEL} {dtype} B={B} Lq={Lq} Lk={Lk} {case}: max abs err "
          f"{err} beyond atol={atol} rtol={rtol}")
    seen = rlse > -1e29      # rows that see at least one key
    if seen.any():
        lerr = (lse - rlse)[seen].abs().max().item()
        check(lerr <= LSE_ATOL, f"{fa.KERNEL} lse err {lerr} ({case})")
    check(bool((lse[~seen] <= -1e29).all()), f"{fa.KERNEL}: lse of a row "
          f"that sees no key above -1e29 ({case})")
    if key_mask is not None and not key_mask[0].any():
        mean_v = v[0].float().mean(dim=-2, keepdim=True).to(dtype).float()
        check(torch.allclose(o[0].float(), mean_v.expand(o[0].shape),
                             atol=atol, rtol=rtol),
              f"{fa.KERNEL}: a row that sees no key must give the mean of V")
    rec = {"kernel": fa.KERNEL, "dtype": str(dtype).replace("torch.", ""),
           "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D, "case": case,
           "max_abs_err": err}
    if timed:
        pairs = visible_pairs(B, Lq, Lk, key_mask, causal, window, dev)
        b_ms, b_by = bound_ms(B, H, Lq, Lk, D, dtype, pairs,
                              key_mask is not None)
        attn_mask = (key_mask.bool()[:, None, None, :]
                     if key_mask is not None else None)

        def kern():
            fa._fwd(q, k, v, key_mask, causal, scale, window)

        def sdpa():
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask)

        rec.update(
            ms=cuda_ms(kern), device_ms=device_ms(kern),
            plain_ms=cuda_ms(lambda: fa.flash_attention_reference(
                q, k, v, key_mask, causal, scale, window)),
            library_ms=cuda_ms(sdpa), library_device_ms=device_ms(sdpa),
            bound_ms=b_ms, bound_by=b_by)
        print(f"  {rec['dtype']:8s} B={B:2d} L={Lq:3d} {case:6s} "
              f"kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f})  "
              f"plain {rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} "
              f"ms (device {rec['library_device_ms']:.4f})  bound "
              f"{b_ms:.4f} ms ({b_by})  err {err:.2e}", flush=True)
    results.append(rec)
    return rec


def phase_kernels(results) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels: flash_attention_fwd vs flash_attention_reference "
          f"(f32 atol/rtol {TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]})",
          flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for L in SEQ_BUCKETS:
            for case in ("mask", "none", "causal", "causal_window"):
                kernel_case(gen, dtype, 8, L, L, case, case == "mask",
                            results)
        kernel_case(gen, dtype, 8, 128, 256, "causal", False, results)
        kernel_case(gen, dtype, 8, 512, 512, "holes", False, results)
        # the training path's shape: every key valid, nothing skipped
        kernel_case(gen, dtype, *TRAIN_SHAPE, TRAIN_SHAPE[1], "full", True,
                    results)
    # small tiles: many K/V tiles per block and a ragged last one
    os.environ["MXTPU_FLASH_BQ"], os.environ["MXTPU_FLASH_BK"] = "16", "48"
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("mask", "holes", "causal_window"):
                kernel_case(gen, dtype, 8, 512, 512, case, False, results)
    finally:
        del os.environ["MXTPU_FLASH_BQ"], os.environ["MXTPU_FLASH_BK"]
    # the largest bucket the serving phase runs
    main = kernel_case(gen, torch.float32, 32, 512, 512, "mask", True,
                       results)
    # the NMT training shapes: masked cross-attention with Lq < Lk and
    # Lq > Lk, a row that sees no key in each (a generator of their own:
    # the cases above keep their inputs)
    gen = torch.Generator(device="cuda").manual_seed(8)
    cross = [kernel_case(gen, dtype, NMT_BATCH, lq, lk, "mask", True,
                         results, H=NMT_CFG["num_heads"])
             for dtype in (torch.float32, torch.bfloat16)
             for lq, lk in NMT_CROSS]
    main["nmt_cross"] = cross[0]
    small_cases(kernel_case, 10, results)
    return main


def small_cases(case_fn, seed, results) -> None:
    """``case_fn`` (:func:`kernel_case` or :func:`bwd_case`) at the MT gate's
    shapes (:data:`MT_CASES`, head dim 16) and the serving prefill's (batch
    1, 16 heads, one ragged row of the largest source bucket), f32 and
    bf16, untimed, from a generator of their own."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk, case in MT_CASES:
            case_fn(gen, dtype, MT_BATCH, lq, lk, case, False, results,
                    H=MT_HEADS, D=MT_HEAD_DIM)
        case_fn(gen, dtype, 1, NMT_SRC, NMT_SRC, "mask", False, results,
                H=NMT_CFG["num_heads"])


def bwd_bound_ms(B, H, Lq, Lk, D, dtype, pairs, masked) -> dict:
    """Least time of each backward kernel: the larger of the operations the
    data needs (dK/dV: 8 per visible pair and head dim, four products; dQ:
    6, three products) over the peak for the input type, and the bytes
    (q, k, v, dO, lse, delta, mask read once; dK and dV, or dQ, written
    once) over HBM bandwidth."""
    e = torch.tensor([], dtype=dtype).element_size()
    reads = B * H * (2 * Lq + 2 * Lk) * D * e + 2 * B * H * Lq * 4
    if masked:
        reads += B * Lk * 4
    out = {}
    for name, ops, writes in ((fa.KERNEL_BWD_DKV, 8.0, 2 * B * H * Lk * D * e),
                              (fa.KERNEL_BWD_DQ, 6.0, B * H * Lq * D * e)):
        t_ops = ops * H * D * pairs / PEAK_OPS[dtype] * 1e3
        t_bytes = (reads + writes) / PEAK_BYTES * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def bwd_case(gen, dtype, B, Lq, Lk, case, timed, results, H=HEADS,
             D=HEAD_DIM):
    """Both backward kernels vs their plain versions on one shape; returns
    {kernel name: result record}."""
    dev = "cuda"
    q, do = (torch.randn(B, H, Lq, D, device=dev, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, H, Lk, D, device=dev, generator=gen).to(dtype)
            for _ in range(2))
    key_mask, causal, window = None, False, None
    if case in ("mask", "full"):
        vl = torch.randint(1, Lk + 1, (B,), device=dev, generator=gen)
        if case == "full":     # the training path: every key valid
            vl[:] = Lk
        elif B > 1:            # (at batch 1 one ragged row, as in prefill)
            vl[0] = 0          # a row that sees no key: dQ must be 0
            vl[-1] = Lk
        key_mask = (torch.arange(Lk, device=dev)[None] < vl[:, None]
                    ).to(torch.int32)
    elif case in ("causal", "causal_window"):
        causal = True
        window = max(1, Lk // 4) if case == "causal_window" else None
    scale = D ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, key_mask, causal, scale,
                                          window)
    delta = fa._delta(o, do)
    args = (q, k, v, key_mask, causal, scale, window, lse, do, delta)
    dk, dv = fa._bwd_dkv_cuda(*args)
    dq = fa._bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    rdk, rdv = fa.flash_attention_bwd_dkv_reference(*args)
    rdq = fa.flash_attention_bwd_dq_reference(*args)
    atol, rtol = TOL_BWD[dtype]
    errs = {}
    for name, pairs in ((fa.KERNEL_BWD_DKV, ((dk, rdk, "dk"), (dv, rdv, "dv"))),
                        (fa.KERNEL_BWD_DQ, ((dq, rdq, "dq"),))):
        errs[name] = 0.0
        for got, want, label in pairs:
            err = (got.float() - want.float()).abs().max().item()
            check(torch.allclose(got.float(), want.float(), atol=atol,
                                 rtol=rtol),
                  f"{name} {label} {dtype} B={B} Lq={Lq} Lk={Lk} {case}: "
                  f"max abs err {err} beyond atol={atol} rtol={rtol}")
            errs[name] = max(errs[name], err)
    if key_mask is not None and not key_mask[0].any():
        check(bool((dq[0] == 0).all()), f"{fa.KERNEL_BWD_DQ}: a row that "
              "sees no key must give exactly 0")
    base = {"dtype": str(dtype).replace("torch.", ""), "B": B, "H": H,
            "Lq": Lq, "Lk": Lk, "D": D, "case": case}
    recs = {name: dict(base, kernel=name, max_abs_err=err)
            for name, err in errs.items()}
    if timed:
        pairs = visible_pairs(B, Lq, Lk, key_mask, causal, window, dev)
        bounds = bwd_bound_ms(B, H, Lq, Lk, D, dtype, pairs,
                              key_mask is not None)
        # yardstick: SDPA forward + backward minus SDPA forward, on the
        # same inputs (one library call computes dQ, dK and dV together),
        # in device time: autograd's host work between the launches would
        # otherwise be timed with it; the visibility goes in as a boolean
        # mask, since SDPA's is_causal aligns the band top-left where the
        # port aligns it bottom-right
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        attn_mask = fa._visible(q, Lk, key_mask, causal, window)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def sdpa_fwd_bwd():
            out = sdpa(*leaves, attn_mask=attn_mask, scale=scale)
            torch.autograd.grad(out, leaves, do)

        sdpa_bwd = (device_ms(sdpa_fwd_bwd)
                    - device_ms(lambda: sdpa(*leaves, attn_mask=attn_mask,
                                             scale=scale)))
        timing = {
            fa.KERNEL_BWD_DKV: (lambda: fa._bwd_dkv_cuda(*args),
                                lambda: fa.flash_attention_bwd_dkv_reference(
                                    *args)),
            fa.KERNEL_BWD_DQ: (lambda: fa._bwd_dq_cuda(*args),
                               lambda: fa.flash_attention_bwd_dq_reference(
                                   *args))}
        for name, (kern, plain) in timing.items():
            b_ms, b_by = bounds[name]
            recs[name].update(ms=cuda_ms(kern), device_ms=device_ms(kern),
                              plain_ms=cuda_ms(plain), library_ms=sdpa_bwd,
                              bound_ms=b_ms, bound_by=b_by)
            r = recs[name]
            print(f"  {name:24s} {r['dtype']:8s} B={B} Lq={Lq} Lk={Lk} "
                  f"{case:6s} "
                  f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
                  f"plain {r['plain_ms']:.4f} ms  "
                  f"sdpa bwd {sdpa_bwd:.4f} ms (device)  bound {b_ms:.4f} ms "
                  f"({b_by})  err {r['max_abs_err']:.2e}", flush=True)
    results.extend(recs.values())
    return recs


def phase_kernels_bwd(results) -> dict:
    """The backward kernels on every case; returns the timed float32
    records at the training shape, by kernel name."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    print("kernels: flash_attention_bwd_dkv / _dq vs their plain versions "
          f"(f32 atol/rtol {TOL_BWD[torch.float32]}, bf16 "
          f"{TOL_BWD[torch.bfloat16]})", flush=True)
    B, L = TRAIN_SHAPE
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ("full", "mask", "causal", "causal_window"):
            recs = bwd_case(gen, dtype, B, L, L, case, case == "full",
                            results)
            if dtype == torch.float32 and case == "full":
                main = recs
        bwd_case(gen, dtype, B, 128, 256, "causal", True, results)
        bwd_case(gen, dtype, B, 100, 100, "mask", True, results)
    # small tiles: many tiles per block and a ragged last one
    os.environ["MXTPU_FLASH_BQ"], os.environ["MXTPU_FLASH_BK"] = "16", "48"
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for case in ("mask", "causal_window"):
                bwd_case(gen, dtype, B, L, L, case, False, results)
    finally:
        del os.environ["MXTPU_FLASH_BQ"], os.environ["MXTPU_FLASH_BK"]
    # the NMT training shapes (masked, Lq < Lk and Lq > Lk), from a
    # generator of their own
    gen = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk in NMT_CROSS:
            recs = bwd_case(gen, dtype, NMT_BATCH, lq, lk, "mask", True,
                            results, H=NMT_CFG["num_heads"])
            if dtype == torch.float32 and lq < lk:
                for name, rec in recs.items():
                    main[name]["nmt_cross"] = rec
    small_cases(bwd_case, 11, results)
    return main


def drive(batcher, cm, reqs, gaps) -> dict:
    """Submit every request from 4 client threads (client ``c`` sends
    requests c, c+4, ... after the given gaps) and wait for all results."""
    n = len(reqs)
    futures = [None] * n
    errors = []
    batcher.metrics.reset()

    def client(idx):
        try:
            for i in range(idx, n, 4):
                if gaps[i]:
                    time.sleep(gaps[i])
                futures[i] = batcher.submit(*reqs[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(not errors, f"submit failed: {errors[:3]}")
    outs = [f.result(timeout=600) for f in futures]
    wall = time.perf_counter() - t0
    snap = batcher.metrics.snapshot(cm)
    print(f"serve: {json.dumps(snap)}", flush=True)
    check(snap["requests"] == n and snap["failed"] == 0,
          f"served {snap['requests']}/{n}, failed {snap['failed']}")
    check(snap["compile_cache"]["post_warmup_compiles"] == 0,
          f"post-warmup compiles: "
          f"{snap['compile_cache']['post_warmup_compiles']}")
    return {"outs": outs, "wall_s": wall, "snapshot": snap}


def _max_err(host: onp.ndarray, dev: torch.Tensor) -> float:
    """Largest absolute difference of a served numpy row and a tensor."""
    return float(onp.abs(host - dev.float().cpu().numpy()).max())


def phase_serve(n_requests: int, rate: float, seed: int) -> dict:
    t0 = time.perf_counter()
    model = models.get_bert("bert_12_768_12", vocab_size=30522,
                            max_length=512, use_decoder=False,
                            use_classifier=False, device="cuda")
    spec = models.serve_spec("bert_encoder")
    table = serve.BucketTable({"batch": (1, 32), "seq": (8, 512)})
    example = (onp.zeros((1, 8), "int32"), onp.zeros((1, 8), "int32"),
               onp.zeros((1,), "float32"))
    cm = serve.CompiledModel(model, table, spec["input_axes"], example,
                             output_axes=spec["output_axes"],
                             pad_values=spec["pad_values"])
    print(f"serve: model built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    warm = cm.warmup()
    captures = len(cm._graphs)
    print(f"serve: warmup {warm}: {captures} CUDA graphs captured, one "
          f"per bucket", flush=True)
    check(captures == warm["compiled"] == table.num_buckets()
          and cm.cache_info()["warmup_compiles"] == captures,
          f"warmup captured {captures} graphs for {table.num_buckets()} "
          f"buckets: {cm.cache_info()}")

    rng = onp.random.RandomState(seed)
    reqs = []
    for _ in range(n_requests):
        L = int(rng.randint(4, 512))
        reqs.append((rng.randint(1, 30522, L).astype("int32"),
                     (onp.arange(L) >= L // 2).astype("int32"),
                     onp.array(L, "float32")))
    gaps = rng.exponential(4.0 / rate, n_requests)  # per client: rate / 4

    batcher = serve.DynamicBatcher(cm, max_delay_ms=5.0)
    cuda_ops.reset_launches()
    batcher.start()
    try:
        # paced: 4 clients with seeded exponential gaps; burst: the same
        # requests all at once (the batcher's capacity)
        runs = {"paced": drive(batcher, cm, reqs, gaps),
                "burst": drive(batcher, cm, reqs, onp.zeros(n_requests))}
    finally:
        batcher.stop()
    launches = cuda_ops.launch_counts()
    batches = sum(r["snapshot"]["batches"] for r in runs.values())
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    check(launches[fa.KERNEL] >= n_layers * batches > 0,
          f"{fa.KERNEL} launched {launches[fa.KERNEL]} times for "
          f"{batches} batches of {n_layers} layers")
    for name in (fa.KERNEL_BWD_DKV, fa.KERNEL_BWD_DQ):
        check(launches[name] == 0, f"serving (inference_mode) launched the "
              f"backward kernel {name} {launches[name]} times")
    check(cm.cache_info()["compiles"] == captures, f"a bucket was "
          f"captured after warmup: {cm.cache_info()}")
    outs = runs["paced"]["outs"]
    for a, b in zip(outs, runs["burst"]["outs"]):
        check(a[0].shape == b[0].shape
              and onp.abs(a[0] - b[0]).max() <= SERVE_ATOL,
              "paced and burst runs served different outputs")

    # served outputs vs unbatched forwards on the plain attention path
    picks = sorted(range(n_requests), key=lambda i: reqs[i][2])
    picks = [picks[int(j)] for j in onp.linspace(0, n_requests - 1, 8)]
    dev = next(model.parameters()).device
    worst = 0.0
    before = cuda_ops.launch_counts()
    os.environ["MXTPU_ATTN_IMPL"] = "xla"
    try:
        with torch.inference_mode():
            for i in picks:
                ids, tt, vl = (torch.from_numpy(a[None]).to(dev)
                               for a in reqs[i])
                seq, pooled = model(ids, tt, vl)
                got_seq, got_pooled = outs[i]
                L = int(reqs[i][2])
                check(tuple(got_seq.shape) == (L, 768)
                      and tuple(got_pooled.shape) == (768,),
                      f"served shapes {tuple(got_seq.shape)}, "
                      f"{tuple(got_pooled.shape)} for length {L}")
                check(bool(onp.isfinite(got_seq).all()
                           and onp.isfinite(got_pooled).all()),
                      "served outputs are not finite")
                worst = max(worst, _max_err(got_seq, seq[0]),
                            _max_err(got_pooled, pooled[0]))
    finally:
        del os.environ["MXTPU_ATTN_IMPL"]
    check(cuda_ops.launch_counts() == before,
          "impl='xla' reached a kernel")
    check(worst <= SERVE_ATOL, f"served vs unbatched xla forward: max abs "
          f"err {worst} > {SERVE_ATOL}")
    res = {"model": model, "requests": n_requests,
           "warmup_s": warm["seconds"], "captures": captures,
           "launches": launches, "batches": batches,
           "served_vs_xla_max_abs_err": worst,
           "checked_lengths": [int(reqs[i][2]) for i in picks]}
    card = card_line()
    for name, r in runs.items():
        lat = r["snapshot"]["latency"]
        res[name] = {"wall_s": r["wall_s"], "req_s": n_requests / r["wall_s"],
                     "p50_ms": lat["latency_ms_p50"],
                     "p99_ms": lat["latency_ms_p99"],
                     "batches": r["snapshot"]["batches"],
                     "batch_occupancy": r["snapshot"]["batch_occupancy"]}
        offered = f"offered {rate} req/s" if name == "paced" else "all at once"
        print(f"serve {name}: {n_requests} requests ({offered}) in "
              f"{r['wall_s']:.3f} s = {res[name]['req_s']:.1f} req/s, "
              f"latency p50 {lat['latency_ms_p50']} ms p99 "
              f"{lat['latency_ms_p99']} ms, {r['snapshot']['batches']} "
              f"batches on {card}", flush=True)
    print(f"serve: launches {launches}, served vs xla max abs err "
          f"{worst:.2e} (tol {SERVE_ATOL})", flush=True)
    return res


def device_split(fn) -> tuple:
    """Run ``fn`` once under ``torch.profiler`` and return ``(wall_ms,
    {kernel name: device ms})``, device-side events only (CPU operators
    also carry their kernels' time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
    return wall, per_kernel


def summarize(tag: str, per_kernel: dict) -> dict:
    """Shares of the flash kernels and the GEMMs, and the top kernels."""
    total = sum(per_kernel.values())
    res = {"profiled_device_ms": total, "kernels": len(per_kernel),
           "top": []}
    if total <= 0:
        print(f"{tag}: the profiler saw no device time", flush=True)
        return res
    groups = {fa.KERNEL: "flash_fwd_kernel",
              fa.KERNEL_BWD_DKV: "flash_bwd_dkv_kernel",
              fa.KERNEL_BWD_DQ: "flash_bwd_dq_kernel"}
    res["ms_by_group"] = {g: sum(t for k, t in per_kernel.items() if m in k)
                          for g, m in groups.items()}
    res["ms_by_group"]["gemm"] = sum(t for k, t in per_kernel.items()
                                     if "gemm" in k.lower())
    res["ms_by_group"]["other"] = total - sum(res["ms_by_group"].values())
    for k, t in sorted(per_kernel.items(), key=lambda r: -r[1])[:8]:
        res["top"].append({"kernel": k[:90], "ms": t, "share": t / total})
        print(f"  {t:9.3f} ms {t / total:6.1%}  {k[:90]}", flush=True)
    print(f"{tag}: {total:.3f} ms of device time in {len(per_kernel)} "
          "kernels; " + ", ".join(f"{g} {t:.3f} ms ({t / total:.1%})"
                                  for g, t in res["ms_by_group"].items()),
          flush=True)
    return res


def phase_profile(model, B: int = 32, L: int = 512) -> dict:
    """Device time of one BERT forward at the largest bucket, and its
    split by kernel from ``torch.profiler`` (self device time)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(1, 30522, (B, L), device="cuda", generator=gen,
                        dtype=torch.int32)
    tt = torch.zeros_like(ids)
    vl = torch.full((B,), float(L), device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(ids, tt, vl), target_ms=300.0)
        _, per_kernel = device_split(lambda: model(ids, tt, vl))
    print(f"profile: forward at bucket (batch {B}, seq {L}): {fwd_ms:.3f} ms "
          f"(CUDA events)", flush=True)
    res = {"bucket": [B, L], "forward_ms": fwd_ms}
    res.update(summarize("profile", per_kernel))
    return res


def train_run(trainer, batch, steps: int, per_step: int, tag: str) -> dict:
    """The port bench's protocol on one trainer: its losses, the kernels'
    launches over the run (counted from 0 just before it, replays
    included: ``per_step`` per kernel per step, one per attention call)
    and its peak memory."""
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    timings = {}
    dt, losses = bench.measure(trainer, batch, steps, timings)
    launches = cuda_ops.launch_counts()
    losses = [float(x) for x in losses]
    n_steps = len(losses)
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(bool(trainer.last_finite), f"{tag}: the last step's loss or "
          "gradient norm is not finite")
    for name, n in launches.items():
        check(n == per_step * n_steps, f"{tag}: {name} launched {n} times "
              f"in {n_steps} steps of {per_step} attention calls")
    return {"dt": dt, "losses": losses, "launches": launches,
            "first_step_ms": timings["first_step_s"] * 1e3,
            "warm_step_ms": timings["warm_step_s"] * 1e3,
            "steps": n_steps, "captures": trainer.captures,
            "last_step_graphs": trainer.last_step_graphs,
            "last_path": trainer.last_path,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def profiled_step(trainer, placed, tag: str) -> dict:
    """One step under ``torch.profiler``: wall ms, device ms, idle share
    and the split by kernel."""
    wall, per_kernel = device_split(lambda: trainer.step(*placed))
    res = {"profiled_step_wall_ms": wall}
    res.update(summarize(f"{tag} profile", per_kernel))
    busy = res["profiled_device_ms"]
    res["device_idle_share"] = max(0.0, 1.0 - busy / wall)
    print(f"{tag} profile: one step {wall:.3f} ms wall under the profiler, "
          f"device busy {busy:.3f} ms, idle share "
          f"{res['device_idle_share']:.1%}", flush=True)
    return res


def phase_train() -> dict:
    """The port bench at full width and depth, through the fused step
    (one CUDA-graph replay per step, the default) and the eager step,
    timed in turns in this call: each path's losses, launches per step and
    captures; the fused path's JSON line; one profiled step of each."""
    t0 = time.perf_counter()
    trainer, batch, info = bench.build("cuda")
    eager, _, _ = bench.build("cuda", fused=False)
    check(trainer.fused and not eager.fused, "the bench's trainer is not "
          "fused by default")
    print(f"train: {info['model']} bfloat16, {info['params']} parameters, "
          f"fused and eager trainers built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    steps = int(getenv("MXTPU_BENCH_STEPS"))
    n_layers = info["cfg"]["num_layers"]
    runs = {"fused": train_run(trainer, batch, steps, n_layers, "train"),
            "eager": train_run(eager, batch, steps, n_layers,
                               "train eager")}
    check(runs["fused"]["captures"] == 1
          and runs["fused"]["last_step_graphs"] == 1
          and runs["fused"]["last_path"] == "fused",
          f"fused trainer: {runs['fused']['captures']} captures, "
          f"{runs['fused']['last_step_graphs']} graphs in its last step")
    record = bench.result(info, runs["fused"]["dt"], runs["fused"]["losses"])
    print(json.dumps(record), flush=True)
    placed = trainer.place(*batch)
    # in turns, after each path's own run: eager, fused
    for name, tr in (("eager", eager), ("fused", trainer)):
        runs[name]["step_ms_runs"] = [runs[name]["dt"] * 1e3,
                                      synced_ms(lambda: tr.step(*placed),
                                                steps)[0]]
    card = card_line()
    for name, r in runs.items():
        ms = min(r["step_ms_runs"])
        r["step_ms"], r["tokens_per_s"] = ms, info["batch"] * info[
            "seq"] / (ms / 1e3)
        print(f"train {name}: {ms:.3f} ms per step = {r['tokens_per_s']:.1f}"
              f" tokens/s (runs {[round(t, 3) for t in r['step_ms_runs']]})"
              f", captures {r['captures']}, graphs in the last step "
              f"{r['last_step_graphs']}, losses {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f} over {r['steps']} steps, launches "
              f"{r['launches']}, peak memory {r['peak_memory_gib']:.2f} GiB "
              f"on {card}", flush=True)
    fused_l, eager_l = ([round(x, 4) for x in runs[k]["losses"]]
                        for k in ("fused", "eager"))
    print(f"train: losses fused {fused_l}, eager {eager_l}; grad norm "
          f"{trainer.last_grad_norm:.4f}", flush=True)
    res = {"record": record, "runs": runs,
           "launches": runs["fused"]["launches"],
           "launches_eager": runs["eager"]["launches"]}
    res["profile"] = profiled_step(trainer, placed, "train fused")
    res["profile_eager"] = profiled_step(eager, placed, "train eager")
    del trainer, eager
    return res


def phase_train_fused_gate(num_layers: int = 2, steps: int = 3) -> dict:
    """The fused step against the eager one on the bench's configuration
    (bf16 + fp32 masters, AdamW, the bench's batch) at full width and
    ``num_layers`` layers, under ``torch.use_deterministic_algorithms``:
    at dropout 0 every loss and, after ``steps`` steps, every weight must
    equal the eager one to 1e-5 of its largest value; at dropout 0.1 the
    losses say whether the captured masks are the eager ones."""
    gc.collect()
    torch.cuda.empty_cache()
    batch = bench.make_batch(*TRAIN_SHAPE)
    res = {}
    torch.use_deterministic_algorithms(True)
    try:
        for dropout in (0.0, 0.1):
            nets, trainers = [], []
            for fused in (None, False):
                net = models.get_bert(
                    "bert_12_768_12", vocab_size=bench.VOCAB,
                    max_length=TRAIN_SHAPE[1], dropout=dropout,
                    dtype="bfloat16", device="cuda", num_layers=num_layers,
                    generator=torch.Generator().manual_seed(0))
                nets.append(net)
                trainers.append(parallel.ShardedTrainer(
                    net, models.bert_pretrain_loss, "adamw",
                    {"learning_rate": 1e-4, "multi_precision": True},
                    device="cuda", n_labels=3, fused=fused))
            losses = [[float(tr.step(*batch)) for _ in range(steps)]
                      for tr in trainers]
            check(trainers[0].last_step_graphs == 1
                  and trainers[0].captures == 1, "the gate's fused trainer "
                  "did not replay a graph")
            worst, worst_name = 0.0, ""
            eager_params = dict(nets[1].named_parameters())
            for name, p in nets[0].named_parameters():
                want = eager_params[name].detach().float()
                ratio = ((p.detach().float() - want).abs().max()
                         / want.abs().max().clamp_min(1e-30)).item()
                if ratio > worst:
                    worst, worst_name = ratio, name
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
            res[f"dropout_{dropout}"] = {
                "losses_fused": losses[0], "losses_eager": losses[1],
                "loss_rel_err": loss_err, "weights_worst_rel_err": worst,
                "weights_worst_param": worst_name,
                "bitwise": loss_err == 0.0 and worst == 0.0}
            print(f"train gate, dropout {dropout}, {num_layers} layers at "
                  f"full width, {steps} steps, fused vs eager: losses "
                  f"{losses[0]} vs {losses[1]} (worst rel err {loss_err:.2e})"
                  f", weights worst rel err {worst:.2e} ({worst_name})",
                  flush=True)
            if dropout == 0.0:
                check(loss_err <= 1e-5 and worst <= 1e-5,
                      f"fused and eager steps differ: losses {loss_err}, "
                      f"weights {worst} at {worst_name}")
            else:
                print("train gate: the captured dropout masks "
                      + ("equal" if loss_err == 0.0 else "differ from")
                      + " the eager ones from the same seed", flush=True)
            del nets, trainers
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(False)
    res["bias_correction"] = bias_correction_diff()
    return res


def bias_correction_diff(max_t: int = 100_000) -> dict:
    """Adam's ``1 - beta ** t`` as the fused step computes it (torch's
    float32 ``pow`` on the card) against numpy's float32 ``pow`` on the
    host, for t in 1..``max_t``: the largest difference in float32 ulps."""
    t = torch.arange(1, max_t + 1, device="cuda", dtype=torch.int32)
    out = {}
    for beta in (0.9, 0.999):
        dev = (1.0 - torch.pow(beta, t.to(torch.float32))).cpu().numpy()
        host = onp.float32(1.0) - onp.float32(beta) ** onp.arange(
            1, max_t + 1, dtype=onp.float32)
        ulps = onp.abs(dev.view(onp.int32).astype(onp.int64)
                       - host.view(onp.int32).astype(onp.int64))
        out[str(beta)] = {"max_ulps": int(ulps.max()),
                          "differing": int((ulps > 0).sum())}
    print(f"bias correction 1 - beta**t, t = 1..{max_t}, card float32 pow "
          f"vs numpy float32 pow: {out}", flush=True)
    return out


def phase_train_grads(num_layers: int = 2) -> dict:
    """One step's parameter gradients on the kernels against the plain
    attention path: BERT-base width, ``num_layers`` layers, float32,
    dropout 0, the bench's batch."""
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=TRAIN_SHAPE[1], dropout=0.0,
                          dtype="float32", device="cuda",
                          num_layers=num_layers)
    batch = [torch.from_numpy(a).cuda() for a in bench.make_batch(
        *TRAIN_SHAPE)]

    def step():
        net.zero_grad(set_to_none=True)
        net.train()
        loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
        loss.backward()
        return loss.detach().item(), {n: p.grad.detach().clone()
                             for n, p in net.named_parameters()}

    cuda_ops.reset_launches()
    loss_k, grads_k = step()
    launches = cuda_ops.launch_counts()
    for name, n in launches.items():
        check(n == num_layers, f"{name} launched {n} times in one step of "
              f"{num_layers} layers")
    os.environ["MXTPU_ATTN_IMPL"] = "xla"
    try:
        loss_x, grads_x = step()
    finally:
        del os.environ["MXTPU_ATTN_IMPL"]
    check(cuda_ops.launch_counts() == launches,
          "impl='xla' reached a kernel")
    worst, worst_name = 0.0, ""
    for name, gx in grads_x.items():
        ratio = ((grads_k[name] - gx).abs().max()
                 / gx.abs().max().clamp_min(1e-30)).item()
        if ratio > worst:
            worst, worst_name = ratio, name
    loss_err = abs(loss_k - loss_x)
    print(f"train gradients: {len(grads_x)} parameters, {num_layers} layers "
          f"at full width, kernels vs plain attention: worst max abs err / "
          f"max |grad| {worst:.2e} ({worst_name}, tol {GRAD_RTOL}), loss "
          f"{loss_k:.6f} vs {loss_x:.6f}", flush=True)
    check(worst <= GRAD_RTOL, f"gradients differ: {worst} at {worst_name}")
    check(loss_err <= 1e-5 * abs(loss_x), f"loss differs by {loss_err}")
    return {"layers": num_layers, "worst_rel_err": worst,
            "worst_param": worst_name, "loss_kernels": loss_k,
            "loss_plain": loss_x, "launches": launches}


def gluon_step(net, trainer, batch) -> "nd.NDArray":
    """One step of the Gluon loop on ``batch`` (NDArrays on the card)."""
    with autograd.record():
        loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
    loss.backward()
    trainer.step(1)
    return loss


def synced_ms(fn, steps: int) -> tuple:
    """``fn()`` ``steps`` times between two synchronizes: ``(ms per call on
    the host clock, every result)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [fn() for _ in range(steps)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, out


def gluon_split(net, trainer, batch) -> dict:
    """One Gluon step in three synchronised parts: the recorded forward
    and loss, ``loss.backward()`` and ``trainer.step(1)`` (host clock,
    each part's device work included)."""
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    with autograd.record():
        loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
    mark()
    loss.backward()
    mark()
    trainer.step(1)
    mark()
    ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return dict(zip(("forward_ms", "backward_ms", "update_ms"), ms))


def gluon_net(ctx, L: int, hybridize: bool):
    """BERT-base (float32, dropout 0.1) initialised with Xavier after
    ``mx.random.seed(0)`` (so twins have the same weights), and its Adam
    ``gluon.Trainer``."""
    mx.random.seed(0)
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=L, dropout=0.1, dtype="float32")
    net.initialize(mx.init.Xavier(), ctx=ctx, force_reinit=True)
    if hybridize:
        net.hybridize()
    return net, gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-4})


def gluon_loop(net, trainer, batch, steps: int, n_layers: int,
               tag: str) -> dict:
    """Two warm steps (a hybridized net's eager call and its capture), then
    ``steps`` timed steps with the kernels' launches counted from 0 just
    before them, and two more counted one by one: 12 per kernel per
    step."""
    losses = [gluon_step(net, trainer, batch) for _ in range(2)]
    per_step = []

    def counted():
        cuda_ops.reset_launches()
        loss = gluon_step(net, trainer, batch)
        per_step.append(cuda_ops.launch_counts())
        return loss

    cuda_ops.reset_launches()
    step_ms, timed = synced_ms(lambda: gluon_step(net, trainer, batch),
                               steps)
    launches = cuda_ops.launch_counts()
    _, counted_losses = synced_ms(counted, 2)
    losses = [float(x.asscalar()) for x in losses + timed + counted_losses]
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    for name, n in launches.items():
        check(n == n_layers * steps, f"{tag}: {name} launched {n} times in "
              f"{steps} steps of {n_layers} layers")
    for counts in per_step:
        check(all(n == n_layers for n in counts.values()),
              f"{tag}: launches in one step: {counts}")
    return {"losses": losses, "launches": launches,
            "step_ms_runs": [step_ms]}


def phase_gluon(trained: dict, steps: int = 5) -> dict:
    """BERT-base trained through the Gluon loop, plain and hybridized (CUDA
    graphs for the forward and backward, the multi-tensor Adam of
    ``gluon.Trainer`` in both): losses, launches per step, step ms timed in
    turns with the forward/backward/update split, against
    ``ShardedTrainer`` on the same model and optimizer; the gradients of a
    hybridized backward against ``ShardedTrainer``'s, and the ``.params``
    and trainer-state round trips."""
    gc.collect()
    torch.cuda.empty_cache()
    ctx, (B, L) = mx.gpu(0), TRAIN_SHAPE
    t0 = time.perf_counter()
    host = bench.make_batch(B, L)
    batch = [nd.array(a, ctx=ctx) for a in host]
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    nets = {"plain": gluon_net(ctx, L, False),
            "hybrid": gluon_net(ctx, L, True)}
    n_params = len(nets["plain"][1]._params)
    print(f"gluon: bert_12_768_12 float32, {n_params} parameters, plain and "
          f"hybridized nets built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    runs = {name: gluon_loop(net, tr, batch, steps, n_layers,
                             f"gluon {name}")
            for name, (net, tr) in nets.items()}
    check(len(nets["hybrid"][0]._cached_ops) == 1
          and all(op.bwd is not None
                  for op in nets["hybrid"][0]._cached_ops.values()),
          "the hybridized net did not capture one forward and backward "
          "graph")
    # in turns, after each path's own run: hybrid, plain
    for name in ("hybrid", "plain"):
        net, tr = nets[name]
        runs[name]["step_ms_runs"].append(synced_ms(
            lambda: gluon_step(net, tr, batch), steps)[0])
    for name, (net, tr) in nets.items():
        r = runs[name]
        r["step_ms"] = min(r["step_ms_runs"])
        r["tokens_per_s"] = B * L / (r["step_ms"] / 1e3)
        r["split"] = gluon_split(net, tr, batch)
        wall, per_kernel = device_split(lambda: gluon_step(net, tr, batch))
        busy = sum(per_kernel.values())
        r.update(profiled_step_wall_ms=wall, profiled_device_ms=busy,
                 device_idle_share=max(0.0, 1 - busy / wall))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the same model and optimizer through ShardedTrainer (its fused step),
    # timed in turns with the plain Gluon loop
    net, tr = nets["plain"]
    st = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adam",
                                 {"learning_rate": 1e-4}, device="cuda",
                                 n_labels=3)
    placed = st.place(*host)
    st.step(*placed)
    st.step(*placed)
    st_runs = [synced_ms(lambda: st.step(*placed), steps)[0]]
    runs["plain"]["step_ms_runs"].append(synced_ms(
        lambda: gluon_step(net, tr, batch), steps)[0])
    st_runs.append(synced_ms(lambda: st.step(*placed), steps)[0])
    st_ms = min(st_runs)
    st_tps = B * L / (st_ms / 1e3)
    card = card_line()
    for name, r in runs.items():
        sp = r["split"]
        print(f"gluon {name}: loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f} over {len(r['losses'])} steps; "
              f"{r['step_ms']:.3f} ms per step = {r['tokens_per_s']:.1f} "
              f"tokens/s (runs {[round(t, 3) for t in r['step_ms_runs']]}); "
              f"one synchronised step split: forward {sp['forward_ms']:.3f}, "
              f"backward {sp['backward_ms']:.3f}, trainer.step "
              f"{sp['update_ms']:.3f} ms for {n_params} parameters; one step "
              f"under the profiler {r['profiled_step_wall_ms']:.3f} ms wall, "
              f"{r['profiled_device_ms']:.3f} ms device, idle share "
              f"{r['device_idle_share']:.1%}; launches {r['launches']} on "
              f"{card}", flush=True)
    print(f"gluon: ShardedTrainer (fused), same model and Adam, in turns with"
          f" the plain loop: {st_ms:.3f} ms = {st_tps:.1f} tokens/s (runs "
          f"{[round(t, 3) for t in st_runs]}); the bench's bf16 AdamW fused "
          f"step: {trained['runs']['fused']['step_ms']:.3f} ms; peak memory "
          f"{peak_gb:.2f} GiB", flush=True)
    del st, tr, net, nets, batch
    res = {"runs": runs, "launches": runs["plain"]["launches"],
           "launches_hybrid": runs["hybrid"]["launches"], "steps": steps,
           "sharded_trainer_step_ms": st_ms,
           "sharded_trainer_tokens_per_s": st_tps,
           "sharded_trainer_step_ms_runs": st_runs,
           "parameters": n_params, "peak_memory_gib": peak_gb}
    res.update(gluon_grads_vs_sharded())
    res.update(gluon_round_trip())
    return res


def gluon_grads_vs_sharded(num_layers: int = 2) -> dict:
    """The ``param.grad()`` of a hybridized net's replayed backward against
    the gradients that ``ShardedTrainer.step`` leaves on the same weights
    and batch (full width, ``num_layers`` layers, float32, dropout 0)."""
    gc.collect()
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=TRAIN_SHAPE[1], dropout=0.0,
                          dtype="float32", device="cuda",
                          num_layers=num_layers)
    net.hybridize()
    host = bench.make_batch(*TRAIN_SHAPE)
    batch = [nd.array(a, ctx=mx.gpu(0)) for a in host]
    params = net.collect_params()
    for _ in range(3):                 # eager call, capture, replay
        cuda_ops.reset_launches()
        with autograd.record():
            loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
        loss.backward()
    launches = cuda_ops.launch_counts()
    check(all(n == num_layers for n in launches.values()),
          f"one replayed backward of {num_layers} layers launched "
          f"{launches}")
    got = {k: p.grad()._data.clone() for k, p in params.items()}
    st = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adam",
                                 {"learning_rate": 1e-4}, device="cuda",
                                 n_labels=3)
    st_loss = float(st.step(*host))
    worst, worst_name = 0.0, ""
    for k, p in params.items():
        want = p._var.grad
        ratio = ((got[k] - want).abs().max()
                 / want.abs().max().clamp_min(1e-30)).item()
        if ratio > worst:
            worst, worst_name = ratio, k
    print(f"gluon gradients: {len(got)} parameters, {num_layers} layers at "
          f"full width, hybridized (replayed) backward vs ShardedTrainer.step"
          f": worst max abs err / max |grad| {worst:.2e} ({worst_name}, tol "
          f"{GRAD_RTOL}), loss {float(loss.asscalar()):.6f} vs "
          f"{st_loss:.6f}", flush=True)
    check(worst <= GRAD_RTOL, f"Gluon gradients differ: {worst} at "
          f"{worst_name}")
    return {"grads_worst_rel_err": worst, "grads_worst_param": worst_name,
            "grads_layers": num_layers}


def gluon_round_trip() -> dict:
    """``save_parameters`` -> ``load_parameters`` into a fresh BERT-base:
    the forward under ``predict_mode`` is bitwise equal; ``save_states`` /
    ``load_states`` restore the update count."""
    gc.collect()
    ctx, (B, L) = mx.gpu(0), TRAIN_SHAPE
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=L, dropout=0.1, dtype="float32")
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-4})
    batch = [nd.array(a, ctx=ctx) for a in bench.make_batch(B, L)]
    for _ in range(2):
        gluon_step(net, trainer, batch)
    fresh = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                            max_length=L, dropout=0.1, dtype="float32",
                            generator=torch.Generator().manual_seed(7))
    with tempfile.TemporaryDirectory() as tmp:
        pfile, sfile = (os.path.join(tmp, f) for f in ("bert.params",
                                                       "bert.states"))
        net.save_parameters(pfile)
        fresh.load_parameters(pfile, ctx=ctx)
        trainer.save_states(sfile)
        trainer2 = gluon.Trainer(fresh.collect_params(), "adam",
                                 {"learning_rate": 1e-4})
        trainer2.load_states(sfile)
        nbytes = os.path.getsize(pfile)
    with autograd.predict_mode():
        want, got = net(*batch[:4]), fresh(*batch[:4])
    same = all(torch.equal(a._data, b._data) for a, b in zip(want, got))
    check(same, "the forward after a .params round trip is not bitwise "
          "equal")
    check(trainer2.optimizer.num_update == trainer.optimizer.num_update == 2,
          f"load_states restored num_update "
          f"{trainer2.optimizer.num_update}, saved "
          f"{trainer.optimizer.num_update}")
    print(f"gluon round trip: {nbytes} bytes of .params, forward bitwise "
          f"equal, num_update {trainer2.optimizer.num_update} restored",
          flush=True)
    return {"params_file_bytes": nbytes, "round_trip_bitwise": same}


# -- vision: ResNet through the port bench, gates, the LeNet loop ----------
#: device-time groups of a vision step, by kernel name (the first match
#: wins): cuDNN's convolutions (forward, data and weight gradients, and its
#: layout transposes), BatchNorm, pooling, elementwise kernels, the GEMMs
#: of the Dense layer, the optimizer's multi-tensor kernels
VISION_GROUPS = (
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "nchwtonhwc",
              "nhwctonchw", "implicit", "winograd")),
    ("batch_norm", ("batch_norm",)),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise",)),
    ("gemm", ("gemm",)),
    ("optimizer", ("multi_tensor",)),
)
# fused vs eager ResNet steps under deterministic algorithms (float32): the
# same kernels on the same inputs, so losses, weights and running
# statistics agree to within 1e-5 of each tensor's largest value
VISION_GATE_RTOL = 1e-5
# ResNet gradients on the card (cuDNN, IEEE float32) against the CPU's
# (oneDNN/ATen): another summation order through 18 layers: per parameter,
# max abs err <= VISION_GRAD_RTOL * max |grad on the CPU|
VISION_GRAD_RTOL = 1e-3


def group_split(per_kernel: dict, kinds) -> dict:
    """A step's device time by the groups of ``kinds`` ((group, name
    substrings) pairs, the first match wins) and its top kernels."""
    total = sum(per_kernel.values())
    groups = {g: 0.0 for g, _ in kinds}
    groups["other"] = 0.0
    for name, t in per_kernel.items():
        low = name.lower()
        g = next((g for g, keys in kinds
                  if any(k in low for k in keys)), "other")
        groups[g] += t
    top = [{"kernel": k[:90], "ms": t, "share": t / total}
           for k, t in sorted(per_kernel.items(), key=lambda r: -r[1])[:10]]
    return {"profiled_device_ms": total, "kernels": len(per_kernel),
            "ms_by_group": groups,
            "share_by_group": {g: t / total for g, t in groups.items()}
            if total else {}, "top": top}


def grouped_profiled_step(trainer, placed, tag: str, kinds) -> dict:
    """One training step under ``torch.profiler``: wall ms, device ms, idle
    share and the split by the groups of ``kinds``."""
    wall, per_kernel = device_split(lambda: trainer.step(*placed))
    res = {"profiled_step_wall_ms": wall}
    res.update(group_split(per_kernel, kinds))
    busy = res["profiled_device_ms"]
    res["device_idle_share"] = max(0.0, 1.0 - busy / wall) if wall else 0.0
    shares = ", ".join(f"{g} {v:.1%}" for g, v in
                       res["share_by_group"].items())
    print(f"{tag} profile: one step {wall:.3f} ms wall, device busy "
          f"{busy:.3f} ms in {res['kernels']} kernels, idle share "
          f"{res['device_idle_share']:.1%}; device time by group: {shares}",
          flush=True)
    for t in res["top"][:6]:
        print(f"  {t['ms']:9.3f} ms {t['share']:6.1%}  {t['kernel']}",
              flush=True)
    return res


def vision_run(trainer, batch, steps: int, tag: str) -> dict:
    """The port bench's protocol on a ResNet trainer: losses, the first
    and warm steps apart, peak memory, and the flash kernels' launches
    (none: no attention on this path)."""
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    timings = {}
    dt, losses = bench.measure(trainer, batch, steps, timings)
    launches = cuda_ops.launch_counts()
    losses = [float(x) for x in losses]
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(not any(launches.values()), f"{tag}: the vision path launched "
          f"attention kernels: {launches}")
    return {"dt": dt, "losses": losses, "launches": launches,
            "first_step_ms": timings["first_step_s"] * 1e3,
            "warm_step_ms": timings["warm_step_s"] * 1e3,
            "captures": trainer.captures,
            "last_step_graphs": trainer.last_step_graphs,
            "last_path": trainer.last_path,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def vision_bench() -> dict:
    """(a) The port bench's ``resnet`` workload at full size (resnet50_v1,
    bfloat16, batch 32, 224x224; the knobs may change it), through the
    fused and the eager step, timed in turns: imgs/s, step ms, MFU, peak
    memory, and one profiled step of each."""
    t0 = time.perf_counter()
    fused, batch, info = bench.build_resnet("cuda")
    eager, _, _ = bench.build_resnet("cuda", fused=False)
    check(fused.fused and not eager.fused, "the resnet bench's trainer is "
          "not fused by default")
    steps = int(getenv("MXTPU_BENCH_STEPS"))
    runs = {"fused": vision_run(fused, batch, steps, "vision fused"),
            "eager": vision_run(eager, batch, steps, "vision eager")}
    check(runs["fused"]["captures"] == 1
          and runs["fused"]["last_step_graphs"] == 1
          and runs["fused"]["last_path"] == "fused",
          f"vision fused trainer: {runs['fused']['captures']} captures, "
          f"{runs['fused']['last_step_graphs']} graphs in its last step")
    n_params = sum(p.numel() for p in info["net"].parameters())
    record = bench.resnet_result(info, runs["fused"]["dt"],
                                 runs["fused"]["losses"],
                                 runs["fused"]["first_step_ms"] / 1e3)
    print(json.dumps(record), flush=True)
    placed = fused.place(*batch)
    # in turns, after each path's own run: eager, fused
    for name, tr in (("eager", eager), ("fused", fused)):
        runs[name]["step_ms_runs"] = [runs[name]["dt"] * 1e3, synced_ms(
            lambda: tr.step(*placed), steps)[0]]
    card = card_line()
    for name, r in runs.items():
        ms = min(r["step_ms_runs"])
        rec = bench.resnet_result(info, ms / 1e3, r["losses"])
        r.update(step_ms=ms, imgs_per_s=info["batch"] / (ms / 1e3),
                 mfu=rec["extra"]["mfu"])
        print(f"vision {name}: {info['model']} bfloat16 batch "
              f"{info['batch']} at {info['img']}: {ms:.3f} ms per step = "
              f"{r['imgs_per_s']:.1f} imgs/s, MFU {r['mfu']:.4f} (runs "
              f"{[round(t, 3) for t in r['step_ms_runs']]}); first step "
              f"{r['first_step_ms']:.1f} ms, warm step "
              f"{r['warm_step_ms']:.1f} ms; losses {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f}; peak memory "
              f"{r['peak_memory_gib']:.2f} GiB on {card}", flush=True)
    res = {"record": record, "runs": runs, "model": info["model"],
           "batch": info["batch"], "img": info["img"],
           "parameters": n_params,
           "launches": runs["fused"]["launches"]}
    res["profile"] = grouped_profiled_step(fused, placed, "vision fused",
                                           VISION_GROUPS)
    res["profile_eager"] = grouped_profiled_step(eager, placed,
                                                 "vision eager",
                                                 VISION_GROUPS)
    print(f"vision: trainers built and run in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del fused, eager, placed, info
    return res


def _resnet_trainer(device, fused, B: int = 8, img: int = 64):
    """resnet18_v1 (1000 classes, float32, Xavier from seed 0, shapes
    deferred to the first step), the bench's SGD, and a batch from
    ``RandomState(1)``."""
    net = gluon.model_zoo.vision.get_model("resnet18_v1", classes=1000)
    net.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(
        0)), ctx=mx.Context.from_device(torch.device(device)))
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = parallel.ShardedTrainer(
        net, lambda out, label: ce(out, label), "sgd",
        {"learning_rate": 0.05, "momentum": 0.9}, device=device,
        n_labels=1, fused=fused)
    rng = onp.random.RandomState(1)
    batch = (rng.randn(B, 3, img, img).astype("float32"),
             rng.randint(0, 1000, (B,)).astype("float32"))
    return net, tr, batch


def _rel_errs(nets, pick) -> list:
    """``(max |a - b| / max |b|, name)`` per parameter of two nets, of the
    tensors ``pick(param)`` (skipped where either is None), largest
    first."""
    n0, n1 = len(nets[0].prefix), len(nets[1].prefix)
    by_suffix = {k[n1:]: p for k, p in nets[1].collect_params().items()}
    rows = []
    for k, p in nets[0].collect_params().items():
        a, b = pick(p), pick(by_suffix[k[n0:]])
        if a is None or b is None:
            continue
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        scale = b.abs().max().item()
        if scale == 0.0:
            check(a.abs().max().item() == 0.0, f"{k}: nonzero where the "
                  "reference is zero")
            continue
        rows.append(((a - b).abs().max().item() / scale, k))
    return sorted(rows, reverse=True) or [(0.0, "")]


def _worst(nets, pick) -> tuple:
    """The largest of :func:`_rel_errs` and its parameter's name."""
    return _rel_errs(nets, pick)[0]


def vision_fused_gate(steps: int = 3) -> dict:
    """(b) The fused ResNet step against the eager one (resnet18_v1,
    float32, batch 8, 64x64) under ``torch.use_deterministic_algorithms``:
    losses, weights and running statistics after ``steps`` steps."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    try:
        pairs = [_resnet_trainer("cuda", fused) for fused in (None, False)]
        losses = [[float(tr.step(*batch)) for _ in range(steps)]
                  for _, tr, batch in pairs]
    finally:
        torch.use_deterministic_algorithms(False)
    nets = [p[0] for p in pairs]
    check(pairs[0][1].last_path == "fused"
          and pairs[0][1].last_step_graphs == 1
          and pairs[1][1].last_path == "eager",
          "the vision gate's trainers did not take the fused and the eager "
          "step")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    weights, wname = _worst(nets, lambda p: p._var)
    print(f"vision gate: resnet18_v1 float32 batch 8 at 64, {steps} steps, "
          f"fused vs eager under deterministic algorithms: losses "
          f"{losses[0]} vs {losses[1]} (worst rel err {loss_err:.2e}); "
          f"weights and running statistics worst rel err {weights:.2e} "
          f"({wname}), tol {VISION_GATE_RTOL}", flush=True)
    check(loss_err <= VISION_GATE_RTOL and weights <= VISION_GATE_RTOL,
          f"fused and eager ResNet steps differ: losses {loss_err}, weights "
          f"{weights} at {wname}")
    return {"losses_fused": losses[0], "losses_eager": losses[1],
            "loss_rel_err": loss_err, "weights_worst_rel_err": weights,
            "weights_worst_param": wname,
            "bitwise": loss_err == 0.0 and weights == 0.0}


def vision_grads_vs_cpu() -> dict:
    """(c) One ResNet step's gradients on the card, the fused and the
    eager step, against the same step on the CPU: resnet18_v1, float32,
    batch 8, 64x64, the same weights and batch."""
    gc.collect()
    runs = {}
    for name, device, fused in (("fused", "cuda", None),
                                ("eager", "cuda", False),
                                ("cpu", "cpu", None)):
        net, tr, batch = _resnet_trainer(device, fused)
        runs[name] = (net, float(tr.step(*batch)))
    cpu_net, cpu_loss = runs.pop("cpu")
    res = {"loss_cpu": cpu_loss}
    for name, (net, loss) in runs.items():
        rows = _rel_errs([net, cpu_net], lambda p: p._var.grad)
        stats = _worst([net, cpu_net], lambda p: p._var
                       if p.grad_req == "null" else None)
        worst, wname = rows[0]
        print(f"vision gradients, {name} step: resnet18_v1 float32 batch 8 "
              f"at 64, one step on the card vs on the CPU: loss "
              f"{loss:.6f} vs {cpu_loss:.6f}; max abs err / max |grad|, "
              f"worst three: "
              + ", ".join(f"{r:.2e} ({k})" for r, k in rows[:3])
              + f" (tol {VISION_GRAD_RTOL}); running statistics worst rel "
              f"err {stats[0]:.2e} ({stats[1]})", flush=True)
        check(worst <= VISION_GRAD_RTOL, f"ResNet gradients of the {name} "
              f"step on the card differ from the CPU's: {worst} at {wname}")
        check(abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss),
              f"ResNet losses differ: card {loss}, CPU {cpu_loss}")
        res[name] = {"loss_card": loss, "grads_worst_rel_err": worst,
                     "grads_worst_param": wname,
                     "running_stats_worst_rel_err": stats[0]}
    return res


def vision_lenet_gate(epochs: int = 10) -> dict:
    """(d) The Gluon LeNet loop of the reference's gate
    (``tests/test_train.py:28-62``) on the card: ``io.NDArrayIter`` over
    the 8x8 digits (``chip_data/digits.npz``, sklearn's bundled copy) ->
    hybridized conv net (CUDA graphs) -> ``autograd.record()`` ->
    ``gluon.Trainer`` (Adam) -> ``metric.Accuracy`` on the held-out
    rows, which must reach 0.95."""
    here = os.path.dirname(os.path.abspath(__file__))
    data = onp.load(os.path.join(here, "chip_data", "digits.npz"))
    X = data["images"].astype("float32")[:, None] / 16.0
    Y = data["target"].astype("float32")
    idx = onp.random.RandomState(42).permutation(len(X))
    X, Y = X[idx], Y[idx]
    Xtr, Ytr, Xte, Yte = X[:1500], Y[:1500], X[1500:], Y[1500:]
    t0 = time.perf_counter()
    mx.random.seed(42)
    onp.random.seed(42)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(16, 3, padding=1, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
            gluon.nn.MaxPool2D(2, 2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(128, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 3e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    it = mx.io.NDArrayIter(Xtr, Ytr, batch_size=100, shuffle=True,
                           last_batch_handle="discard")
    cuda_ops.reset_launches()
    for _ in range(epochs):
        it.reset()
        for batch in it:
            with autograd.record():
                out = net(batch.data[0])
                loss = loss_fn(out, batch.label[0]).mean()
            loss.backward()
            trainer.step(100)
    acc = mx.metric.Accuracy()
    with autograd.predict_mode():
        acc.update(nd.array(Yte), net(nd.array(Xte)))
    launches = cuda_ops.launch_counts()
    value = acc.get()[1]
    replayed = [op for op in net._cached_ops.values()
                if op.fwd is not None]
    print(f"vision lenet: {epochs} epochs of 15 batches on the card, "
          f"hybridized ({len(replayed)} captured signature(s)), last loss "
          f"{float(loss.asscalar()):.4f}, held-out accuracy {value:.4f} "
          f"(gate 0.95), {time.perf_counter() - t0:.1f} s", flush=True)
    check(value >= 0.95, f"LeNet held-out accuracy {value} < 0.95")
    check(bool(replayed) and all(op.bwd is not None for op in replayed
                                 if op.recording),
          "the hybridized LeNet captured no graph")
    check(batch.data[0].context == mx.gpu(0), "the iterator's batches are "
          "not on the card")
    check(not any(launches.values()), f"the LeNet loop launched attention "
          f"kernels: {launches}")
    return {"accuracy": value, "epochs": epochs,
            "captured_signatures": len(replayed), "launches": launches}


def phase_vision() -> dict:
    """The vision path: (a) the bench, (b) fused against eager, (c) card
    against CPU, (d) the LeNet gate."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {"bench": vision_bench()}
    res["fused_gate"] = vision_fused_gate()
    res["grads_vs_cpu"] = vision_grads_vs_cpu()
    res["lenet"] = vision_lenet_gate()
    res["launches"] = res["bench"]["launches"]
    return res


# -- Transformer NMT and decode serving ---------------------------------------
# Transformer-big (Vaswani et al. 2017, Table 3 "big"; §5.1: a shared
# source-target vocabulary of about 37,000 tokens); the NMT phases train,
# decode and serve it at full width, with seeded random weights
NMT_VOCAB = 37000
NMT_CFG = dict(units=1024, hidden_size=4096, num_heads=16)
NMT_LAYERS = 6
# training batch: 32 pairs, source 128 (valid 32-128), target 112 (the
# cross-attention runs at Lq != Lk on purpose)
NMT_BATCH, NMT_SRC, NMT_TGT = 32, 128, 112
NMT_MAX_LEN = 256
# the masked cross-attention shapes of the kernel phases: target 112 over
# source 128, and 128 over 96
NMT_CROSS = ((NMT_TGT, NMT_SRC), (128, 96))
NMT_STEPS = 10
# the MT gate's attention shapes (models/nmt.py MT_CONFIG: batch 32, units
# 64 over 4 heads, source 5, target 6): encoder 5 over 5, decoder causal 6
# over 6, cross-attention 6 over 5 (unmasked in the loop; also masked)
MT_BATCH, MT_HEADS, MT_HEAD_DIM = 32, 4, 16
MT_CASES = ((5, 5, "none"), (6, 6, "causal"), (6, 5, "none"), (6, 5, "mask"))
# three attention calls per layer pair: encoder, causal, cross
NMT_CALLS = 3 * NMT_LAYERS
NMT_GROUPS = (
    ("flash", ("flash_",)),
    ("gemm", ("gemm",)),
    ("optimizer", ("multi_tensor",)),
    ("elementwise", ("elementwise", "reduce", "softmax", "index", "gather",
                     "scatter", "cat")),
)
# KV-cache decode (contiguous and paged) vs the full decoder forward on the
# kernels, float32: the same function summed in another order (one query
# row against the whole prefix), per position max abs err over max |logit|
DECODE_RTOL = 1e-3
# the NMT gradient check: ReLU pre-activations that the kernel and plain
# paths round to opposite signs, as a share of all FFN units, at most this
# (float32 rounding flips a few in ten million); the free comparison keeps
# at least this many of the 32 sequences
NMT_FLIP_SHARE = 1e-5
NMT_GRAD_MIN_CLEAN = NMT_BATCH // 4
# a greedy token that differs between two float32 paths is a fault only if
# the two tokens' logits differ by more than this
FLIP_MARGIN = 1e-3


def nmt_model(num_layers: int = NMT_LAYERS, dropout: float = 0.1,
              seed: int = 0):
    """Transformer-big on the card, Xavier weights from ``seed``."""
    net = models.NMTModel(NMT_VOCAB, NMT_VOCAB, num_layers=num_layers,
                          dropout=dropout, max_length=NMT_MAX_LEN, **NMT_CFG)
    net.initialize(mx.init.Xavier(
        generator=torch.Generator().manual_seed(seed)), ctx=mx.gpu(0))
    return net


def nmt_batch(seed: int = 0) -> tuple:
    """``(src, target input, src valid length, label)`` from ``seed``:
    the target input is BOS + the label shifted by one."""
    rng = onp.random.RandomState(seed)
    src = rng.randint(3, NMT_VOCAB, (NMT_BATCH, NMT_SRC)).astype("int32")
    valid = rng.randint(32, NMT_SRC + 1, NMT_BATCH).astype("float32")
    tgt = rng.randint(3, NMT_VOCAB, (NMT_BATCH, NMT_TGT + 1)).astype("int32")
    tgt[:, 0] = nmt.BOS
    return src, tgt[:, :-1].copy(), valid, tgt[:, 1:].copy()


def nmt_trainer(net, fused):
    return parallel.ShardedTrainer(net, nmt.label_smoothed_ce, "adam",
                                   {"learning_rate": 1e-4}, device="cuda",
                                   n_labels=1, fused=fused)


def nmt_grads(num_layers: int = 2) -> dict:
    """One step's gradients at full width and ``num_layers`` + ``num_layers``
    layers (float32, dropout 0) on the kernels against the same step with
    ``MXTPU_ATTN_IMPL=xla``: every entry within :data:`GRAD_RTOL` of its
    parameter's largest gradient, in two comparisons.

    The FFN's ReLU makes the gradient a discontinuous function of the
    forward: a pre-activation within the two paths' rounding of 0 may take
    another sign in each, and then that token's whole contribution moves
    between the two gradients (of its ``ffn1`` row, and through the
    attention of every earlier parameter, the embedding rows of its
    sequence at full strength). Sequences do not mix in the forward, so
    such a flip moves only its own sequence's share of the gradient.

    * pinned: the whole batch, the plain path's ReLUs taking the kernel
      path's signs (a forward hook; the values differ from a free ReLU
      only where the pre-activation is within that rounding of 0);
    * free: both paths with free ReLUs, the loss of every sequence that
      holds a flip weighted 0, so that the gradients are those of the
      other sequences alone; a sequence that flips in this run too is
      dropped as well, up to three rounds, and at least
      :data:`NMT_GRAD_MIN_CLEAN` sequences must stay.

    The flips of the free full-batch step must be at most
    :data:`NMT_FLIP_SHARE` of all FFN units."""
    net = nmt_model(num_layers, dropout=0.0)
    src, tgt, valid, label = (torch.from_numpy(a).cuda()
                              for a in nmt_batch(1))
    acts = {n: m for n, m in net.named_modules()
            if n.endswith("ffn.ffn1.act")}
    signs, pinned = {}, {}

    def record(name):
        def hook(mod, args, out):
            x = args[0]
            signs[name] = x.detach() > 0
            if name in pinned:
                return x * pinned[name].to(x.dtype)
            return out
        return hook

    for name, m in acts.items():
        m.register_forward_hook(record(name))

    def step(weight=None):
        net.zero_grad(set_to_none=True)
        per_token = nmt.label_smoothed_ce(net(src, tgt, valid), label)
        if weight is None:
            loss = per_token.mean()
        else:               # per sequence; all ones is the mean
            loss = ((per_token * weight[:, None]).sum()
                    / (weight.sum() * per_token.shape[1]))
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in net.named_parameters()}, dict(signs)

    def plain_step(weight=None):
        os.environ["MXTPU_ATTN_IMPL"] = "xla"
        try:
            return step(weight)
        finally:
            del os.environ["MXTPU_ATTN_IMPL"]

    def flipped_rows(sa, sb):
        """Sequences (batch rows) that hold a ReLU of another sign."""
        rows = torch.zeros(NMT_BATCH, dtype=torch.bool, device="cuda")
        for n in acts:
            rows |= (sa[n] != sb[n]).flatten(1).any(1)
        return rows

    def worst_of(grads, want):
        worst, worst_name = 0.0, ""
        for name, gx in want.items():
            ratio = ((grads[name] - gx).abs().max()
                     / gx.abs().max().clamp_min(1e-30)).item()
            if ratio > worst:
                worst, worst_name = ratio, name
        return worst, worst_name

    cuda_ops.reset_launches()
    loss_k, grads_k, signs_k = step()
    launches = cuda_ops.launch_counts()
    for name, n in launches.items():
        check(n == 3 * num_layers, f"nmt gradients: {name} launched {n} "
              f"times in one step of {num_layers} + {num_layers} layers")
    loss_f, grads_f, signs_f = plain_step()
    pinned.update(signs_k)
    try:
        loss_x, grads_x, _ = plain_step()
    finally:
        pinned.clear()
    flips = {n: int((signs_k[n] != signs_f[n]).sum()) for n in acts}
    units = sum(signs_k[n].numel() for n in acts)
    share = sum(flips.values()) / units
    worst, worst_name = worst_of(grads_k, grads_x)
    free, free_name = worst_of(grads_k, grads_f)
    # the free comparison on the sequences that hold no flip
    keep = ~flipped_rows(signs_k, signs_f)
    rounds, settled = [], False
    clean, clean_name, loss_c = float("inf"), "", None
    while len(rounds) < 3 and int(keep.sum()) >= NMT_GRAD_MIN_CLEAN:
        weight = keep.float()
        _, grads_kc, signs_kc = step(weight)
        loss_c, grads_xc, signs_xc = plain_step(weight)
        rounds.append(int(keep.sum()))
        again = flipped_rows(signs_kc, signs_xc) & keep
        if not again.any():
            clean, clean_name = worst_of(grads_kc, grads_xc)
            settled = True
            break
        keep &= ~again
    kept = int(keep.sum())
    check(cuda_ops.launch_counts() == {
        n: c * (1 + len(rounds)) for n, c in launches.items()},
        "impl='xla' reached a kernel")
    print(f"nmt gradients: {len(grads_x)} parameters, {num_layers} + "
          f"{num_layers} layers at full width, kernels vs plain attention "
          f"with the kernels' ReLU signs: worst max abs err / max |grad| "
          f"{worst:.2e} ({worst_name}, tol {GRAD_RTOL}), loss "
          f"{loss_k:.6f} vs {loss_x:.6f}; free ReLUs, whole batch: "
          f"{free:.2e} ({free_name}) from {sum(flips.values())} sign flips "
          f"of {units} units (share {share:.2e}, tol {NMT_FLIP_SHARE}) "
          f"{flips}; free ReLUs on the {kept} of {NMT_BATCH} sequences "
          f"without a flip (rounds {rounds}): {clean:.2e} ({clean_name}, "
          f"tol {GRAD_RTOL})", flush=True)
    check(worst <= GRAD_RTOL, f"nmt gradients differ: {worst} at "
          f"{worst_name}")
    check(share <= NMT_FLIP_SHARE, f"nmt gradients: ReLU sign flips "
          f"{share:.2e} of all FFN units, beyond {NMT_FLIP_SHARE}")
    check(settled, f"nmt gradients: {kept} sequences without a flip after "
          f"{len(rounds)} rounds, {NMT_GRAD_MIN_CLEAN} needed")
    check(clean <= GRAD_RTOL, f"nmt gradients (free ReLUs, sequences "
          f"without a flip) differ: {clean} at {clean_name}")
    return {"layers": num_layers, "worst_rel_err": worst,
            "worst_param": worst_name, "free_relu_rel_err": free,
            "free_relu_param": free_name, "relu_sign_flips": flips,
            "relu_units": units, "relu_flip_share": share,
            "clean_rel_err": clean, "clean_param": clean_name,
            "clean_sequences": kept, "clean_rounds": rounds,
            "loss_kernels": loss_k, "loss_plain": loss_x,
            "loss_plain_free": loss_f, "loss_plain_clean": loss_c,
            "launches": launches}


def phase_nmt_train() -> dict:
    """Transformer-big trained through ``ShardedTrainer`` (Adam, lr 1e-4,
    float32, dropout 0.1, label-smoothed cross-entropy) on the three
    kernels: the fused and the eager step, timed in turns; losses finite
    and falling, 18 launches per kernel per step, one profiled step of
    each; then the gradient check."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch = nmt_batch(0)
    trainers = {"fused": nmt_trainer(nmt_model(), None),
                "eager": nmt_trainer(nmt_model(), False)}
    check(trainers["fused"].fused and not trainers["eager"].fused,
          "the NMT trainer is not fused by default")
    n_params = sum(p.numel() for p in trainers["fused"]._block.parameters())
    print(f"nmt train: Transformer-big ({n_params} parameters, vocab "
          f"{NMT_VOCAB}), batch {NMT_BATCH}, source {NMT_SRC}, target "
          f"{NMT_TGT}; trainers built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = {}
    for name, tr in trainers.items():
        runs[name] = train_run(tr, batch, NMT_STEPS, NMT_CALLS,
                               f"nmt {name}")
    placed = trainers["fused"].place(*batch)
    for name in ("eager", "fused"):   # in turns, after each path's run
        tr = trainers[name]
        runs[name]["step_ms_runs"] = [runs[name]["dt"] * 1e3, synced_ms(
            lambda: tr.step(*placed), NMT_STEPS)[0]]
    card = card_line()
    tokens = NMT_BATCH * NMT_TGT
    for name, r in runs.items():
        ms = min(r["step_ms_runs"])
        r["step_ms"], r["tgt_tokens_per_s"] = ms, tokens / (ms / 1e3)
        print(f"nmt train {name}: {ms:.3f} ms per step = "
              f"{r['tgt_tokens_per_s']:.1f} target tokens/s (runs "
              f"{[round(t, 3) for t in r['step_ms_runs']]}), first step "
              f"{r['first_step_ms']:.1f} ms, warm step "
              f"{r['warm_step_ms']:.1f} ms, captures {r['captures']}, "
              f"losses {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, "
              f"launches {r['launches']}, peak memory "
              f"{r['peak_memory_gib']:.2f} GiB on {card}", flush=True)
    check(runs["fused"]["captures"] == 1
          and runs["fused"]["last_step_graphs"] == 1,
          f"nmt fused trainer: {runs['fused']['captures']} captures")
    res = {"parameters": n_params, "runs": runs,
           "launches": runs["fused"]["launches"],
           "launches_eager": runs["eager"]["launches"]}
    for name, tr in trainers.items():
        res[f"profile_{name}"] = grouped_profiled_step(
            tr, placed, f"nmt {name}", NMT_GROUPS)
    del trainers, placed
    gc.collect()
    torch.cuda.empty_cache()
    res["gradients"] = nmt_grads()
    return res


def _prefix(seed: int, n: int) -> tuple:
    """A seeded source (one row, valid 96 of 128) and target prefix of
    ``n`` tokens starting with BOS."""
    rng = onp.random.RandomState(seed)
    src = rng.randint(3, NMT_VOCAB, (1, NMT_SRC)).astype("int32")
    tgt = rng.randint(3, NMT_VOCAB, (1, n)).astype("int32")
    tgt[0, 0] = nmt.BOS
    return src, onp.array([96.0], "float32"), tgt


def forced_logits(net, src, valid, tgt) -> dict:
    """The logits of every position of the target prefix ``tgt (1, n)``
    through the contiguous-cache step, the paged step (the pages scattered
    over a pool) and the full decoder forward on the kernels."""
    n = tgt.shape[1]
    dev = torch.device("cuda")
    s, v, t = (torch.from_numpy(a).to(dev) for a in (src, valid, tgt))
    params = nmt.incremental_decode_params(net)
    NL, U = len(params["layers"]), net._units
    with torch.no_grad(), autograd.predict_mode():
        mem, mask = net.encode(s, v)
        cross = nmt.cross_attention_kv(params, mem)
        key_mask = mask[:, 0, 0, :] > 0
        full = fully_connected_logits(net, net.decoder(
            net.tgt_embed(t), mem, mask))[0]
        ck = torch.zeros((NL, 1, n, U), device=dev)
        cv = torch.zeros_like(ck)
        bs = 16
        nb = -(-n // bs)
        pool = (4 * nb + 1, NL, bs, U)
        pk, pv = torch.zeros(pool, device=dev), torch.zeros(pool, device=dev)
        # pages scattered over the pool, none of them the scratch page 0
        table = torch.from_numpy(onp.random.RandomState(7).permutation(
            onp.arange(1, 4 * nb + 1))[:nb].astype("int32"))[None].to(dev)
        cont, paged = [], []
        for i in range(n):
            pos = torch.tensor([i], dtype=torch.int32, device=dev)
            tok = t[:, i]
            lc, _, _ = nmt.nmt_step(params, ck, cv, cross, key_mask, tok, pos)
            lp, _, _ = nmt.nmt_paged_step(params, bs, pk, pv, table, pos,
                                          tok, cross, key_mask)
            cont.append(lc[0])
            paged.append(lp[0])
    return {"full": full, "contiguous": torch.stack(cont),
            "paged": torch.stack(paged)}


def fully_connected_logits(net, out):
    return fully_connected(out, net.proj_weight._tensor(),
                           net.proj_bias._tensor(), flatten=False)


def phase_nmt_decode(net) -> dict:
    """The KV cache against the full re-decode at full width: a seeded
    prefix of 32 tokens forced through both cache layouts and the full
    decoder; then ``beam_search`` (K = 4) against ``beam_search_reference``
    on 4 prompts."""
    src, valid, tgt = _prefix(3, 32)
    got = forced_logits(net, src, valid, tgt)
    scale = got["full"].abs().max().item()
    errs = {k: (got[k] - got["full"]).abs().max().item() / scale
            for k in ("contiguous", "paged")}
    print(f"nmt decode: 32 forced positions, max abs err / max |logit| "
          f"({scale:.3f}): contiguous {errs['contiguous']:.2e}, paged "
          f"{errs['paged']:.2e} (tol {DECODE_RTOL})", flush=True)
    for k, e in errs.items():
        check(e <= DECODE_RTOL, f"nmt decode: the {k} cache's logits "
              f"differ from the full re-decode by {e} of the largest")
    rng = onp.random.RandomState(4)
    srcs = rng.randint(3, NMT_VOCAB, (4, NMT_SRC)).astype("int32")
    valids = onp.array([128.0, 100.0, 64.0, 17.0], "float32")
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    seqs, scores = nmt.beam_search(net, srcs, valids, beam_size=4,
                                   max_length=32)
    torch.cuda.synchronize()
    t_beam = time.perf_counter() - t0
    beam_launches = cuda_ops.launch_counts()
    t0 = time.perf_counter()
    rseqs, rscores = nmt.beam_search_reference(net, srcs, valids,
                                               beam_size=4, max_length=32)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    seqs, rseqs = seqs.cpu().numpy(), rseqs.cpu().numpy()
    diverge = []
    for b in range(seqs.shape[0]):
        for k in range(seqs.shape[1]):
            d = onp.nonzero(seqs[b, k] != rseqs[b, k])[0]
            if len(d):
                diverge.append({"row": b, "beam": k, "position": int(d[0])})
    print(f"nmt beam search (K=4, max_length 32, 4 prompts): cached "
          f"{t_beam:.3f} s, full re-decode {t_ref:.3f} s; scores "
          f"{scores.cpu().numpy().round(4).tolist()} vs "
          f"{rscores.cpu().numpy().round(4).tolist()}; first divergence "
          f"{diverge[:4] if diverge else 'none'}", flush=True)
    print(f"nmt beam search best sequences: {seqs[:, 0].tolist()}",
          flush=True)
    return {"rel_err": errs, "max_abs_logit": scale,
            "beam_seconds": t_beam, "reference_seconds": t_ref,
            "beam_launches": beam_launches,
            "sequences_equal": not diverge, "divergences": diverge,
            "scores": scores.cpu().numpy().tolist(),
            "reference_scores": rscores.cpu().numpy().tolist()}


def decode_drive(batcher, reqs, threads: int) -> dict:
    """Submit every request (from ``threads`` client threads, or all from
    this one when 0) and wait for every stream."""
    n = len(reqs)
    streams, errors = [None] * n, []
    batcher.metrics.reset()

    def client(idx, step):
        try:
            for i in range(idx, n, step):
                streams[i] = batcher.submit(reqs[i][0],
                                            max_new_tokens=reqs[i][1])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    if threads:
        ts = [threading.Thread(target=client, args=(c, threads))
              for c in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        check(not any(t.is_alive() for t in ts), "client threads hung")
    else:
        client(0, 1)
    check(not errors, f"submit failed: {errors[:3]}")
    outs = [s.result(timeout=600) for s in streams]
    wall = time.perf_counter() - t0
    snap = batcher.metrics.snapshot()
    check(snap["requests"] == n and snap["failed"] == 0
          and all(s.done() for s in streams),
          f"decode served {snap['requests']}/{n}, failed {snap['failed']}")
    return {"outs": outs, "wall_s": wall, "snapshot": snap,
            "tokens": sum(len(o) for o in outs)}


def step_ms(engine) -> dict:
    """The decode step's device ms by CUDA events: the replayed graph
    against the same step run eagerly, in turns."""
    res = {"replay_ms": [], "eager_ms": []}
    for _ in range(2):
        res["eager_ms"].append(cuda_ms(engine._step))
        res["replay_ms"].append(cuda_ms(engine._graph.replay))
    return res


def greedy_margin(net, src, valid, tokens, step: int) -> dict:
    """Top-2 logit margins at ``step`` of the greedy path ``tokens``
    forced through the paged step (the batcher's) and the contiguous one
    (``beam_search``'s)."""
    tgt = onp.array([[nmt.BOS] + list(tokens[:step])], "int32")
    got = forced_logits(net, src, valid, tgt)
    out = {}
    for k in ("paged", "contiguous"):
        top = torch.topk(got[k][step], 2).values
        out[k] = (top[0] - top[1]).item()
    return out


def phase_nmt_serve(net, seed: int) -> dict:
    """``DecodeBatcher`` over ``DecodeEngine`` at full width: 256 ragged
    requests from 4 threads, then all at once; the warm contract, the
    kernels' launches, the capacity, and greedy tokens against
    ``beam_search(K=1)``."""
    table = serve.BucketTable({"batch": (1, 1), "src": (8, NMT_SRC)})
    t0 = time.perf_counter()
    engine = serve.DecodeEngine(net, table, max_batch=32, block_size=16,
                                max_target_len=128)
    cap = engine.capacity
    check(cap["max_sequences"] == engine.pool.admission_limit()
          and engine.capacity_report() == cap,
          f"capacity {cap} vs admission limit "
          f"{engine.pool.admission_limit()}")
    cuda_ops.reset_launches()
    warm = engine.warmup()
    warm_launches = cuda_ops.launch_counts()
    print(f"nmt serve: engine built and warmed in "
          f"{time.perf_counter() - t0:.1f} s: {warm}", flush=True)
    # a budget that prices fewer seats than rows: the measured fixed bytes
    # plus the pages of 16 sequences and a margin
    per_seq = (serve.decode.block_bytes(NMT_LAYERS, NMT_CFG["units"], 16)
               * cap["blocks_per_seq"])
    budget = engine._fixed_bytes() + 16 * per_seq + per_seq // 2
    priced = serve.DecodeEngine(net, table, max_batch=32, block_size=16,
                                max_target_len=128, hbm_budget=budget)
    pcap = priced.capacity
    check(pcap["max_sequences"] == priced.pool.admission_limit()
          and priced.capacity_report() == pcap
          and 1 <= pcap["max_sequences"] <= 32,
          f"priced capacity {pcap} vs admission limit "
          f"{priced.pool.admission_limit()}")
    print(f"nmt serve: capacity {cap}; with a budget of {budget} bytes "
          f"{pcap}", flush=True)
    del priced
    rng = onp.random.RandomState(seed)
    reqs = [(rng.randint(3, NMT_VOCAB, int(rng.randint(8, 128))).astype(
        "int32"), int(rng.randint(16, 128))) for _ in range(256)]
    batcher = serve.DecodeBatcher(engine).start()
    cuda_ops.reset_launches()
    try:
        runs = {"threads": decode_drive(batcher, reqs, 4),
                "burst": decode_drive(batcher, reqs, 0)}
        launches = cuda_ops.launch_counts()
        probe = [reqs[i][0] for i in range(4)]
        greedy = [batcher.submit(p, max_new_tokens=31).result(timeout=600)
                  for p in probe]
    finally:
        batcher.stop()
    st = engine.stats()
    check(st["decode"]["post_warmup_compiles"] == 0
          and st["prefill"]["post_warmup_compiles"] == 0,
          f"post-warmup captures or first runs: {st}")
    check(launches[fa.KERNEL] > 0 and warm_launches[fa.KERNEL] > 0,
          f"prefill launched no forward kernel: {launches}")
    for name in (fa.KERNEL_BWD_DKV, fa.KERNEL_BWD_DQ):
        check(launches[name] == 0 and warm_launches[name] == 0,
              f"decode serving launched the backward kernel {name}")
    flips = []
    for p, got in zip(probe, greedy):
        valid = onp.array([float(len(p))], "float32")
        seqs, _ = nmt.beam_search(net, p[None], valid, beam_size=1,
                                  max_length=32)
        ref = [int(x) for x in seqs[0, 0].cpu().numpy()]
        n = min(len(got), len(ref))
        d = [i for i in range(n) if got[i] != ref[i]]
        if d:
            src = onp.zeros((1, NMT_SRC), "int32")
            src[0, :len(p)] = p
            margin = greedy_margin(net, src, valid, got, d[0])
            flips.append({"step": d[0], "batcher": got[d[0]],
                          "beam": ref[d[0]], "margin": margin})
            check(max(margin.values()) <= FLIP_MARGIN,
                  f"greedy tokens differ at step {d[0]} with top-2 margins "
                  f"{margin} above {FLIP_MARGIN}")
    timing = step_ms(engine)
    card = card_line()
    res = {"warmup": warm, "capacity": cap, "priced_capacity": pcap,
           "stats": st, "launches": launches,
           "warm_launches": warm_launches, "greedy_flips": flips,
           "step": timing}
    for name, r in runs.items():
        m = r["snapshot"]
        res[name] = {"wall_s": r["wall_s"], "tokens": r["tokens"],
                     "tokens_per_s": r["tokens"] / r["wall_s"],
                     "itl": m["itl"], "ttft": m["ttft"],
                     "step_occupancy": m["step_occupancy"],
                     "steps": m["steps"]}
        print(f"nmt serve {name}: {len(reqs)} streams, {r['tokens']} tokens "
              f"in {r['wall_s']:.3f} s = {res[name]['tokens_per_s']:.1f} "
              f"tokens/s, ITL p50 {m['itl']['itl_ms_p50']} p99 "
              f"{m['itl']['itl_ms_p99']} ms, TTFT p50 "
              f"{m['ttft']['ttft_ms_p50']} ms, occupancy "
              f"{m['step_occupancy']}, {m['steps']} steps on {card}",
              flush=True)
    print(f"nmt serve: decode step {min(timing['replay_ms']):.4f} ms "
          f"replayed vs {min(timing['eager_ms']):.4f} ms eager (CUDA events,"
          f" runs {timing}); pool {st['pool']}; launches {launches}; "
          f"greedy flips {flips or 'none'}", flush=True)
    return res


def phase_mt_gate() -> dict:
    """The JAX package's ``examples/machine_translation.py`` loop with its
    tier-1 configuration (copy task, 300 steps, seq-len 5, vocab 12,
    lr 0.002, batch 32; Adam through ``gluon.Trainer``, label smoothing
    0.1) on the card, then ``beam_search`` (K = 4): exact match above 0.8,
    as the reference asserts."""
    t0 = time.perf_counter()
    cuda_ops.reset_launches()
    out = nmt.mt_example(ctx=mx.gpu(0))
    launches = cuda_ops.launch_counts()
    print(f"mt gate: 300 steps, loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, beam-search exact match "
          f"{out['accuracy']:.4f} (gate 0.8), launches {launches}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(out["accuracy"] > 0.8, f"MT exact match {out['accuracy']} <= 0.8")
    check(all(n > 0 for n in launches.values()),
          f"the MT loop did not run every kernel: {launches}")
    return {"accuracy": out["accuracy"], "first_loss": out["losses"][0],
            "last_loss": out["losses"][-1], "launches": launches}


def phase_nmt(seed: int) -> dict:
    res = {"train": phase_nmt_train()}
    gc.collect()
    torch.cuda.empty_cache()
    net = nmt_model(dropout=0.0, seed=1)
    res["decode"] = phase_nmt_decode(net)
    res["serve"] = phase_nmt_serve(net, seed)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    res["mt_gate"] = phase_mt_gate()
    return res


# -- detection: SSD and Faster-RCNN ------------------------------------------
#: device-time groups of a detection step, by kernel name (the first match
#: wins): cuDNN's convolutions, the detection ops' sorts, scatters, gathers
#: and argmax reductions (cub radix sorts, ``scatter_gather``, ``index``
#: kernels), the optimizer's multi-tensor kernels, elementwise kernels, the
#: other reductions, pooling and GEMMs
DET_GROUPS = (
    ("conv", VISION_GROUPS[0][1]),
    ("sort_scatter_gather", ("sort", "radix", "scatter", "gather", "index",
                             "argmax", "argmin")),
    ("optimizer", ("multi_tensor",)),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
    ("pooling", ("pool",)),
    ("gemm", ("gemm",)),
)
# the detection ops on the card against the same port code on the CPU: the
# float outputs come from the same IEEE operations, but exp/log may differ
# in the last ulp between the two libraries; integer and boolean outputs
# (kept rows, matches, labels, the picked scores) must be equal
DET_OP_RTOL = 1e-5
DET_OP_ATOL = {"loc_target": 1e-5, "rois": 1e-3, "roi_align": 1e-5}
# one step's gradients of a small SSD / Faster-RCNN on the card against the
# CPU's: per parameter, max abs err <= DET_GRAD_RTOL * max |grad on CPU|
DET_GRAD_RTOL = 1e-3
#: the example gates' thresholds (``tests/test_examples.py:72-87``)
SSD_GATE, FRCNN_GATE = 0.8, 0.25
#: the small size of the fused-vs-eager gate and the gradient check
DET_SMALL = {"MXTPU_BENCH_BATCH": "2", "MXTPU_BENCH_IMG": "64"}


def _on(device, *arrays):
    return [torch.as_tensor(a).to(device) for a in arrays]


def _same_ints(name, card, cpu) -> int:
    """Check ``card == cpu`` exactly; returns the count of elements."""
    card = card.cpu()
    diff = (card != cpu).sum().item()
    check(diff == 0, f"{name}: {diff} of {cpu.numel()} elements differ "
          "between the card and the CPU")
    return cpu.numel()


def _close(name, card, cpu, atol) -> float:
    err = (card.cpu() - cpu).abs().max().item() if cpu.numel() else 0.0
    tol = atol + DET_OP_RTOL * cpu.abs().max().item()
    check(err <= tol, f"{name}: card vs CPU max abs err {err} > {tol}")
    return err


def det_ops_card_vs_cpu() -> dict:
    """(a) The detection ops at full-width shapes, the card against the CPU
    on the same inputs: ``multibox_target`` over SSD-300's 29,596 anchors
    (16 images, up to 4 boxes, predictions rounded so that many negative
    losses tie), ``multi_proposal`` at the frcnn bench's shape (8 images,
    7,056 anchors, top 1000, 128 after NMS; half of each map uniform, so
    scores tie), ``box_nms`` with ``topk=400`` over 16 x 29,596 rows with
    tied scores, and ``roi_align`` at 1,056 rois x 128 channels x 7x7
    (forward and the gradients for one seeded cotangent)."""
    from incubator_mxnet_tpu_torch.ops import detection as det
    rng = onp.random.RandomState(3)
    res = {}
    t0 = time.perf_counter()
    ssd = models.SSD(bench.DETECTION_CLASSES)
    anchors = torch.cat([det.multibox_prior(
        torch.zeros(1, 1, h, h), sizes=s, ratios=r)
        for h, s, r in zip((75, 37, 18, 9), ssd._sizes, ssd._ratios)], 1)
    N = anchors.shape[1]
    check(N == 29596, f"SSD-300 has {N} anchors, not 29,596")
    B, M, C1 = 16, 4, bench.DETECTION_CLASSES + 1
    label = onp.full((B, M, 5), -1.0, "float32")
    for b in range(B):
        for m in range(rng.randint(1, M + 1)):
            x0, y0 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            label[b, m] = [rng.randint(0, C1 - 1), x0, y0, x0 + w, y0 + h]
    pred = onp.round(rng.randn(B, C1, N), 1).astype("float32")
    pred[:, :, :N // 4] = 0.0                   # equal negative losses
    args = [anchors.numpy(), label, pred]
    outs = {}
    for dev in ("cpu", "cuda"):
        outs[dev] = det.multibox_target(*_on(dev, *args),
                                        negative_mining_ratio=3.0)
    res["multibox_target"] = {
        "anchors": N, "batch": B,
        "loc_target_max_abs_err": _close("loc_target", outs["cuda"][0],
                                         outs["cpu"][0],
                                         DET_OP_ATOL["loc_target"]),
        "loc_mask_equal": _same_ints("loc_mask", outs["cuda"][1],
                                     outs["cpu"][1]),
        "cls_target_equal": _same_ints("cls_target", outs["cuda"][2],
                                       outs["cpu"][2]),
        "positives": int((outs["cpu"][2] > 0).sum()),
        "mined_negatives": int((outs["cpu"][2] == 0).sum())}
    # multi_proposal at the frcnn bench's shape
    B, A, H = 8, 9, 28
    logits = rng.randn(B, 2, A, H, H).astype("float32")
    logits[:, :, :, H // 2:] = 0.25                         # uniform half
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    bbox = (0.1 * rng.randn(B, 4 * A, H, H)).astype("float32")
    bbox[:, :, H // 2:] = 0.0
    info = onp.tile([224, 224, 1.0], (B, 1)).astype("float32")
    kw = dict(rpn_pre_nms_top_n=1000, rpn_post_nms_top_n=bench.FRCNN_ROIS,
              threshold=0.7, rpn_min_size=4, scales=(4, 8, 16),
              ratios=(0.5, 1, 2), feature_stride=8, output_score=True)
    for dev in ("cpu", "cuda"):
        outs[dev] = det.multi_proposal(*_on(dev, prob.reshape(B, -1, H, H),
                                            bbox, info), **kw)
    res["multi_proposal"] = {
        "anchors": H * H * A, "batch": B,
        "rois_max_abs_err": _close("rois", outs["cuda"][0], outs["cpu"][0],
                                   DET_OP_ATOL["rois"]),
        # the picked scores are gathers of the same input: equal iff the
        # same anchors were picked in the same order
        "scores_equal": _same_ints("proposal scores (roi order)",
                                   outs["cuda"][1], outs["cpu"][1]),
        "batch_index_equal": _same_ints("roi batch index",
                                        outs["cuda"][0][:, 0],
                                        outs["cpu"][0][:, 0])}
    # box_nms with topk=400 over SSD-300's anchors
    B = 16
    data = onp.concatenate([
        rng.randint(0, C1 - 1, (B, N, 1)).astype("float32"),
        onp.round(rng.rand(B, N, 1), 2).astype("float32"),
        onp.sort(rng.rand(B, N, 2, 2), axis=2).transpose(
            0, 1, 3, 2).reshape(B, N, 4).astype("float32")], -1)
    for dev in ("cpu", "cuda"):
        outs[dev] = det.box_nms(*_on(dev, data), overlap_thresh=0.45,
                                valid_thresh=0.01, topk=400, id_index=0)
    res["box_nms"] = {"rows": N, "batch": B, "topk": 400,
                      "equal": _same_ints("box_nms", outs["cuda"],
                                          outs["cpu"]),
                      "kept": int((outs["cpu"][..., 0] >= 0).sum())}
    # roi_align at the frcnn head's shape, forward and backward
    R = 8 * (bench.FRCNN_ROIS + 4)
    feat = rng.randn(8, 128, 28, 28).astype("float32")
    rois = onp.zeros((R, 5), "float32")
    rois[:, 0] = onp.repeat(onp.arange(8), R // 8)
    xy = rng.uniform(0, 200, (R, 2))
    rois[:, 1:3] = xy
    rois[:, 3:5] = xy + rng.uniform(4, 120, (R, 2))
    cot = rng.randn(R, 128, 7, 7).astype("float32")
    grads = {}
    for dev in ("cpu", "cuda"):
        f, r, c = _on(dev, feat, rois, cot)
        f.requires_grad_(True)
        out = det.roi_align(f, r, pooled_size=(7, 7), spatial_scale=1 / 8,
                            sample_ratio=2)
        grads[dev] = torch.autograd.grad(out, f, c)[0]
        outs[dev] = out.detach()
    fwd = _close("roi_align", outs["cuda"], outs["cpu"],
                 DET_OP_ATOL["roi_align"])
    gerr = (grads["cuda"].cpu() - grads["cpu"]).abs().max().item() \
        / grads["cpu"].abs().max().item()
    check(gerr <= DET_GRAD_RTOL, f"roi_align gradient: card vs CPU {gerr}")
    f, r = _on("cuda", feat, rois)
    f.requires_grad_(True)
    c = torch.as_tensor(cot).cuda()

    def fwd_bwd():
        out = det.roi_align(f, r, pooled_size=(7, 7), spatial_scale=1 / 8)
        return torch.autograd.grad(out, f, c)

    res["roi_align"] = {"rois": R, "channels": 128, "pooled": [7, 7],
                        "max_abs_err": fwd, "grad_rel_err": gerr,
                        "fwd_bwd_ms": cuda_ms(fwd_bwd)}
    res["seconds"] = time.perf_counter() - t0
    print(f"detection ops, card vs CPU ({time.perf_counter() - t0:.1f} s):"
          f" multibox_target {res['multibox_target']}; multi_proposal "
          f"{res['multi_proposal']}; box_nms {res['box_nms']}; roi_align "
          f"{res['roi_align']}", flush=True)
    return res


def det_run(trainer, batch, steps: int, tag: str) -> dict:
    """The port bench's protocol on a detection trainer: losses, the first
    and warm steps apart, peak memory, and the flash kernels' launches
    (none: no attention on this path)."""
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    timings = {}
    dt, losses = bench.measure(trainer, batch, steps, timings)
    launches = cuda_ops.launch_counts()
    losses = [float(x) for x in losses]
    check(all(onp.isfinite(losses)), f"{tag}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(not any(launches.values()), f"{tag}: the detection path launched "
          f"attention kernels: {launches}")
    return {"dt": dt, "losses": losses, "launches": launches,
            "first_step_ms": timings["first_step_s"] * 1e3,
            "warm_step_ms": timings["warm_step_s"] * 1e3,
            "captures": trainer.captures,
            "last_step_graphs": trainer.last_step_graphs,
            "last_path": trainer.last_path,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def det_detect(workload, net, batch) -> dict:
    """``SSD.detect`` / ``FasterRCNN.detect`` at the bench's size, timed on
    the host clock between synchronizes (a warm call first): shape, valid
    rows and ids in range."""
    args = [nd.array(a, ctx=mx.gpu(0))
            for a in batch[:1 if workload == "ssd" else 2]]

    def call():
        return net.detect(*args)

    dets = call()
    ms, _ = synced_ms(call, 3)
    d = dets.asnumpy()
    valid = d[..., 0] >= 0
    check(onp.isfinite(d).all(), f"{workload} detect: non-finite rows")
    check(((d[..., 0] < bench.DETECTION_CLASSES) & (d[..., 0] >= -1)).all(),
          f"{workload} detect: class ids out of range")
    return {"ms": ms, "shape": list(d.shape),
            "valid_rows": int(valid.sum())}


def det_bench(workload: str) -> dict:
    """(b) The port bench's ``ssd`` or ``frcnn`` workload at full size
    through the fused and the eager step, timed in turns: imgs/s, step ms,
    MFU, the first and warm (capture) steps apart, peak memory, one
    profiled step of each by group and its idle share; then ``detect`` at
    the same size."""
    gc.collect()
    torch.cuda.empty_cache()
    build = {"ssd": bench.build_ssd, "frcnn": bench.build_frcnn}[workload]
    t0 = time.perf_counter()
    fused, batch, info = build("cuda")
    eager, _, _ = build("cuda", fused=False)
    check(fused.fused and not eager.fused, f"the {workload} bench's trainer "
          "is not fused by default")
    steps = int(getenv("MXTPU_BENCH_STEPS"))
    runs = {"fused": det_run(fused, batch, steps, f"{workload} fused"),
            "eager": det_run(eager, batch, steps, f"{workload} eager")}
    check(runs["fused"]["captures"] == 1
          and runs["fused"]["last_step_graphs"] == 1
          and runs["fused"]["last_path"] == "fused"
          and runs["eager"]["last_path"] == "eager",
          f"{workload} trainers: {runs['fused']['captures']} captures, "
          f"{runs['fused']['last_step_graphs']} graphs in the last step")
    record = bench.detection_result(info, runs["fused"]["dt"],
                                    runs["fused"]["losses"],
                                    runs["fused"]["first_step_ms"] / 1e3)
    print(json.dumps(record), flush=True)
    placed = fused.place(*batch)
    for name, tr in (("eager", eager), ("fused", fused)):   # in turns
        runs[name]["step_ms_runs"] = [runs[name]["dt"] * 1e3, synced_ms(
            lambda: tr.step(*placed), steps)[0]]
    card = card_line()
    for name, r in runs.items():
        ms = min(r["step_ms_runs"])
        rec = bench.detection_result(info, ms / 1e3, r["losses"])
        r.update(step_ms=ms, imgs_per_s=info["batch"] / (ms / 1e3),
                 mfu=rec["extra"]["mfu"])
        print(f"{workload} {name}: batch {info['batch']} at {info['img']}: "
              f"{ms:.3f} ms per step = {r['imgs_per_s']:.1f} imgs/s, MFU "
              f"{r['mfu']:.4f} (runs "
              f"{[round(t, 3) for t in r['step_ms_runs']]}); first step "
              f"{r['first_step_ms']:.1f} ms, warm step "
              f"{r['warm_step_ms']:.1f} ms"
              f"{' (the capture)' if name == 'fused' else ''}; losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; peak memory "
              f"{r['peak_memory_gib']:.2f} GiB on {card}", flush=True)
    res = {"record": record, "runs": runs, "batch": info["batch"],
           "img": info["img"], "gmacs": info["gmacs"],
           "parameters": sum(p.numel() for p in info["net"].parameters()),
           "launches": runs["fused"]["launches"],
           "launches_eager": runs["eager"]["launches"]}
    for name, tr in (("fused", fused), ("eager", eager)):
        res[f"profile_{name}"] = grouped_profiled_step(
            tr, placed, f"{workload} {name}", DET_GROUPS)
    res["detect"] = det_detect(workload, info["net"], batch)
    print(f"{workload} detect: {res['detect']} on {card}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del fused, eager, placed, info
    return res


def det_fused_gate(steps: int = 3) -> dict:
    """(c) The fused detection step against the eager one under
    ``torch.use_deterministic_algorithms``, both models at a small size
    (batch 2, 64x64; the bench's configuration otherwise): losses and
    weights after ``steps`` steps bitwise equal."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    for workload, build in (("ssd", bench.build_ssd),
                            ("frcnn", bench.build_frcnn)):
        torch.use_deterministic_algorithms(True)
        try:
            with mock.patch.dict(os.environ, DET_SMALL):
                pairs = [build("cuda", fused=f) for f in (None, False)]
            losses = [[float(tr.step(*batch)) for _ in range(steps)]
                      for tr, batch, _ in pairs]
        finally:
            torch.use_deterministic_algorithms(False)
        nets = [p[2]["net"] for p in pairs]
        check(pairs[0][0].last_path == "fused"
              and pairs[0][0].last_step_graphs == 1
              and pairs[1][0].last_path == "eager",
              f"the {workload} gate's trainers did not take the fused and "
              "the eager step")
        weights, wname = _worst(nets, lambda p: p._var)
        same = losses[0] == losses[1] and weights == 0.0
        print(f"{workload} gate: batch 2 at 64, {steps} steps, fused vs "
              f"eager under deterministic algorithms: losses {losses[0]} "
              f"vs {losses[1]}; weights worst rel err {weights:.2e} "
              f"({wname}); bitwise {same}", flush=True)
        check(same, f"fused and eager {workload} steps differ: losses "
              f"{losses}, weights {weights} at {wname}")
        res[workload] = {"losses_fused": losses[0],
                         "losses_eager": losses[1], "bitwise": same}
    return res


def det_grads_vs_cpu() -> dict:
    """(d) One step's gradients of both models at the small size on the
    card, the fused and the eager step, against the same step on the CPU
    (the same weights and batch)."""
    gc.collect()
    res = {}
    for workload, build in (("ssd", bench.build_ssd),
                            ("frcnn", bench.build_frcnn)):
        runs = {}
        with mock.patch.dict(os.environ, DET_SMALL):
            for name, device, fused in (("fused", "cuda", None),
                                        ("eager", "cuda", False),
                                        ("cpu", "cpu", None)):
                tr, batch, info = build(device, fused=fused)
                runs[name] = (info["net"], float(tr.step(*batch)))
        cpu_net, cpu_loss = runs.pop("cpu")
        res[workload] = {"loss_cpu": cpu_loss}
        for name, (net, loss) in runs.items():
            rows = _rel_errs([net, cpu_net], lambda p: p._var.grad)
            worst, wname = rows[0]
            print(f"{workload} gradients, {name} step (batch 2 at 64): "
                  f"loss {loss:.6f} vs CPU {cpu_loss:.6f}; max abs err / "
                  f"max |grad|, worst three: "
                  + ", ".join(f"{r:.2e} ({k})" for r, k in rows[:3])
                  + f" (tol {DET_GRAD_RTOL})", flush=True)
            check(worst <= DET_GRAD_RTOL, f"{workload} gradients of the "
                  f"{name} step differ from the CPU's: {worst} at {wname}")
            check(abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss),
                  f"{workload} losses differ: card {loss}, CPU {cpu_loss}")
            res[workload][name] = {"loss_card": loss,
                                   "grads_worst_rel_err": worst,
                                   "grads_worst_param": wname}
    return res


def det_example_gates() -> dict:
    """(e) The JAX package's two detection examples on the card, with the
    thresholds of its tier-1 gates: ``ssd_example(steps=150)`` (hybridized
    SSD, ``gluon.Trainer``) above 0.8 and ``frcnn_example(steps=400)``
    above 0.25, each a top-detection hit rate on held-out images."""
    from incubator_mxnet_tpu_torch.models import rcnn, ssd
    res = {}
    for name, fn, steps, gate in (("ssd_example", ssd.ssd_example, 150,
                                   SSD_GATE),
                                  ("frcnn_example", rcnn.frcnn_example, 400,
                                   FRCNN_GATE)):
        gc.collect()
        t0 = time.perf_counter()
        cuda_ops.reset_launches()
        out = fn(steps=steps, ctx=mx.gpu(0))
        launches = cuda_ops.launch_counts()
        secs = time.perf_counter() - t0
        print(f"{name}: {steps} steps, loss {out['losses'][0]:.4f} -> "
              f"{out['losses'][-1]:.4f}, accuracy {out['accuracy']:.4f} "
              f"(gate {gate}), {secs:.1f} s", flush=True)
        check(out["accuracy"] > gate,
              f"{name} accuracy {out['accuracy']} <= {gate}")
        check(not any(launches.values()), f"{name} launched attention "
              f"kernels: {launches}")
        res[name] = {"accuracy": out["accuracy"], "steps": steps,
                     "first_loss": out["losses"][0],
                     "last_loss": out["losses"][-1], "seconds": secs,
                     "launches": launches}
    return res


def phase_detection() -> dict:
    """The detection path: (a) the ops card vs CPU, (b) the ``ssd`` and
    ``frcnn`` bench workloads with ``detect``, (c) fused vs eager, (d)
    card vs CPU gradients, (e) the two example gates."""
    t0 = time.perf_counter()
    res = {"ops": det_ops_card_vs_cpu()}
    for workload in ("ssd", "frcnn"):
        res[workload] = det_bench(workload)
    res["fused_gate"] = det_fused_gate()
    res["grads_vs_cpu"] = det_grads_vs_cpu()
    res.update(det_example_gates())
    res["seconds"] = time.perf_counter() - t0
    print(f"detection: {res['seconds']:.1f} s", flush=True)
    return res


# -- int8 serving and mixed-precision training --------------------------------
#: the int8 serving phase's calibration batch: 32 ragged requests drawn as
#: the serving phase draws its own, from this seed plus the run's seed
INT8_CALIB_SEED = 1
INT8_CALIB_REQUESTS = 32
#: served int8 outputs against unbatched int8 forwards (both on the flash
#: kernel; the int8 products are exact, the float parts the same kernels):
#: max abs err <= this times the largest |output|
INT8_SERVE_RTOL = 1e-3
#: the JAX package's accuracy gate of the bert_encoder smoke twin
#: (tests/test_quantization.py:298-314)
INT8_SMOKE_GATE = 0.05
#: the int8 forward's device-time groups: the wrappers whose kernels each
#: group collects (torch.profiler ranges around them, chip_smoke's own)
INT8_RANGES = ("int8:quantize", "int8:int_mm", "int8:bias", "int8:dequantize")
#: one full-width layer's shapes for the card-vs-CPU accumulator check:
#: (in, out) of qkv, proj, ffn1 and ffn2, at one 512-token request and at
#: the smallest bucket's 8 rows (padded to _int_mm's 17+ on the card)
INT8_LAYER_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
INT8_ROWS = (512, 8)


def _requests(rng, n: int) -> list:
    """``n`` ragged BERT requests as the serving phase draws them."""
    reqs = []
    for _ in range(n):
        L = int(rng.randint(4, 512))
        reqs.append((rng.randint(1, 30522, L).astype("int32"),
                     (onp.arange(L) >= L // 2).astype("int32"),
                     onp.array(L, "float32")))
    return reqs


def _padded_batch(reqs) -> list:
    """The requests as one batch padded with zeros to the longest, as
    ``CompiledModel`` pads."""
    Lmax = max(len(r[0]) for r in reqs)
    ids = onp.zeros((len(reqs), Lmax), "int32")
    tt = onp.zeros_like(ids)
    for i, (a, b, _) in enumerate(reqs):
        ids[i, :len(a)], tt[i, :len(b)] = a, b
    vl = onp.array([r[2] for r in reqs], "float32")
    return [torch.from_numpy(x).cuda() for x in (ids, tt, vl)]


def _param_bytes(block) -> int:
    return sum(p.numel() * p.element_size() for p in block.parameters())


class _Int8Ranges:
    """While active, each int8 op of ``ops/quantization.py`` runs inside a
    ``torch.profiler`` range named after it (:data:`INT8_RANGES`), so a
    profile attributes their kernels."""

    def __init__(self):
        from incubator_mxnet_tpu_torch.ops import quantization as tq
        self.tq = tq
        self.saved = {}

    def __enter__(self):
        from torch.profiler import record_function
        for name in ("quantize", "int_matmul", "_bias32", "dequantize"):
            fn = getattr(self.tq, name)
            label = {"int_matmul": "int8:int_mm",
                     "_bias32": "int8:bias"}.get(name, f"int8:{name}")

            def wrapped(*a, _fn=fn, _label=label, **k):
                with record_function(_label):
                    return _fn(*a, **k)
            self.saved[name] = fn
            setattr(self.tq, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.tq, name, fn)


def int8_forward_split(model, B: int = 32, L: int = 512) -> dict:
    """One forward at the largest bucket, timed with CUDA events, then
    split by ``torch.profiler``: the int8 ops' ranges (quantize, the
    ``_int_mm`` product, the bias re-encoding, dequantize), the flash
    kernel, and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(1, 30522, (B, L), device="cuda", generator=gen,
                        dtype=torch.int32)
    tt = torch.zeros_like(ids)
    vl = torch.full((B,), float(L), device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(ids, tt, vl), target_ms=300.0)
        with _Int8Ranges():
            model(ids, tt, vl)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(ids, tt, vl)
                torch.cuda.synchronize()
    total, flash, groups = 0.0, 0.0, {r: 0.0 for r in INT8_RANGES}
    for e in prof.events():
        if e.name in groups:
            # the range on the CPU holds its kernels' device time; its
            # copy on the device timeline is no kernel
            if e.device_type == DeviceType.CPU:
                groups[e.name] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            total += ms
            if "flash_fwd_kernel" in e.name:
                flash += ms
    groups["flash_fwd_kernel"] = flash
    groups["other"] = total - sum(groups.values())
    return {"bucket": [B, L], "forward_ms": fwd_ms,
            "profiled_device_ms": total, "ms_by_group": groups}


def int8_accumulators_vs_cpu(qblock) -> dict:
    """One layer's int8 products on the card against the CPU's plain
    version on the same int8 inputs: at the full-width shapes of layer 0
    (its own int8 weights for qkv, proj, ffn1 and ffn2) with one 512-token
    request and with 8 rows (padded for ``_int_mm``): the int32
    accumulators bitwise equal, and the dequantized float32 outputs too
    (the same IEEE operations)."""
    from incubator_mxnet_tpu_torch import quantization
    from incubator_mxnet_tpu_torch.ops import quantization as tq
    layers = [b for b in qblock.modules()
              if isinstance(b, quantization.QuantizedDense)][:4]
    rng = onp.random.RandomState(7)
    res = []
    for layer, (k, n) in zip(layers, INT8_LAYER_SHAPES):
        w = layer.qweight._tensor()
        check(tuple(w.shape) == (n, k), f"{layer.name}: weight "
              f"{tuple(w.shape)}, not {(n, k)}")
        for m in INT8_ROWS:
            x = torch.from_numpy(rng.randn(m, k).astype("float32") * 2)
            outs = {}
            for dev in ("cpu", "cuda"):
                qx, lo, hi = tq.quantize(x.to(dev), *layer._range)
                acc, olo, ohi = tq.quantized_fully_connected(
                    qx, w.to(dev), None, lo, hi, -1.0, 1.0, flatten=False)
                outs[dev] = (qx, acc, tq.dequantize(acc, olo, ohi))
            for i, name in enumerate(("quantized input", "accumulator",
                                      "dequantized output")):
                same = torch.equal(outs["cuda"][i].cpu(), outs["cpu"][i])
                check(same, f"{layer.name} at ({m}, {k}) x ({k}, {n}): the "
                      f"{name} differs between the card and the CPU")
            res.append({"layer": layer.name, "m": m, "k": k, "n": n,
                        "bitwise": True})
    print(f"int8 accumulators, card (torch._int_mm) vs CPU (int32 @): "
          f"bitwise equal for {len(res)} cases "
          f"{[(r['m'], r['k'], r['n']) for r in res]}", flush=True)
    return {"cases": res}


def phase_int8_serve(model, seed: int) -> dict:
    """BERT-base served int8: calibration with ``quantization.observe_net``
    on one batch of 32 ragged requests, ``quantization.quantize_model``
    into a quantized ``CompiledModel`` over the serving table, ``warmup``
    and ``DynamicBatcher``; the float and int8 models serve the same
    requests in turns (paced, then all at once); gates: every request
    answered, no post-warmup compile, the 48 encoder Dense layers and the
    pooler int8, served = unbatched int8 forwards, the forward kernel
    launched and the backward ones not, the accumulators bitwise equal to
    the CPU's; printed: the error against the float model, parameter
    bytes, latency and throughput, the forward's device split; then the
    ``bert_encoder`` smoke twin's gate on the card."""
    from incubator_mxnet_tpu_torch import quantization
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = models.serve_spec("bert_encoder")
    table = serve.BucketTable({"batch": (1, 32), "seq": (8, 512)})
    example = (onp.zeros((1, 8), "int32"), onp.zeros((1, 8), "int32"),
               onp.zeros((1,), "float32"))
    cm = serve.CompiledModel(model, table, spec["input_axes"], example,
                             output_axes=spec["output_axes"],
                             pad_values=spec["pad_values"])
    calib = _requests(onp.random.RandomState(seed + INT8_CALIB_SEED),
                      INT8_CALIB_REQUESTS)
    t1 = time.perf_counter()
    obs = quantization.observe_net(model, [_padded_batch(calib)])
    calib_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    qcm = quantization.quantize_model(cm, obs)
    quant_s = time.perf_counter() - t1
    qblock = qcm._block
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    qdense = [b.name for b in qblock.modules()
              if isinstance(b, quantization.QuantizedDense)]
    left = [b.name for b in qblock.modules()
            if isinstance(b, gluon.nn.Dense)]
    check(len(qdense) == 4 * n_layers + 1 and not left
          and any(n.endswith("pooler_int8") for n in qdense),
          f"{len(qdense)} QuantizedDense layers (want {4 * n_layers + 1}), "
          f"float Dense left: {left}")
    warm = {"float": cm.warmup(), "int8": qcm.warmup()}
    for name, m in (("float", cm), ("int8", qcm)):
        check(len(m._graphs) == table.num_buckets(), f"int8 serve: the "
              f"{name} model captured {len(m._graphs)} graphs for "
              f"{table.num_buckets()} buckets")
    bytes_ = {"float": _param_bytes(model), "int8": _param_bytes(qblock)}
    print(f"int8 serve: calibrated on {len(calib)} ragged requests in "
          f"{calib_s:.1f} s, quantized in {quant_s:.1f} s, "
          f"{len(qdense)} QuantizedDense layers; parameter bytes "
          f"{bytes_['int8']:,} int8 vs {bytes_['float']:,} float32; warmup "
          f"{warm}", flush=True)

    reqs = _requests(onp.random.RandomState(seed), N_REQUESTS)
    gaps = onp.random.RandomState(seed).exponential(4.0 / OFFERED_RATE,
                                                    N_REQUESTS)
    runs, launches = {}, {}
    cms = {"float": cm, "int8": qcm}
    # in turns: paced float, int8; all at once int8, float
    for mode, order in (("paced", ("float", "int8")),
                        ("burst", ("int8", "float"))):
        for name in order:
            batcher = serve.DynamicBatcher(cms[name], max_delay_ms=5.0)
            cuda_ops.reset_launches()
            batcher.start()
            try:
                runs[(name, mode)] = drive(
                    batcher, cms[name], reqs,
                    gaps if mode == "paced" else onp.zeros(N_REQUESTS))
            finally:
                batcher.stop()
            launches[(name, mode)] = cuda_ops.launch_counts()
    int8_launches = {k: launches[("int8", "paced")][k]
                     + launches[("int8", "burst")][k] for k in fa.KERNELS}
    batches = sum(runs[("int8", m)]["snapshot"]["batches"]
                  for m in ("paced", "burst"))
    check(int8_launches[fa.KERNEL] >= n_layers * batches > 0,
          f"int8 serving launched {fa.KERNEL} {int8_launches[fa.KERNEL]} "
          f"times for {batches} batches of {n_layers} layers")
    for name in (fa.KERNEL_BWD_DKV, fa.KERNEL_BWD_DQ):
        check(int8_launches[name] == 0, f"int8 serving launched the "
              f"backward kernel {name}")

    # served int8 outputs against unbatched int8 forwards, and the float
    # model's error against int8 on the same requests
    picks = sorted(range(N_REQUESTS), key=lambda i: reqs[i][2])
    picks = [picks[int(j)] for j in onp.linspace(0, N_REQUESTS - 1, 8)]
    served = runs[("int8", "paced")]["outs"]
    served_f = runs[("float", "paced")]["outs"]
    worst, num, den = 0.0, 0.0, 0.0
    with torch.inference_mode():
        for i in picks:
            ids, tt, vl = (torch.from_numpy(a[None]).cuda() for a in reqs[i])
            seq, pooled = qblock(ids, tt, vl)
            got_seq, got_pooled = served[i]
            check(bool(onp.isfinite(got_seq).all()
                       and onp.isfinite(got_pooled).all()),
                  "served int8 outputs are not finite")
            for g, w in ((got_seq, seq[0]), (got_pooled, pooled[0])):
                worst = max(worst, _max_err(g, w)
                            / w.abs().max().item())
            for g, f in zip(served[i], served_f[i]):
                num += float(onp.abs(g - f).sum())
                den += float(onp.abs(f).sum())
    check(worst <= INT8_SERVE_RTOL, f"served vs unbatched int8 forward: "
          f"max abs err / max |out| {worst} > {INT8_SERVE_RTOL}")
    rel_vs_float = num / den
    card = card_line()
    res = {"requests": N_REQUESTS, "calibration_requests": len(calib),
           "calibration_s": calib_s, "quantize_s": quant_s,
           "quantized_dense": len(qdense), "param_bytes": bytes_,
           "warmup": warm, "served_vs_unbatched_rel_err": worst,
           "mean_rel_err_vs_float": rel_vs_float,
           "launches": int8_launches, "batches": batches}
    for (name, mode), r in runs.items():
        lat = r["snapshot"]["latency"]
        res[f"{name}_{mode}"] = {
            "wall_s": r["wall_s"], "req_s": N_REQUESTS / r["wall_s"],
            "p50_ms": lat["latency_ms_p50"], "p99_ms": lat["latency_ms_p99"],
            "batches": r["snapshot"]["batches"]}
        print(f"int8 serve, {name} {mode}: {N_REQUESTS} requests in "
              f"{r['wall_s']:.3f} s = {N_REQUESTS / r['wall_s']:.1f} req/s, "
              f"latency p50 {lat['latency_ms_p50']} ms p99 "
              f"{lat['latency_ms_p99']} ms, {r['snapshot']['batches']} "
              f"batches on {card}", flush=True)
    print(f"int8 serve: served vs unbatched int8 max rel err {worst:.2e} "
          f"(tol {INT8_SERVE_RTOL}); mean relative error against the float "
          f"model {rel_vs_float:.4f} (printed, not gated); launches "
          f"{int8_launches}", flush=True)
    res["accumulators"] = int8_accumulators_vs_cpu(qblock)
    res["split"] = {name: int8_forward_split(cms[name]._block)
                    for name in ("int8", "float")}
    for name, sp in res["split"].items():
        print(f"int8 serve, {name} forward at (32, 512): "
              f"{sp['forward_ms']:.3f} ms (CUDA events); profiled device "
              f"{sp['profiled_device_ms']:.3f} ms: "
              + ", ".join(f"{g} {t:.3f}" for g, t in
                          sp["ms_by_group"].items()), flush=True)
    smoke = models.quantized_smoke("bert_encoder", device="cuda")
    args = models.calib_args("bert_encoder", seed=5, device="cuda")
    want = smoke["f32"]["compiled"].predict(*args)
    got = smoke["compiled"].predict(*args)
    rels = [((w._data - g._data).abs().mean()
             / (w._data.abs().mean() + 1e-6)).item()
            for w, g in zip(want, got)]
    print(f"int8 serve: bert_encoder smoke twin on the card, mean rel err "
          f"{[round(r, 5) for r in rels]} (gate {INT8_SMOKE_GATE})",
          flush=True)
    check(max(rels) < INT8_SMOKE_GATE, f"bert_encoder smoke twin: {rels}")
    res["smoke_rel_err"] = rels
    res["seconds"] = time.perf_counter() - t0
    del qcm, cm, qblock
    return res


#: AMP gradients of a 2-layer BERT at full width on the card against the
#: CPU's: bfloat16 keeps 8 significant bits, and the card (cuBLAS, the
#: flash kernels) and the CPU (oneDNN, the plain attention) round GEMM
#: outputs, GELU and the attention probabilities to bfloat16 at the same
#: places from float32 values summed in another order, so some round to the
#: neighbouring bfloat16; a few such flips compound through two layers
#: forward and back (the CPU parity test against the JAX package sees up
#: to 2.4e-2): per parameter, max abs err <= this times max |grad on CPU|
AMP_GRAD_RTOL = 5e-2
#: the AMP gradient check's batch: 2 sequences of the bench's 512 (the CPU
#: side computes the full-width step too)
AMP_GRAD_BATCH = 2
#: device-time groups of a BERT training step under AMP and in float32, by
#: kernel name (the first match wins): the three flash kernels, the GEMMs
#: (cuBLAS's and CUTLASS's, SIMT float32 and bf16 tensor-core kernels),
#: dtype casts and copies, the optimizer's multi-tensor kernels,
#: reductions (LayerNorm statistics, softmax, the loss), the other
#: elementwise kernels
AMP_GROUPS = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("cast_copy", ("copy_kernel",)),
    ("optimizer", ("multi_tensor",)),
    ("reduce", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise",)),
)
#: the example gate of the JAX package's tests/test_examples.py:29-33, run
#: on the example's default model (its mobilenet0.25 is not ported)
AMP_EXAMPLE = dict(model="resnet18_v1", epochs=2, classes=4, batch_size=16)
AMP_EXAMPLE_GATE = 0.5


class _amp_on:
    """``amp.init("bfloat16")`` while active (``on``), else the float32
    namespace; restores the previous state on exit."""

    def __init__(self, on: bool = True):
        from incubator_mxnet_tpu_torch import amp
        self.amp, self.on = amp, on

    def __enter__(self):
        self.prev = self.amp._STATE["initialized"]
        if self.on:
            self.amp.init("bfloat16")
        else:
            self.amp.reset()
        return self

    def __exit__(self, *exc):
        if self.prev:
            self.amp.init("bfloat16")
        else:
            self.amp.reset()


class _launch_dtypes:
    """Record the dtype of q at every call of the flash kernels' launch
    wrapper (eager launches and the launches a capture records)."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        self.orig = fa._launch

        def spy(name, q, *a, **k):
            key = (name, str(q.dtype).replace("torch.", ""))
            self.seen[key] = self.seen.get(key, 0) + 1
            return self.orig(name, q, *a, **k)
        fa._launch = spy
        return self

    def __exit__(self, *exc):
        fa._launch = self.orig

    def dtypes(self) -> dict:
        return {f"{n}:{d}": c for (n, d), c in sorted(self.seen.items())}


def _bert_trainer(fused, num_layers: int = None, dropout: float = 0.1,
                  device: str = "cuda"):
    """BERT-base at the bench's configuration with float32 weights (AdamW
    at lr 1e-4), on ``device``."""
    kw = {} if num_layers is None else {"num_layers": num_layers}
    net = models.get_bert("bert_12_768_12", vocab_size=bench.VOCAB,
                          max_length=TRAIN_SHAPE[1], dropout=dropout,
                          dtype="float32", device=device,
                          generator=torch.Generator().manual_seed(0), **kw)
    return net, parallel.ShardedTrainer(
        net, models.bert_pretrain_loss, "adamw", {"learning_rate": 1e-4},
        device=device, n_labels=3, fused=fused)


def amp_bert_train() -> dict:
    """(b1) BERT-base (bench configuration, float32 weights) under
    ``amp.init("bfloat16")`` through the fused and the eager step, timed
    in turns against the same steps without AMP: step ms, tokens/s,
    losses finite and falling, 12 launches per kernel per step with bf16
    q (recorded at the wrapper), one profiled step of each by group."""
    gc.collect()
    torch.cuda.empty_cache()
    batch = bench.make_batch(*TRAIN_SHAPE)
    steps = int(getenv("MXTPU_BENCH_STEPS"))
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    res = {}
    for path, fused in (("fused", None), ("eager", False)):
        trainers, runs = {}, {}
        for name, on in (("float32", False), ("amp", True)):
            _, trainers[name] = _bert_trainer(fused)
            with _amp_on(on), _launch_dtypes() as spy:
                runs[name] = train_run(trainers[name], batch, steps,
                                       n_layers, f"amp train {name} {path}")
            runs[name]["launch_dtypes"] = spy.dtypes()
        want = "bfloat16"
        for key in runs["amp"]["launch_dtypes"]:
            check(key.endswith(want), f"amp {path}: a kernel took "
                  f"{key}: {runs['amp']['launch_dtypes']}")
        for key in runs["float32"]["launch_dtypes"]:
            check(key.endswith("float32"), f"float32 {path}: {key}")
        placed = trainers["amp"].place(*batch)
        # in turns: amp, float32, float32, amp (each path's own run first)
        for name in ("amp", "float32", "float32", "amp"):
            with _amp_on(name == "amp"):
                runs[name].setdefault("step_ms_runs", [
                    runs[name]["dt"] * 1e3]).append(synced_ms(
                        lambda: trainers[name].step(*placed), steps)[0])
        card = card_line()
        for name, r in runs.items():
            ms = min(r["step_ms_runs"])
            r.update(step_ms=ms, tokens_per_s=tokens / (ms / 1e3))
            with _amp_on(name == "amp"):
                r["profile"] = grouped_profiled_step(
                    trainers[name], placed, f"amp train {name} {path}",
                    AMP_GROUPS)
            print(f"amp train {path}, {name}: {ms:.3f} ms per step = "
                  f"{r['tokens_per_s']:.1f} tokens/s (runs "
                  f"{[round(t, 3) for t in r['step_ms_runs']]}), losses "
                  f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, "
                  f"launches {r['launches']}, q dtypes at the wrapper "
                  f"{r['launch_dtypes']}, peak memory "
                  f"{r['peak_memory_gib']:.2f} GiB on {card}", flush=True)
        if path == "fused":
            check(runs["amp"]["captures"] == 1
                  and runs["amp"]["last_path"] == "fused",
                  f"the AMP fused trainer: {runs['amp']['captures']} "
                  "captures")
        res[path] = runs
        del trainers, placed
        gc.collect()
        torch.cuda.empty_cache()
    return res


def amp_fused_gate(num_layers: int = 2, steps: int = 3) -> dict:
    """The train gate (phase 7) under AMP: at full width and
    ``num_layers`` layers, dropout 0, float32 weights, under
    ``torch.use_deterministic_algorithms``, the fused step against the
    eager one over ``steps`` steps: losses and weights within 1e-5 of each
    parameter's largest value."""
    gc.collect()
    torch.cuda.empty_cache()
    batch = bench.make_batch(*TRAIN_SHAPE)
    torch.use_deterministic_algorithms(True)
    try:
        with _amp_on():
            pairs = [_bert_trainer(f, num_layers, dropout=0.0)
                     for f in (None, False)]
            losses = [[float(tr.step(*batch)) for _ in range(steps)]
                      for _, tr in pairs]
    finally:
        torch.use_deterministic_algorithms(False)
    check(pairs[0][1].last_step_graphs == 1 and pairs[0][1].captures == 1,
          "the AMP gate's fused trainer did not replay a graph")
    worst, wname = 0.0, ""
    eager = dict(pairs[1][0].named_parameters())
    for name, p in pairs[0][0].named_parameters():
        want = eager[name].detach().float()
        ratio = ((p.detach().float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30)).item()
        if ratio > worst:
            worst, wname = ratio, name
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    print(f"amp train gate, {num_layers} layers at full width, {steps} "
          f"steps, fused vs eager under deterministic algorithms: losses "
          f"{losses[0]} vs {losses[1]} (worst rel err {loss_err:.2e}), "
          f"weights worst rel err {worst:.2e} ({wname})", flush=True)
    check(loss_err <= 1e-5 and worst <= 1e-5, f"AMP fused and eager steps "
          f"differ: losses {loss_err}, weights {worst} at {wname}")
    return {"losses_fused": losses[0], "losses_eager": losses[1],
            "loss_rel_err": loss_err, "weights_worst_rel_err": worst,
            "weights_worst_param": wname,
            "bitwise": loss_err == 0.0 and worst == 0.0}


def amp_grads_vs_cpu(num_layers: int = 2) -> dict:
    """One AMP step's gradients of a ``num_layers``-layer BERT at full
    width (dropout 0, float32 weights) on the card (fused trainer, its
    first step) against the same step on the CPU (eager), within
    :data:`AMP_GRAD_RTOL` of each parameter's largest."""
    gc.collect()
    batch = bench.make_batch(AMP_GRAD_BATCH, TRAIN_SHAPE[1])
    out = {}
    with _amp_on():
        for device in ("cuda", "cpu"):
            net, tr = _bert_trainer(None, num_layers, dropout=0.0,
                                    device=device)
            loss = float(tr.step(*batch))
            out[device] = (loss, {n: p.grad.detach().float().cpu()
                                  for n, p in net.named_parameters()})
    (lc, gc_), (lx, gx) = out["cuda"], out["cpu"]
    worst, wname = 0.0, ""
    for name, g in gx.items():
        ratio = ((gc_[name] - g).abs().max()
                 / g.abs().max().clamp_min(1e-30)).item()
        if ratio > worst:
            worst, wname = ratio, name
    print(f"amp gradients, {num_layers} layers at full width, batch "
          f"{AMP_GRAD_BATCH}x{TRAIN_SHAPE[1]}: card vs CPU worst max abs err"
          f" / max |grad| {worst:.2e} ({wname}, tol {AMP_GRAD_RTOL}); loss "
          f"{lc:.6f} vs {lx:.6f}", flush=True)
    check(worst <= AMP_GRAD_RTOL, f"AMP gradients differ: {worst} at "
          f"{wname}")
    check(abs(lc - lx) <= 1e-2 * abs(lx), f"AMP losses differ: {lc}, {lx}")
    return {"worst_rel_err": worst, "worst_param": wname,
            "loss_card": lc, "loss_cpu": lx}


def amp_resnet() -> dict:
    """(b2) ResNet-50 v1 (1000 classes, batch 32, 224x224, float32
    weights) through the image-classification example loop, hybridized,
    with ``--amp`` and without, in turns: imgs/s and step ms of the last
    epoch (16 steps; the first epoch holds the eager first call and the
    captures), losses finite; no attention kernel."""
    from incubator_mxnet_tpu_torch.models import image_classification as ic
    res = {}
    for name in ("float32", "amp", "amp", "float32"):
        gc.collect()
        torch.cuda.empty_cache()
        cuda_ops.reset_launches()
        with _amp_on(False):           # the example's --amp turns it on
            out = ic.image_classification_example(
                model="resnet50_v1", classes=1000, image_size=224,
                epochs=2, batch_size=32, amp=name == "amp", ctx=mx.gpu(0))
        launches = cuda_ops.launch_counts()
        check(all(onp.isfinite(out["losses"])), f"resnet50 {name}: "
              f"non-finite loss")
        check(not any(launches.values()), f"resnet50 {name} launched "
              f"attention kernels: {launches}")
        secs = out["epoch_seconds"][-1]
        steps = len(out["losses"]) // len(out["epoch_seconds"])
        r = res.setdefault(name, {"epoch_s_runs": [], "launches": launches,
                                  "first_epoch_s": out["epoch_seconds"][0],
                                  "losses": out["losses"]})
        r["epoch_s_runs"].append(secs)
        r["imgs_per_s"] = 32 * steps / min(r["epoch_s_runs"])
        r["step_ms"] = min(r["epoch_s_runs"]) / steps * 1e3
    card = card_line()
    for name, r in res.items():
        print(f"amp resnet50_v1 example loop, {name}: {r['step_ms']:.3f} ms "
              f"per step = {r['imgs_per_s']:.1f} imgs/s (last-epoch runs "
              f"{[round(s, 3) for s in r['epoch_s_runs']]} s), first epoch "
              f"{r['first_epoch_s']:.1f} s, loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f} on {card}", flush=True)
    return res


def amp_example_gate() -> dict:
    """(b3) The example's own gate with ``--amp``: resnet18_v1, 2 epochs,
    4 classes, batch 16, training accuracy above 0.5."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch.models import image_classification as ic
    gc.collect()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    try:
        out = ic.image_classification_example(amp=True, ctx=mx.gpu(0),
                                              **AMP_EXAMPLE)
    finally:
        amp.reset()
    launches = cuda_ops.launch_counts()
    secs = time.perf_counter() - t0
    print(f"amp example gate: {AMP_EXAMPLE}, --amp: accuracy "
          f"{out['epochs']} (gate {AMP_EXAMPLE_GATE}), loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, "
          f"{secs:.1f} s", flush=True)
    check(out["accuracy"] > AMP_EXAMPLE_GATE, f"the example's accuracy "
          f"{out['accuracy']} <= {AMP_EXAMPLE_GATE}")
    check(not any(launches.values()), f"the example launched attention "
          f"kernels: {launches}")
    return {"accuracy": out["accuracy"], "epochs": out["epochs"],
            "seconds": secs, "launches": launches}


def phase_amp() -> dict:
    """Mixed-precision training: (b1) BERT-base under AMP, fused and
    eager, against float32, with its fused = eager gate and card vs CPU
    gradients; (b2) ResNet-50 through the example loop; (b3) the
    example's gate."""
    t0 = time.perf_counter()
    res = {"bert": amp_bert_train()}
    res["fused_gate"] = amp_fused_gate()
    res["grads_vs_cpu"] = amp_grads_vs_cpu()
    res["resnet"] = amp_resnet()
    res["example"] = amp_example_gate()
    res["seconds"] = time.perf_counter() - t0
    print(f"amp: {res['seconds']:.1f} s", flush=True)
    return res


# -- the mx.nd op surface and the vision zoo ----------------------------------
# card vs CPU, the same port code on the same seeded inputs, by family:
# float results within the family's tolerance of the largest CPU value
# (elementwise, shapes, normalisation and the output heads: another libm
# or summation order, 1e-5; the special functions and linear algebra:
# other algorithms, 1e-4); integer, boolean and index results equal, ties
# included; custom-gradient ops' gradients within 1e-5
ND_TOL = {"elementwise": 1e-5, "special": 1e-4, "binary": 1e-5,
          "reduction": 1e-5, "linalg": 1e-4, "shape": 1e-5,
          "ordering": 0.0, "sequence": 1e-5, "nn": 1e-5, "output": 1e-5,
          "resample": 1e-5, "vision": 1e-5, "recurrent": 1e-4}
ND_GRAD_TOL = 1e-5
ND_DRAWS = 1_000_000
ND_SE = 5.0
# MobileNet's gradients on the card against the CPU's float64 step, each
# error over the net's largest gradient (a BatchNorm beta that feeds a
# training-mode BatchNorm has a gradient of rounding noise only, so the
# scale is the net's, not each parameter's): the card's float64 step
# (the same function, float64 rounding apart) and its float32 step
MOBILENET_GRAD_F64_RTOL = 1e-9
MOBILENET_GRAD_F32_RTOL = 1e-4
MOBILENET_GATE_RTOL = 1e-5
MOBILENET_EXAMPLE = dict(model="mobilenet0.25", epochs=2, classes=4,
                         batch_size=16)
MOBILENET_MODELS = ("mobilenetv2_1.0", "mobilenet1.0")
MOBILENET_GROUPS = (("depthwise", ("depthwise", "dwconv")),) + VISION_GROUPS
ZOO_MODELS = (("alexnet", 224), ("vgg11", 224), ("squeezenet1.1", 224),
              ("densenet121", 224), ("inceptionv3", 299))
ZOO_HYBRID_RTOL = 1e-5


def _nd_cases(rng) -> list:
    """``(family, op, args, kwargs, gradient positions)`` for every op of
    ``ops/tensor.py``, ``ops/nn.py`` and ``ops/vision.py`` at the sizes
    the paths give them: (64, 4096) for elementwise ops and reductions,
    (32, 30522) with forced ties for the orderings."""
    f = lambda *s: rng.randn(*s).astype("float32")  # noqa: E731
    x, y, yb = f(64, 4096), f(64, 4096), f(1, 4096)
    pos = (rng.rand(64, 4096) + 0.5).astype("float32")
    u = rng.uniform(-0.9, 0.9, (64, 4096)).astype("float32")
    i32 = rng.randint(-50, 50, (64, 4096)).astype("int32")
    u8 = rng.randint(0, 255, (64, 4096)).astype("uint8")
    g0 = (0,)
    cases = []
    for name in ("negative", "abs", "sign", "ceil", "floor", "round", "rint",
                 "trunc", "fix", "square", "cbrt", "exp", "expm1", "sin",
                 "cos", "tan", "arctan", "sinh", "cosh", "tanh", "arcsinh",
                 "degrees", "radians", "reciprocal", "erf", "logical_not",
                 "relu", "sigmoid", "softsign", "softrelu", "hard_sigmoid",
                 "identity", "BlockGrad", "isnan", "isinf", "isfinite"):
        differentiable = name not in ("logical_not", "BlockGrad", "isnan",
                                      "isinf", "isfinite")
        cases.append(("elementwise", name, [x], {},
                      g0 if differentiable else ()))
    for name in ("sqrt", "rsqrt", "rcbrt", "log", "log10", "log2", "log1p"):
        cases.append(("elementwise", name, [pos], {}, g0))
    for name in ("arcsin", "arccos", "arctanh"):
        cases.append(("elementwise", name, [u], {}, g0))
    cases += [("elementwise", "arccosh", [pos + 1], {}, g0),
              ("special", "erfinv", [u], {}, ()),
              ("special", "gamma", [pos], {}, ()),
              ("special", "gammaln", [pos], {}, ()),
              ("special", "digamma", [pos], {}, ()),
              ("elementwise", "cast", [x * 1e3], {"dtype": "int8"}, ()),
              ("elementwise", "cast", [x], {"dtype": "float16"}, ()),
              ("elementwise", "clip", [x], {"a_min": -0.5, "a_max": 0.7},
               g0)]
    for name in ("add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "hypot", "arctan2", "mod", "floor_divide",
                 "power"):
        b = pos if name in ("mod", "floor_divide", "power") else y
        cases += [("binary", name, [pos if name == "power" else x, b], {},
                   (0, 1) if name not in ("mod", "floor_divide") else ()),
                  ("binary", name, [i32, onp.abs(i32) % 7 + 1], {}, ())]
    for name in ("equal", "not_equal", "greater", "greater_equal", "lesser",
                 "lesser_equal", "logical_and", "logical_or",
                 "logical_xor"):
        cases += [("binary", name, [onp.round(x), onp.round(yb)], {}, ()),
                  ("binary", name, [i32, i32[::-1].copy()], {}, ())]
    cases += [("binary", "add_n", [x, y, pos], {}, (0, 2)),
              ("binary", "where", [(x > 0).astype("float32"), x, y], {},
               (1, 2))]
    for name in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min",
                 "norm", "logsumexp"):
        for kw in ({}, {"axis": 1}, {"axis": 0, "keepdims": True}):
            data = pos if name in ("prod", "nanprod") and not kw else x
            cases.append(("reduction", name, [data * (0.1 if name in (
                "prod", "nanprod") and kw.get("axis") == 1 else 1.0)],
                kw, g0 if name not in ("max", "min") else ()))
    for name in ("sum", "mean", "prod", "max", "min", "nansum"):
        cases += [("reduction", name, [u8], {"axis": 1}, ()),
                  ("reduction", name, [i32 % 3], {}, ())]
    ties = onp.round(f(32, 30522) * 2)
    ties[:, 17] = ties[:, 20000] = ties[:, 30521] = ties.max() + 1
    for name in ("argmax", "argmin"):
        cases += [("ordering", name, [ties], {"axis": 1}, ()),
                  ("ordering", name, [ties], {}, ())]
    cases.append(("ordering", "argmax_channel", [ties], {}, ()))
    for kw in ({}, {"is_ascend": False}):
        cases += [("ordering", "sort", [ties], kw, ()),
                  ("ordering", "argsort", [ties], kw, ())]
    for kw in ({"k": 10}, {"k": 5, "is_ascend": True},
               {"k": 10, "ret_typ": "both"}, {"k": 10, "ret_typ": "value"},
               {"k": 3, "ret_typ": "mask"}):
        cases.append(("ordering", "topk", [ties], kw, ()))
    a3, m, spd = f(32, 128, 256), f(256, 256), None
    spd = (m @ m.T / 256 + onp.eye(256, dtype="float32")).astype("float32")
    low = onp.tril(m) / 16 + 4 * onp.eye(256, dtype="float32")
    cases += [
        ("linalg", "dot", [f(512, 1024), f(1024, 512)], {}, (0, 1)),
        ("linalg", "dot", [f(1024, 512), f(1024, 256)],
         {"transpose_a": True}, ()),
        ("linalg", "batch_dot", [a3, f(32, 256, 64)], {}, (0, 1)),
        ("linalg", "matmul", [a3, f(256, 64)], {}, ()),
        ("linalg", "khatri_rao", [f(16, 64), f(32, 64)], {}, ()),
        ("linalg", "linalg_gemm", [f(32, 64, 128), f(32, 128, 64),
                                   f(32, 64, 64)], {"alpha": 0.5}, ()),
        ("linalg", "linalg_gemm2", [f(32, 64, 128), f(32, 64, 128)],
         {"transpose_b": True}, ()),
        ("linalg", "linalg_potrf", [spd], {}, ()),
        ("linalg", "linalg_trsm", [low, f(256, 64)], {}, ()),
        ("linalg", "linalg_trsm", [low, f(64, 256)],
         {"rightside": True, "transpose": True}, ()),
        ("linalg", "linalg_trmm", [low, f(256, 64)], {"lower": True}, ()),
        ("linalg", "linalg_sumlogdiag", [spd], {}, ()),
        ("linalg", "linalg_syrk", [f(128, 256)], {"alpha": 2.0}, ()),
        ("linalg", "linalg_extractdiag", [spd], {"offset": 1}, ()),
        ("linalg", "linalg_makediag", [f(32, 64)], {}, ()),
        ("linalg", "tril", [m], {"k": 1}, ()),
        ("linalg", "triu", [m], {"k": -1}, ()),
        ("linalg", "kron", [f(16, 16), f(32, 32)], {}, ()),
        ("linalg", "trace", [m], {}, ()),
    ]
    idx = rng.randint(-10, 4200, (64, 128)).astype("float32")
    img = f(32, 64, 28, 28)
    cases += [
        ("shape", "reshape", [a3], {"shape": (-3, -2)}, ()),
        ("shape", "reshape", [a3], {"shape": (0, -4, 4, -1, -2)}, ()),
        ("shape", "reshape_like", [x, f(4096, 64)], {}, ()),
        ("shape", "transpose", [a3], {"axes": (2, 0, 1)}, ()),
        ("shape", "swapaxes", [a3], {"dim1": 0, "dim2": 2}, ()),
        ("shape", "flatten", [img], {}, ()),
        ("shape", "expand_dims", [x], {"axis": 1}, ()),
        ("shape", "squeeze", [f(64, 1, 4096)], {}, ()),
        ("shape", "broadcast_to", [yb], {"shape": (64, 0)}, g0),
        ("shape", "broadcast_like", [yb, x], {}, ()),
        ("shape", "broadcast_axis", [f(64, 1, 256)],
         {"axis": 1, "size": 16}, ()),
        ("shape", "slice", [a3], {"begin": (0, None, 255),
                                  "end": (32, 64, 0), "step": (2, 1, -3)},
         g0),
        ("shape", "slice_axis", [a3], {"axis": 2, "begin": 7, "end": -9},
         ()),
        ("shape", "slice_like", [a3, f(16, 64, 3)], {"axes": (0, 1)}, ()),
        ("shape", "take", [x, idx], {}, g0),
        ("shape", "take", [x, idx], {"axis": 1, "mode": "wrap"}, ()),
        ("shape", "pick", [x, idx[:, 0]], {}, g0),
        ("shape", "gather_nd", [x, onp.stack([idx[:, 0] % 64,
                                              idx[:, 1] % 4096])], {}, ()),
        ("shape", "scatter_nd", [f(128), onp.stack([
            onp.arange(128) % 64, onp.arange(128) * 31 % 4096]).astype(
                "float32")], {"shape": (64, 4096)}, ()),
        ("shape", "one_hot", [idx[:, :4] % 1000], {"depth": 1000}, ()),
        ("shape", "concat", [x, y, pos], {"dim": 1}, ()),
        ("shape", "stack", [x, y], {"axis": 1}, ()),
        ("shape", "split", [x], {"num_outputs": 4, "axis": 1}, ()),
        ("shape", "split_v2", [x], {"indices_or_sections": (100, 3000),
                                    "axis": 1}, ()),
        ("shape", "tile", [f(64, 256)], {"reps": (2, 4)}, ()),
        ("shape", "repeat", [f(64, 256)], {"repeats": 3, "axis": 1}, ()),
        ("shape", "pad", [img], {"mode": "constant", "pad_width": (
            0, 0, 0, 0, 2, 1, 1, 2), "constant_value": 0.5}, ()),
        ("shape", "reverse", [a3], {"axis": (0, 2)}, ()),
        ("shape", "roll", [a3], {"shift": 5, "axis": 2}, ()),
        ("shape", "diag", [m], {"k": 2}, ()),
        ("shape", "depth_to_space", [img], {"block_size": 2}, ()),
        ("shape", "space_to_depth", [img], {"block_size": 2}, ()),
        ("shape", "ravel_multi_index", [onp.stack([idx[:, 0] % 70,
                                                   idx[:, 1] % 4200])],
         {"shape": (64, 4096)}, ()),
        ("shape", "unravel_index", [idx[:, 0] * 50], {"shape": (64, 4096)},
         ()),
        ("shape", "shape_array", [a3], {}, ()),
        ("shape", "size_array", [a3], {}, ()),
        ("shape", "zeros_like", [x], {}, ()),
        ("shape", "ones_like", [i32], {}, ()),
        ("shape", "_sym_zeros", [], {"shape": (64, 4096)}, ()),
        ("shape", "_sym_ones", [], {"shape": (64, 4096), "dtype": "int32"},
         ()),
        ("shape", "full_like", [x], {"fill_value": 3.5}, ()),
        ("shape", "cumsum", [x], {"axis": 1}, ()),
        ("shape", "cumprod", [pos[:, :64]], {"axis": 1}, ()),
        ("shape", "bincount", [idx % 5000], {}, ()),
        ("shape", "boolean_mask", [x, (idx[:, 0] > 2000).astype(
            "float32")], {}, g0),
        ("shape", "index_copy", [x, onp.arange(0, 64, 3).astype(
            "float32"), f(22, 4096)], {}, ()),
        ("shape", "index_array", [img[:2]], {"axes": (1, 3)}, ()),
        ("shape", "Embedding", [idx, f(4200, 64)], {}, (1,)),
        ("shape", "all_finite", [x], {}, ()),
        ("shape", "multi_all_finite", [x, y], {}, ()),
        ("shape", "make_loss", [x], {"normalization": "batch"}, g0),
    ]
    seq = f(128, 64, 256)
    lens = rng.randint(0, 129, 64).astype("float32")
    cases += [
        ("sequence", "SequenceMask", [seq, lens],
         {"use_sequence_length": True, "value": -1.0}, g0),
        ("sequence", "SequenceMask", [seq.transpose(1, 0, 2).copy(), lens],
         {"use_sequence_length": True, "axis": 1}, ()),
        ("sequence", "SequenceLast", [seq, lens],
         {"use_sequence_length": True}, g0),
        ("sequence", "SequenceLast", [seq.transpose(1, 0, 2).copy(), lens],
         {"use_sequence_length": True, "axis": 1}, ()),
        ("sequence", "SequenceReverse", [seq, lens],
         {"use_sequence_length": True}, g0),
    ]
    feat = f(32, 256, 28, 28)
    logits = f(32, 30522)
    cases += [
        ("nn", "Convolution", [feat, f(128, 256, 3, 3), f(128)],
         {"kernel": (3, 3), "pad": (1, 1), "stride": (2, 2)}, (0, 1, 2)),
        ("nn", "Convolution", [feat, f(256, 1, 3, 3)],
         {"kernel": (3, 3), "pad": (1, 1), "num_group": 256,
          "no_bias": True}, (0, 1)),
        ("nn", "Deconvolution", [feat, f(256, 64, 4, 4)],
         {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
          "no_bias": True}, (0, 1)),
        ("nn", "Pooling", [feat], {"kernel": (3, 3), "stride": (2, 2),
                                   "pool_type": "max",
                                   "pooling_convention": "full"}, g0),
        ("nn", "Pooling", [feat], {"kernel": (2, 2), "stride": (2, 2),
                                   "pool_type": "avg"}, g0),
        ("nn", "BatchNorm", [feat, f(256), f(256), f(256) * 0.1,
                             onp.abs(f(256)) + 0.5],
         {"fix_gamma": False, "training": True}, (0, 1, 2)),
    ]
    labels = rng.randint(0, 30522, 32).astype("float32")
    cases += [
        ("nn", "GroupNorm", [feat, f(256), f(256)], {"num_groups": 32},
         (0, 1, 2)),
        ("nn", "InstanceNorm", [feat, f(256), f(256)], {}, (0,)),
        ("nn", "L2Normalization", [feat], {"mode": "channel"}, g0),
        ("nn", "RMSNorm", [f(64, 1024), f(1024)], {}, (0, 1)),
        ("nn", "LRN", [f(32, 96, 55, 55)], {"nsize": 5}, g0),
        ("nn", "LayerNorm", [feat, f(256), f(256)], {"axis": 1}, g0),
        ("nn", "FullyConnected", [f(64, 1024), f(512, 1024), f(512)], {},
         (0, 1)),
        ("nn", "Activation", [x], {"act_type": "softrelu"}, g0),
        ("nn", "LeakyReLU", [x], {"act_type": "elu", "slope": 0.3}, g0),
        ("nn", "LeakyReLU", [feat, f(256)], {"act_type": "prelu"}, ()),
        ("nn", "gelu_tanh", [x], {}, g0),
        ("nn", "silu", [x], {}, g0),
        ("nn", "softmax", [logits], {"temperature": 2.0}, g0),
        ("nn", "softmax", [f(64, 16, 512), onp.full((64, 16), 300,
                                                    "float32")],
         {"use_length": True}, g0),
        ("nn", "log_softmax", [logits], {}, g0),
        ("nn", "softmin", [logits], {}, ()),
        ("nn", "SoftmaxActivation", [feat[:4]], {"mode": "channel"}, ()),
        ("nn", "masked_softmax", [x, (y > 0).astype("float32")], {}, ()),
        ("nn", "softmax_cross_entropy", [logits, labels], {}, g0),
        ("nn", "smooth_l1", [x], {"scalar": 2.0}, g0),
        ("output", "SoftmaxOutput", [logits, labels],
         {"normalization": "batch"}, g0),
        ("output", "SoftmaxOutput", [f(32, 10, 49), rng.randint(
            -1, 10, (32, 49)).astype("float32")],
         {"multi_output": True, "use_ignore": True,
          "normalization": "valid"}, g0),
        ("output", "LinearRegressionOutput", [x, y], {}, g0),
        ("output", "LogisticRegressionOutput", [x, (y > 0).astype(
            "float32")], {}, g0),
        ("output", "MAERegressionOutput", [x, y], {}, g0),
        ("output", "SVMOutput", [logits[:, :1000], labels % 1000], {}, g0),
        ("output", "MakeLoss", [x], {"normalization": "valid",
                                     "valid_thresh": 0.5}, g0),
        ("resample", "UpSampling", [img], {"scale": 2}, g0),
        ("resample", "UpSampling", [img], {"scale": 2,
                                           "sample_type": "bilinear"}, g0),
        ("resample", "contrib_BilinearResize2D", [img],
         {"height": 17, "width": 40}, g0),
        ("resample", "im2col", [img], {"kernel": (3, 3), "pad": (1, 1)},
         ()),
        ("resample", "col2im", [f(32, 576, 784)], {"output_size": (28, 28),
                                                   "kernel": (3, 3),
                                                   "pad": (1, 1)}, ()),
    ]
    theta = (onp.tile([1, 0, 0, 0, 1, 0], (32, 1))
             + 0.1 * f(32, 6)).astype("float32")
    grid = rng.uniform(-1.1, 1.1, (32, 2, 56, 56)).astype("float32")
    cases += [
        ("vision", "GridGenerator", [theta], {"target_shape": (56, 56)},
         ()),
        ("vision", "GridGenerator", [f(32, 2, 56, 56)],
         {"transform_type": "warp"}, ()),
        ("vision", "BilinearSampler", [f(32, 64, 56, 56), grid], {},
         (0, 1)),
        ("vision", "SpatialTransformer", [f(32, 64, 56, 56), theta],
         {"target_shape": (28, 28)}, ()),
        ("vision", "Correlation", [f(4, 64, 48, 64), f(4, 64, 48, 64)],
         {"max_displacement": 4, "stride2": 2, "pad_size": 4}, ()),
        ("vision", "Crop", [img], {"h_w": (20, 24), "center_crop": True},
         ()),
        ("vision", "batch_take", [x, idx[:, 0]], {}, ()),
    ]
    # the fused RNN at the LM's widths (T 35, N 32, hidden 650), 2 layers,
    # bidirectional, every mode; CTC at a speech-like width (50 frames, 30
    # classes, labels of 1-12 padded with -1), both blank conventions
    from incubator_mxnet_tpu_torch.ops.nn import rnn_param_size
    T, N, H = 35, 32, 650
    seq = 0.5 * f(T, N, H)
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        size = rnn_param_size(mode, 2, H, H, True)
        args = [seq, (0.03 * rng.randn(size)).astype("float32"),
                0.5 * f(4, N, H)] + ([0.5 * f(4, N, H)]
                                     if mode == "lstm" else [])
        cases.append(("recurrent", "RNN", args,
                      {"state_size": H, "num_layers": 2, "mode": mode,
                       "bidirectional": True}, (0, 1, 2)))
    Tc, Nc, Cc, Lc = 50, 32, 30, 12
    ll = rng.randint(1, Lc + 1, Nc)
    dl = rng.randint(2 * Lc + 2, Tc + 1, Nc).astype("float32")
    for blank, lo, hi in (("first", 1, Cc), ("last", 0, Cc - 1)):
        lab = rng.randint(lo, hi, (Nc, Lc)).astype("float32")
        lab[onp.arange(Lc)[None, :] >= ll[:, None]] = -1
        cases.append(("recurrent", "CTCLoss",
                      [f(Tc, Nc, Cc), lab, dl, ll.astype("float32")],
                      {"use_data_lengths": True, "use_label_lengths": True,
                       "blank_label": blank}, (0,)))
    return cases


def _nd_on(v, ctx):
    if isinstance(v, onp.ndarray):
        return nd.array(v, ctx=ctx, dtype=v.dtype)
    return v


def _nd_run(name, args, kw, grad, ctx, cot_seed):
    """``mx.nd.<name>`` on ``ctx``: the outputs (numpy) and, for the
    positions in ``grad``, the gradients for a seeded cotangent."""
    op = getattr(nd, name)
    arrs = [_nd_on(a, ctx) for a in args]
    kws = {k: _nd_on(v, ctx) for k, v in kw.items()}
    if not args:
        kws["ctx"] = ctx    # a source op (``_sym_zeros``) makes it there
    if not grad:
        out = op(*arrs, **kws)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in outs], [str(o.dtype) for o in outs], []
    for i in grad:
        arrs[i].attach_grad()
    with autograd.record():
        out = op(*arrs, **kws)
        outs = out if isinstance(out, (list, tuple)) else [out]
    cot = onp.asarray(onp.random.RandomState(cot_seed).randn(
        *outs[0].shape), "float32")
    outs[0].backward(nd.array(cot, ctx=ctx))
    return ([o.asnumpy() for o in outs], [str(o.dtype) for o in outs],
            [arrs[i].grad.asnumpy() for i in grad])


def _nd_err(a, b) -> float:
    """max |a - b| over max(|b|, 1) (NaN where NaN; inf where inf)."""
    a, b = a.astype("float64"), b.astype("float64")
    same = (onp.isnan(a) & onp.isnan(b)) | (a == b)
    fin = onp.isfinite(b)
    scale = max(float(onp.abs(b[fin]).max()) if fin.any() else 0.0, 1.0)
    diff = onp.where(same, 0.0, onp.abs(a - b))
    return float(onp.nan_to_num(diff, nan=onp.inf).max()) / scale \
        if diff.size else 0.0


def nd_ops_card_vs_cpu(seed: int = 0) -> dict:
    """(a) Every op of the registry's tensor, nn and vision modules on the
    card and on the CPU, on the same seeded inputs, by family: values,
    dtypes, ties and gradients."""
    from incubator_mxnet_tpu_torch.ops.registry import OPS
    cases = _nd_cases(onp.random.RandomState(seed))
    want = {id(d) for d in OPS.values() if d.module.rsplit(".", 1)[-1]
            in ("tensor", "nn", "vision")}
    covered = {id(OPS[c[1]]) for c in cases}
    missing = sorted({d.name for d in OPS.values() if id(d) in want
                      and id(d) not in covered})
    check(not missing, f"nd ops: no card case for {missing}")
    worst, failed = {}, []
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    for n, (family, name, args, kw, grad) in enumerate(cases):
        card = _nd_run(name, args, kw, grad, mx.gpu(0), n)
        cpu = _nd_run(name, args, kw, grad, mx.cpu(), n)
        tol = ND_TOL[family]
        errs = []
        for a, b, da, db in zip(card[0], cpu[0], card[1], cpu[1]):
            if da != db or a.shape != b.shape:
                failed.append(f"{name} {sorted(kw)}: {da}{a.shape} on the "
                              f"card, {db}{b.shape} on the CPU")
                continue
            exact = b.dtype.kind in "biu" or family == "ordering"
            e = _nd_err(a, b)
            if (exact and e != 0.0) or e > tol:
                failed.append(f"{name} {sorted(kw)}: output err {e:.2e} "
                              f"(tol {0.0 if exact else tol})")
            errs.append(e)
        for a, b in zip(card[2], cpu[2]):
            e = _nd_err(a, b)
            gtol = max(tol, ND_GRAD_TOL)
            if e > gtol:
                failed.append(f"{name} {sorted(kw)}: gradient err {e:.2e} "
                              f"(tol {gtol})")
            errs.append(e)
        w = worst.setdefault(family, [0.0, "", 0])
        w[2] += 1
        if errs and max(errs) >= w[0]:
            w[0], w[1] = max(errs), name
    secs = time.perf_counter() - t0
    launches = cuda_ops.launch_counts()
    ops = len({id(OPS[c[1]]) for c in cases})
    print(f"nd ops: {ops} ops ({len(cases)} cases) card vs CPU in "
          f"{secs:.1f} s; worst error by family: " + ", ".join(
              f"{fam} {w[0]:.2e} ({w[1]}, {w[2]} cases, tol "
              f"{ND_TOL[fam]})" for fam, w in worst.items()), flush=True)
    check(not failed, "nd ops differ on the card:\n" + "\n".join(failed))
    check(not any(launches.values()), f"nd ops launched attention kernels:"
          f" {launches}")
    return {"ops": ops, "cases": len(cases), "seconds": secs,
            "worst_by_family": {k: {"err": v[0], "op": v[1], "cases": v[2]}
                                for k, v in worst.items()},
            "launches": launches}


def nd_samplers_on_card() -> dict:
    """(b) Each sampler on the card: the same draws after the same
    ``mx.random.seed``, and the mean and variance of ``ND_DRAWS`` draws
    within ``ND_SE`` standard errors of the distribution's."""
    ctx, n = mx.gpu(0), ND_DRAWS
    samplers = {
        "uniform": (lambda: nd.random.uniform(-1.0, 3.0, shape=n, ctx=ctx),
                    1.0, 16 / 12),
        "normal": (lambda: nd.random.normal(2.0, 3.0, shape=n, ctx=ctx),
                   2.0, 9.0),
        "randint": (lambda: nd.random.randint(-3, 5, shape=n, ctx=ctx),
                    0.5, 5.25),
        "exponential": (lambda: nd.random.exponential(2.0, shape=n,
                                                      ctx=ctx), 2.0, 4.0),
        "gamma": (lambda: nd.random.gamma(3.0, 2.0, shape=n, ctx=ctx),
                  6.0, 12.0),
        "poisson": (lambda: nd.random.poisson(4.0, shape=n, ctx=ctx),
                    4.0, 4.0),
        "negative_binomial": (lambda: nd.random.negative_binomial(
            3, 0.4, shape=n, ctx=ctx), 4.5, 11.25),
        "generalized_negative_binomial": (
            lambda: nd.random.generalized_negative_binomial(
                2.0, 0.5, shape=n, ctx=ctx), 2.0, 4.0),
        "bernoulli": (lambda: nd.random.bernoulli(0.3, shape=n, ctx=ctx),
                      0.3, 0.21),
        "multinomial": (lambda: nd.random.multinomial(
            nd.array([0.1, 0.2, 0.7], ctx=ctx), shape=n), 1.6, 0.44),
    }
    res = {}
    for name, (draw, mean, var) in samplers.items():
        mx.random.seed(3)
        a = draw().asnumpy().astype("float64")
        mx.random.seed(3)
        b = draw().asnumpy().astype("float64")
        m, v = a.mean(), a.var()
        se_m, se_v = onp.sqrt(var / n), ((a - m) ** 2).std() / onp.sqrt(n)
        res[name] = {"mean": m, "var": v, "want_mean": mean,
                     "want_var": var, "same_draws": bool((a == b).all())}
        check((a == b).all(), f"{name}: other draws after the same seed")
        check(abs(m - mean) < ND_SE * se_m and abs(v - var) < ND_SE * se_v,
              f"{name}: mean {m} var {v} against {mean} {var} (SE {se_m}, "
              f"{se_v})")
    mx.random.seed(3)
    perm = nd.random.shuffle(nd.arange(n, ctx=ctx)).asnumpy()
    check((onp.sort(perm) == onp.arange(n)).all(), "shuffle lost rows")
    print(f"nd samplers on the card: {len(res)} samplers x {n:,} draws, "
          f"same draws after the same seed, moments within {ND_SE} SE: "
          + ", ".join(f"{k} {r['mean']:.4f}/{r['var']:.4f}"
                      for k, r in res.items()), flush=True)
    return res


def nd_refuses_capture() -> dict:
    """(c) ``boolean_mask`` and ``bincount`` (output shapes that depend on
    the data) raise inside a CUDA graph capture, naming the op."""
    from incubator_mxnet_tpu_torch.base import MXNetError
    x = torch.ones(8, 4, device="cuda")
    mask = torch.ones(8, device="cuda")
    res = {}
    for name, call in (("boolean_mask", lambda: nd.boolean_mask(x, mask)),
                       ("bincount", lambda: nd.bincount(mask))):
        g, s = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        msg = ""
        with torch.cuda.stream(s):
            g.capture_begin()
            try:
                call()
            except MXNetError as e:
                msg = str(e)
            finally:
                g.capture_end()
        torch.cuda.current_stream().wait_stream(s)
        check(name in msg and "capture" in msg, f"{name} did not refuse a "
              f"CUDA graph capture: {msg!r}")
        res[name] = msg[:80]
    print(f"nd ops refuse a capture: {sorted(res)}", flush=True)
    return res


def phase_nd_ops() -> dict:
    """The op surface on the card: (a) every op against the CPU, (b) the
    samplers, (c) the data-dependent shapes under a capture."""
    t0 = time.perf_counter()
    res = {"ops": nd_ops_card_vs_cpu(), "samplers": nd_samplers_on_card(),
           "capture": nd_refuses_capture()}
    res["launches"] = res["ops"]["launches"]
    res["seconds"] = time.perf_counter() - t0
    return res


def _mobilenet(name, ctx, classes: int, seed: int = 0):
    """A zoo model on ``ctx``, seeded ``Xavier`` (drawn on the CPU, so
    twins on any device have the same weights; shapes at the first
    call)."""
    net = gluon.model_zoo.vision.get_model(name, classes=classes)
    net.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(
        seed)), ctx=ctx)
    return net


def _gluon_step(net, trainer, x, y, loss_fn, batch_size):
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)
    return loss


def mobilenet_bench() -> dict:
    """(a) MobileNet v2 1.0 and v1 1.0 (1000 classes, batch 32, 224x224)
    through the image-classification example loop, hybridized, SGD
    momentum, with ``--amp`` and without, in turns: step ms and imgs/s
    of the last epoch, the median over the turns (their spread
    printed)."""
    from incubator_mxnet_tpu_torch.models import image_classification as ic
    res = {}
    order = {"mobilenetv2_1.0": ("float32", "amp", "amp", "float32",
                                 "float32", "amp"),
             "mobilenet1.0": ("float32", "amp", "amp", "float32")}
    launches = {}
    for model in MOBILENET_MODELS:
        for mode in order[model]:
            gc.collect()
            torch.cuda.empty_cache()
            cuda_ops.reset_launches()
            with _amp_on(False):
                out = ic.image_classification_example(
                    model=model, classes=1000, image_size=224, epochs=2,
                    batch_size=32, amp=mode == "amp", ctx=mx.gpu(0))
            got = cuda_ops.launch_counts()
            launches = {k: launches.get(k, 0) + v for k, v in got.items()}
            check(all(onp.isfinite(out["losses"])), f"{model} {mode}: "
                  "non-finite loss")
            steps = len(out["losses"]) // len(out["epoch_seconds"])
            r = res.setdefault(model, {}).setdefault(mode, {
                "epoch_s_runs": [], "first_epoch_s": out["epoch_seconds"][0],
                "losses": out["losses"]})
            r["epoch_s_runs"].append(out["epoch_seconds"][-1])
            r["steps_per_epoch"] = steps
            median = statistics.median(r["epoch_s_runs"])
            r["step_ms"] = median / steps * 1e3
            r["step_ms_min_max"] = [t / steps * 1e3 for t in (
                min(r["epoch_s_runs"]), max(r["epoch_s_runs"]))]
            r["imgs_per_s"] = 32 * steps / median
    card = card_line()
    for model, modes in res.items():
        for mode, r in modes.items():
            lo, hi = r["step_ms_min_max"]
            print(f"mobilenet {model} example loop, {mode}: "
                  f"{r['step_ms']:.3f} ms per step = {r['imgs_per_s']:.1f} "
                  f"imgs/s (median of {len(r['epoch_s_runs'])} turns' last "
                  f"epochs of {r['steps_per_epoch']} steps; turns "
                  f"{lo:.3f} to {hi:.3f} ms; last-epoch runs "
                  f"{[round(s, 4) for s in r['epoch_s_runs']]} s), first "
                  f"epoch {r['first_epoch_s']:.1f} s, loss "
                  f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} on {card}",
                  flush=True)
    check(not any(launches.values()), f"mobilenet launched attention "
          f"kernels: {launches}")
    res["launches"] = launches
    return res


def mobilenet_profile(model: str = "mobilenetv2_1.0") -> dict:
    """(b) One hybridized step of the example's loop (batch 32, 224x224,
    1000 classes) under ``torch.profiler``, float32 and ``--amp``: device
    time by group (depthwise convolutions, the other (pointwise)
    convolutions, BatchNorm, elementwise, the optimizer) and the idle
    share."""
    res = {}
    rng = onp.random.RandomState(0)
    xb = rng.rand(32, 3, 224, 224).astype("float32")
    yb = rng.randint(0, 1000, 32).astype("float32")
    for mode in ("float32", "amp"):
        gc.collect()
        torch.cuda.empty_cache()
        with _amp_on(mode == "amp"):
            net = _mobilenet(model, mx.gpu(0), 1000)
            net.hybridize()
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.05,
                                     "momentum": 0.9})
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            x, y = nd.array(xb, ctx=mx.gpu(0)), nd.array(yb, ctx=mx.gpu(0))
            for _ in range(3):
                _gluon_step(net, trainer, x, y, loss_fn, 32)
            wall, per_kernel = device_split(
                lambda: _gluon_step(net, trainer, x, y, loss_fn, 32))
        r = {"profiled_step_wall_ms": wall}
        r.update(group_split(per_kernel, MOBILENET_GROUPS))
        busy = r["profiled_device_ms"]
        r["device_idle_share"] = max(0.0, 1.0 - busy / wall) if wall else 0.0
        print(f"mobilenet {model} {mode} profile: one hybridized step "
              f"{wall:.3f} ms wall, device busy {busy:.3f} ms in "
              f"{r['kernels']} kernels, idle share "
              f"{r['device_idle_share']:.1%}; by group: " + ", ".join(
                  f"{g} {t:.3f} ms ({r['share_by_group'].get(g, 0):.1%})"
                  for g, t in r["ms_by_group"].items()), flush=True)
        for t in r["top"][:6]:
            print(f"  {t['ms']:9.3f} ms {t['share']:6.1%}  {t['kernel']}",
                  flush=True)
        res[mode] = r
    return res


def _mobilenet_twin_steps(name, ctxs, hybrid, steps, B=8, img=64,
                          classes=10, dtype="float32"):
    """``steps`` Gluon training steps of twin nets (same weights and
    batches), one per ``(ctx, hybridize)``: the nets and the losses."""
    rng = onp.random.RandomState(5)
    xb = rng.rand(B, 3, img, img).astype("float32")
    yb = rng.randint(0, classes, B).astype("float32")
    nets, losses = [], []
    for ctx, hyb in zip(ctxs, hybrid):
        net = _mobilenet(name, ctx, classes)
        net(nd.array(xb[:1], ctx=ctx))
        if dtype != "float32":
            net.cast(dtype)
        if hyb:
            net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        x = nd.array(xb, ctx=ctx, dtype=dtype)
        y = nd.array(yb, ctx=ctx, dtype=dtype)
        run = []
        for _ in range(steps):
            run.append(float(_gluon_step(net, trainer, x, y, loss_fn,
                                         B).mean().asscalar()))
        nets.append(net)
        losses.append(run)
    return nets, losses


def _net_rel_err(nets, pick) -> tuple:
    """max |a - b| over the largest |b| of all the net's tensors
    ``pick(param)``, and the parameter where it is largest (one scale for
    the net: a BatchNorm beta that feeds a training-mode BatchNorm holds
    rounding noise only)."""
    n0, n1 = len(nets[0].prefix), len(nets[1].prefix)
    by_suffix = {k[n1:]: p for k, p in nets[1].collect_params().items()}
    diffs, scale = {}, 0.0
    for k, p in nets[0].collect_params().items():
        a, b = pick(p), pick(by_suffix[k[n0:]])
        if a is None or b is None:
            continue
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        diffs[k] = float((a - b).abs().max())
        scale = max(scale, float(b.abs().max()))
    worst = max(diffs, key=diffs.get)
    return diffs[worst] / scale, worst


def mobilenet_hybrid_gate(steps: int = 3, img: int = 64) -> dict:
    """(c) At mobilenet0.25 (float32, batch 8, ``img`` x ``img``, 10
    classes), the hybridized Gluon loop (CUDA graphs) against the eager
    one under ``torch.use_deterministic_algorithms``: losses, weights and
    running statistics after ``steps`` steps. Two eager loops without
    deterministic algorithms are compared the same way and printed: how
    far the kernels' own rounding parts two runs of one loop."""
    gc.collect()
    nets, losses = _mobilenet_twin_steps("mobilenet0.25",
                                         (mx.gpu(0), mx.gpu(0)),
                                         (False, False), steps, img=img)
    free_loss = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    free_weights, free_name = _net_rel_err(nets, lambda p: p._var)
    print(f"mobilenet eager vs eager: mobilenet0.25 float32 batch 8 at "
          f"{img}, {steps} steps, without deterministic algorithms: "
          f"losses worst rel err {free_loss:.2e}, weights and running "
          f"statistics worst err {free_weights:.2e} of the largest "
          f"({free_name})", flush=True)
    del nets
    cuda_ops.reset_launches()
    torch.use_deterministic_algorithms(True)
    try:
        nets, losses = _mobilenet_twin_steps("mobilenet0.25",
                                             (mx.gpu(0), mx.gpu(0)),
                                             (True, False), steps, img=img)
    finally:
        torch.use_deterministic_algorithms(False)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    weights, wname = _net_rel_err(nets, lambda p: p._var)
    print(f"mobilenet gate: mobilenet0.25 float32 batch 8 at {img}, {steps} "
          f"steps, hybridized vs eager under deterministic algorithms: "
          f"losses {losses[0]} vs {losses[1]} (worst rel err "
          f"{loss_err:.2e}); weights and running statistics worst err "
          f"{weights:.2e} of the largest ({wname}), tol "
          f"{MOBILENET_GATE_RTOL}", flush=True)
    check(loss_err <= MOBILENET_GATE_RTOL and weights <= MOBILENET_GATE_RTOL,
          f"hybridized and eager MobileNet differ: losses {loss_err}, "
          f"weights {weights} at {wname}")
    return {"losses_hybrid": losses[0], "losses_eager": losses[1],
            "loss_rel_err": loss_err, "weights_worst_rel_err": weights,
            "weights_worst_param": wname,
            "bitwise": loss_err == 0.0 and weights == 0.0,
            "eager_vs_eager_nondeterministic": {
                "loss_rel_err": free_loss, "weights_worst_rel_err":
                free_weights, "weights_worst_param": free_name},
            "launches": cuda_ops.launch_counts()}


def _grads_by_suffix(net) -> dict:
    n = len(net.prefix)
    return {k[n:]: p._var.grad.detach().double().cpu() for k, p in
            net.collect_params().items() if p.grad_req != "null"}


def mobilenet_grads_vs_cpu(img: int = 64) -> dict:
    """(d) One Gluon step's gradients of mobilenet0.25 (batch 8, ``img`` x
    ``img``) on the card against the CPU's. The CPU's float32 step is the
    inexact one here: its gradients lie 3e-3 to 3e-2 of the largest from
    its float64 step, depending on the seed and size (the JAX package's on
    the CPU too), while the card's float32 gradients lie ~1e-5 from it.
    So the gate holds the card against the CPU's float64 step: in float64
    (the same function on both, within ``MOBILENET_GRAD_F64_RTOL``) and in
    float32 (within ``MOBILENET_GRAD_F32_RTOL``); the float32 card vs CPU
    distance is printed beside the CPU's own float32 error. Each error is
    max |a - b| over the net's largest gradient."""
    gc.collect()
    runs = {}
    for dtype in ("float32", "float64"):
        nets, losses = _mobilenet_twin_steps(
            "mobilenet0.25", (mx.gpu(0), mx.cpu()), (False, False), 1,
            img=img, dtype=dtype)
        runs[dtype] = ([_grads_by_suffix(n) for n in nets],
                       [lo[0] for lo in losses])

    def rel(a, b):
        scale = max(float(g.abs().max()) for g in b.values())
        errs = {k: float((a[k] - b[k]).abs().max()) / scale for k in b}
        worst = max(errs, key=errs.get)
        return errs[worst], worst
    (card32, cpu32), losses32 = runs["float32"]
    (card64, cpu64), losses64 = runs["float64"]
    e64, w64 = rel(card64, cpu64)
    e32, w32 = rel(card32, cpu64)
    cond, _ = rel(cpu32, cpu64)
    pair, _ = rel(card32, cpu32)
    tol32 = MOBILENET_GRAD_F32_RTOL
    print(f"mobilenet gradients: mobilenet0.25 batch 8 at {img}, one step: "
          f"float64 card vs CPU {e64:.2e} ({w64}), tol "
          f"{MOBILENET_GRAD_F64_RTOL}; float32 card vs the CPU's float64 step "
          f"{e32:.2e} ({w32}), tol {tol32:.2e} (the CPU's float32 step vs "
          f"its float64 step {cond:.2e}; card vs CPU in float32 "
          f"{pair:.2e}); losses float32 {losses32[0]:.6f} vs "
          f"{losses32[1]:.6f}, float64 {losses64[0]:.9f} vs "
          f"{losses64[1]:.9f}", flush=True)
    check(e64 <= MOBILENET_GRAD_F64_RTOL, f"MobileNet float64 gradients on the "
          f"card differ from the CPU's: {e64} at {w64}")
    check(e32 <= tol32, f"MobileNet float32 gradients on the card are "
          f"{e32} from the float64 step at {w32} (tol {tol32})")
    check(abs(losses32[0] - losses32[1]) <= 1e-4 * abs(losses32[1]),
          f"MobileNet losses differ: {losses32}")
    return {"float64_rel_err": e64, "float64_worst_param": w64,
            "float32_vs_float64": e32, "float32_worst_param": w32,
            "cpu_float32_vs_float64": cond, "card_vs_cpu_float32": pair,
            "losses_float32": losses32, "losses_float64": losses64}


def mobilenet_example_gate() -> dict:
    """(e) The JAX package's example test on the card: ``--model
    mobilenet0.25 --epochs 2 --classes 4 --batch-size 16``, accuracy
    above 0.5."""
    from incubator_mxnet_tpu_torch.models import image_classification as ic
    gc.collect()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    with _amp_on(False):
        out = ic.image_classification_example(ctx=mx.gpu(0),
                                              **MOBILENET_EXAMPLE)
    launches = cuda_ops.launch_counts()
    secs = time.perf_counter() - t0
    print(f"mobilenet example gate: {MOBILENET_EXAMPLE}: accuracy "
          f"{out['epochs']} (gate 0.5), loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, {secs:.1f} s", flush=True)
    check(out["accuracy"] > 0.5, f"the mobilenet0.25 example's accuracy "
          f"{out['accuracy']} <= 0.5")
    check(not any(launches.values()), f"the example launched attention "
          f"kernels: {launches}")
    return {"accuracy": out["accuracy"], "epochs": out["epochs"],
            "seconds": secs, "launches": launches}


def phase_mobilenet() -> dict:
    """MobileNet: (a) v2 and v1 at full width through the example loop,
    float32 and AMP in turns; (b) a profiled step; (c) hybridized =
    eager; (d) card vs CPU gradients; (e) the JAX example test's run."""
    t0 = time.perf_counter()
    res = {"bench": mobilenet_bench(), "profile": mobilenet_profile(),
           "hybrid_gate": mobilenet_hybrid_gate(),
           "grads_vs_cpu": mobilenet_grads_vs_cpu(),
           "example": mobilenet_example_gate()}
    res["launches"] = res["bench"]["launches"]
    res["seconds"] = time.perf_counter() - t0
    print(f"mobilenet: {res['seconds']:.1f} s", flush=True)
    return res


def phase_zoo(B: int = 8) -> dict:
    """The other zoo families at their published widths (1000 classes;
    224x224, Inception 299x299): the hybridized forward (CUDA graphs)
    against the eager one on the card (predict mode), then training steps
    of the hybridized net at batch ``B``: two warm ones (eager, capture),
    three timed, every loss finite."""
    t0 = time.perf_counter()
    res = {}
    cuda_ops.reset_launches()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for name, size in ZOO_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        rng = onp.random.RandomState(7)
        x = nd.array(rng.rand(B, 3, size, size).astype("float32"),
                     ctx=mx.gpu(0))
        y = nd.array(rng.randint(0, 1000, B).astype("float32"),
                     ctx=mx.gpu(0))
        net = _mobilenet(name, mx.gpu(0), 1000)
        with autograd.predict_mode():
            eager = net(x).asnumpy()
            net.hybridize()
            hyb = [net(x).asnumpy() for _ in range(2)]
        err = max(_nd_err(h, eager) for h in hyb)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.01, "momentum": 0.9})
        # the first call runs eagerly, the second captures the graphs
        first = [float(_gluon_step(net, trainer, x, y, loss_fn,
                                   B).mean().asscalar()) for _ in range(2)]
        ms, losses = synced_ms(lambda: _gluon_step(net, trainer, x, y,
                                                   loss_fn, B), 3)
        losses = first + [float(v.mean().asscalar()) for v in losses]
        res[name] = {"hybrid_vs_eager": err, "step_ms": ms,
                     "losses": losses, "image": size}
        print(f"zoo {name} ({size}x{size}, 1000 classes): hybridized vs "
              f"eager forward {err:.2e} (tol {ZOO_HYBRID_RTOL}); training "
              f"step at batch {B}: {ms:.3f} ms, losses {losses}",
              flush=True)
        check(err <= ZOO_HYBRID_RTOL, f"{name}: hybridized forward differs "
              f"from the eager one by {err}")
        check(all(onp.isfinite(losses)), f"{name}: non-finite loss "
              f"{losses}")
        del net, trainer
    res["launches"] = cuda_ops.launch_counts()
    check(not any(res["launches"].values()), f"the zoo launched attention "
          f"kernels: {res['launches']}")
    res["seconds"] = time.perf_counter() - t0
    print(f"zoo: {res['seconds']:.1f} s", flush=True)
    return res


# -- gluon.rnn, the example loops and the optimizers ------------------------
# The PTB "medium" recipe's widths (the reference's example/rnn/word_lm
# and example/gluon/word_language_model: emsize = nhid = 650, 2 layers,
# tied, dropout 0.5, bptt 35, batch 32, SGD lr 20, clip 0.25) at PTB's
# vocabulary of 10,000, on the example's synthetic Markov corpus
LM_CFG = dict(vocab=10000, emsize=650, nhid=650, nlayers=2, bptt=35,
              batch_size=32, dropout=0.5, lr=20.0, clip=0.25)
LM_TURNS = 3
LM_TURN_STEPS = 8
LM_WARM = 2            # a hybridized turn's first steps: eager, capture
# hybridized vs eager LM step: losses and weights after one step within
# 1e-5 of each tensor's largest value (deterministic algorithms)
LM_GATE_RTOL = 1e-5
# one full-width LM step's gradients (dropout 0) on the card against the
# CPU's float64 step, each over its parameter's largest gradient: the
# card's float64 step (the same function, float64 rounding apart) and its
# float32 step
LM_GRAD_F64_RTOL = 1e-9
LM_GRAD_F32_RTOL = 1e-4
LM_GROUPS = ("recurrent GEMMs", "input and decoder GEMMs",
             "LSTM GEMMs, replayed", "decoder GEMMs", "LSTM elementwise",
             "clip", "optimizer", "other", "unattributed")
LM_EXAMPLE = dict(steps=40, epochs=2)
LM_EXAMPLE_GATE = 12.0
DCGAN_EXAMPLE = dict(steps=300)
DCGAN_MEAN_GATE, DCGAN_STD_GATE = 0.3, 0.4
OPT_CASES = (
    ("nag", dict(learning_rate=0.05, momentum=0.9, wd=1e-3)),
    ("rmsprop", dict(learning_rate=1e-3, wd=1e-3)),
    ("rmsprop", dict(learning_rate=1e-3, centered=True, clip_weights=2.0)),
    ("adagrad", dict(learning_rate=0.05, wd=1e-3)),
    ("adadelta", dict(wd=1e-3)),
    ("ftrl", dict(learning_rate=0.05, wd=1e-3)),
    ("signum", dict(learning_rate=1e-3, wd=1e-3, wd_lh=1e-3)),
    ("lamb", dict(learning_rate=1e-3, wd=1e-3)),
    ("lars", dict(learning_rate=0.1, wd=1e-3)),
    ("dcasgd", dict(learning_rate=0.05, momentum=0.9, wd=1e-3)),
    ("sgld", dict(learning_rate=1e-3)),
    ("adamax", dict(wd=1e-3)),
    ("nadam", dict(wd=1e-3)),
    ("ftml", dict(wd=1e-3)),
)
# update_multi against update per parameter on the card: one rule over
# multi-tensor kernels either way
OPT_MULTI_RTOL = 1e-6
OPT_FUSED_RTOL = 1e-5
OPT_SGLD_SEED = 11


def _lm_model(ctx, dropout=LM_CFG["dropout"], seed: int = 0):
    from incubator_mxnet_tpu_torch.models import word_language_model as wlm
    mx.random.seed(seed)
    c = LM_CFG
    with ctx:
        model = wlm.RNNModel(c["vocab"], c["emsize"], c["nhid"],
                             c["nlayers"], dropout=dropout)
        model.initialize(mx.init.Xavier(), ctx=ctx)
    return model


def _lm_corpus(steps: int):
    """``steps`` chunks of the example's corpus at the LM's vocabulary, on
    the card, as the example cuts an epoch: ``[(data (T, N) int32, target
    (T*N,) float32)]``."""
    from incubator_mxnet_tpu_torch.models import word_language_model as wlm
    c = LM_CFG
    T, B = c["bptt"], c["batch_size"]
    corpus = wlm.batchify(wlm.make_corpus((steps * T + 1) * B + 1,
                                          c["vocab"],
                                          onp.random.RandomState(7)), B)
    return [(nd.array(corpus[i * T:(i + 1) * T], ctx=mx.gpu(0),
                      dtype="int32"),
             nd.array(corpus[i * T + 1:(i + 1) * T + 1].reshape(-1)
                      .astype("float32"), ctx=mx.gpu(0)))
            for i in range(steps)]


def lm_step(model, trainer, params, batch, states, loss_fn):
    """The example's step: truncated BPTT, record, loss, backward,
    ``clip_global_norm`` (one host read), ``trainer.step(1)``."""
    from torch.profiler import record_function
    data, target = batch
    states = [s.detach() for s in states]
    with autograd.record():
        logits, states = model(data, states)
        loss = loss_fn(logits.reshape((-1, LM_CFG["vocab"])), target).mean()
    loss.backward()
    with record_function("lm::clip"):
        gluon.utils.clip_global_norm([p.grad() for p in params],
                                     LM_CFG["clip"])
    with record_function("lm::optimizer"):
        trainer.step(1)
    return loss, states


def _is_gemm(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in ("gemm", "xmma", "cutlass", "gemv"))


def lm_device_groups(prof, rnn_range: str, replayed: bool) -> dict:
    """Device ms of one LM step by :data:`LM_GROUPS`, each kernel placed by
    the operator that launched it (a replayed graph's kernels by the
    operator that replayed it). GEMMs under ``addmm`` (the recurrence's
    one product per step, and its backward) are recurrent; GEMMs under the
    LSTM layer's range are its hoisted input projections, or, when the
    layer replays its graphs (``replayed``), all its products; other
    GEMMs the decoder's. Other kernels under the layer's range (forward,
    and through ``sequence_nr`` the backward of its operators) are its
    elementwise work; then the ``lm::clip`` and ``lm::optimizer``
    ranges."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def chain(e):
        out = []
        while e is not None:
            out.append(e)
            e = e.cpu_parent
        return out

    fwd = {}
    for e in evs:
        if e.sequence_nr >= 0 and "Backward" not in e.name \
                and not e.name.startswith("autograd::"):
            fwd.setdefault(e.sequence_nr, e)
    groups = {g: 0.0 for g in LM_GROUPS}
    for e in evs:
        if not e.kernels:
            continue
        anc = chain(e)
        names = [a.name for a in anc]
        back = next((a for a in anc if "Backward" in a.name
                     and a.sequence_nr >= 0), None)
        src = fwd.get(back.sequence_nr) if back is not None else e
        rnn = src is not None and any(a.name == rnn_range
                                      for a in chain(src))
        recur = any("addmm" in n.lower() for n in names)
        for k in e.kernels:
            if "lm::clip" in names:
                g = "clip"
            elif "lm::optimizer" in names:
                g = "optimizer"
            elif _is_gemm(k.name):
                g = ("recurrent GEMMs" if recur else
                     "LSTM GEMMs, replayed" if rnn and replayed else
                     "decoder GEMMs" if replayed else
                     "input and decoder GEMMs")
            elif rnn:
                g = "LSTM elementwise"
            else:
                g = "other"
            groups[g] += k.duration / 1e3
    return groups


def _device_kernels(prof) -> dict:
    """Device ms by kernel name: the card's kernels, copies and fills; not
    its synchronisation events (a host wait) nor the device-side spans of
    the ``lm::`` ranges (they cover the kernels)."""
    from torch.autograd import DeviceType
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "sync" not in e.name.lower() \
                and not e.name.startswith("lm::"):
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
    return per_kernel


def lm_profiled_step(model, trainer, params, batch, states, loss_fn,
                     tag: str) -> dict:
    """One LM step under ``torch.profiler``: wall ms, device ms, idle
    share, and device ms by :data:`LM_GROUPS`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rng = {}

    def pre(_blk, _args):
        rng["r"] = record_function("lm::rnn")
        rng["r"].__enter__()

    def post(_blk, _args, _out):
        rng.pop("r").__exit__(None, None, None)

    h1 = model.rnn.register_forward_pre_hook(pre)
    h2 = model.rnn.register_forward_hook(post)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lm_step(model, trainer, params, batch, states, loss_fn)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        h1.detach()
        h2.detach()
    per_kernel = _device_kernels(prof)
    busy = sum(per_kernel.values())
    groups = lm_device_groups(prof, "lm::rnn", tag == "hybrid")
    groups["unattributed"] = max(busy - sum(groups.values()), 0.0)
    res = {"wall_ms": wall, "device_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / wall) if wall else 0.0,
           "kernels": len(per_kernel), "ms_by_group": groups,
           "top": [{"kernel": k[:90], "ms": t} for k, t in sorted(
               per_kernel.items(), key=lambda r: -r[1])[:8]]}
    print(f"lm {tag} profile: one step {wall:.3f} ms wall (profiled), "
          f"device busy {busy:.3f} ms in {len(per_kernel)} kernels, idle "
          f"share {res['device_idle_share']:.1%}; device ms by group: "
          + ", ".join(f"{g} {t:.3f}" for g, t in groups.items() if t),
          flush=True)
    for t in res["top"]:
        print(f"  {t['ms']:9.3f} ms  {t['kernel']}", flush=True)
    return res


def _lm_snapshot(params):
    return [p.data()._data.detach().clone() for p in params]


def _lm_restore(params, snap):
    with torch.no_grad():
        for p, v in zip(params, snap):
            p.data()._data.copy_(v)


def lm_hybrid_gate(model, trainer, params, batch, loss_fn) -> dict:
    """One step eager and one step with the LSTM layer's graphs replayed,
    from the same weights, states and dropout stream, under deterministic
    algorithms: losses and the weights after the step within
    ``LM_GATE_RTOL`` of each tensor's largest value."""
    B = LM_CFG["batch_size"]
    snap = _lm_snapshot(params)
    states0 = [s.copy() for s in model.begin_state(B, ctx=mx.gpu(0))]
    outs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("eager", "hybrid"):
            model.rnn.hybridize(mode == "hybrid")
            if mode == "hybrid":
                for _ in range(LM_WARM):        # eager, then capture
                    lm_step(model, trainer, params, batch, states0, loss_fn)
                _lm_restore(params, snap)
            mx.random.seed(5)
            loss, _ = lm_step(model, trainer, params, batch, states0,
                              loss_fn)
            outs[mode] = (float(loss.asscalar()), _lm_snapshot(params))
            _lm_restore(params, snap)
    finally:
        torch.use_deterministic_algorithms(False)
        model.rnn.hybridize(False)
    (le, we), (lh, wh) = outs["eager"], outs["hybrid"]
    loss_err = abs(le - lh) / max(abs(le), 1.0)
    w_err = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                for a, b in zip(we, wh))
    print(f"lm hybrid gate: one step, hybridized vs eager (deterministic): "
          f"loss {lh:.6f} vs {le:.6f} (rel {loss_err:.2e}), weights after "
          f"the step {w_err:.2e} (tol {LM_GATE_RTOL})", flush=True)
    check(loss_err <= LM_GATE_RTOL and w_err <= LM_GATE_RTOL,
          f"lm: the hybridized step differs from the eager one: loss "
          f"{loss_err}, weights {w_err}")
    return {"loss_eager": le, "loss_hybrid": lh, "loss_rel_err": loss_err,
            "weights_rel_err": w_err}


def lm_grads_vs_cpu(model, batch) -> dict:
    """One step of the LM at full width, dropout 0, from ``model``'s
    weights and zero states: the gradients of every parameter on the card,
    in float32 and in float64, against the CPU's float64 step, each error
    max |a - b| over the parameter's largest gradient; the losses beside
    them."""
    c = LM_CFG
    names = dict(model._collect_params_with_prefix())
    data, target = (v.asnumpy() for v in batch)
    runs = {}
    for tag, ctx, dtype in (("card32", mx.gpu(0), "float32"),
                            ("card64", mx.gpu(0), "float64"),
                            ("cpu64", mx.cpu(), "float64")):
        twin = _lm_model(ctx, dropout=0.0)
        with torch.no_grad():
            for k, p in twin._collect_params_with_prefix().items():
                p.data()._data.copy_(names[k].data()._data)
        if dtype != "float32":
            twin.cast(dtype)
        states = twin.begin_state(c["batch_size"], ctx=ctx, dtype=dtype)
        with autograd.record():
            logits, _ = twin(nd.array(data, ctx=ctx, dtype="int32"), states)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                logits.reshape((-1, c["vocab"])),
                nd.array(target, ctx=ctx, dtype=dtype)).mean()
        loss.backward()
        runs[tag] = (float(loss.asscalar()), {
            k: p.grad()._data.detach().double().cpu() for k, p in
            twin._collect_params_with_prefix().items()})
        del twin

    def rel(a, b):
        errs = {k: float((a[k] - b[k]).abs().max())
                / max(float(b[k].abs().max()), 1e-30) for k in b}
        worst = max(errs, key=errs.get)
        return errs[worst], worst
    want = runs["cpu64"][1]
    e64, w64 = rel(runs["card64"][1], want)
    e32, w32 = rel(runs["card32"][1], want)
    losses = {k: v[0] for k, v in runs.items()}
    print(f"lm gradients: one step at full width, dropout 0, "
          f"{len(want)} gradients: float64 card vs CPU {e64:.2e} ({w64}), "
          f"tol {LM_GRAD_F64_RTOL}; float32 card vs the CPU's float64 step "
          f"{e32:.2e} ({w32}), tol {LM_GRAD_F32_RTOL}; losses {losses}",
          flush=True)
    check(e64 <= LM_GRAD_F64_RTOL, f"LM float64 gradients on the card "
          f"differ from the CPU's: {e64} at {w64}")
    check(e32 <= LM_GRAD_F32_RTOL, f"LM float32 gradients on the card are "
          f"{e32} from the float64 step at {w32}")
    check(abs(losses["card32"] - losses["cpu64"])
          <= 1e-5 * abs(losses["cpu64"]), f"LM losses differ: {losses}")
    return {"float64_rel_err": e64, "float64_worst_param": w64,
            "float32_vs_float64": e32, "float32_worst_param": w32,
            "losses": losses}


def lm_torch_yardstick(model, batch) -> dict:
    """Torch's fused LSTM (``torch.nn.LSTM``, cuDNN) with the LSTM layer's
    weights, dropout 0, at the same input: forward plus backward by CUDA
    events, beside the port's layer eager and hybridized (a yardstick; the
    port never calls it). Outputs compared for sanity."""
    c = LM_CFG
    rnn = model.rnn
    ref = torch.nn.LSTM(c["emsize"], c["nhid"], c["nlayers"]).cuda()
    with torch.no_grad():
        for i in range(c["nlayers"]):
            for mine, theirs in (("i2h_weight", "weight_ih"),
                                 ("h2h_weight", "weight_hh"),
                                 ("i2h_bias", "bias_ih"),
                                 ("h2h_bias", "bias_hh")):
                getattr(ref, f"{theirs}_l{i}").copy_(
                    getattr(rnn, f"l{i}_{mine}").data()._data)
    x = model.encoder(batch[0])._data.detach().requires_grad_(True)
    h = [s._data for s in model.begin_state(c["batch_size"],
                                            ctx=mx.gpu(0))]
    seed = torch.randn_like(x)

    def torch_fb():
        out, _ = ref(x, (h[0], h[1]))
        out.backward(seed)

    xa = nd.NDArray(x.detach())
    xa.attach_grad()
    sa = [nd.NDArray(t) for t in h]

    def port_fb():
        with autograd.record():
            out, _ = rnn(xa, sa)
        out.backward(nd.NDArray(seed))

    with torch.no_grad():
        want = ref(x, (h[0], h[1]))[0]
        got = rnn(xa, sa)[0]._data
    err = float((got - want).abs().max()) / float(want.abs().max())
    res = {"torch_lstm_ms": cuda_ms(torch_fb, target_ms=200.0),
           "port_eager_ms": cuda_ms(port_fb, target_ms=200.0)}
    rnn.hybridize(True)
    port_fb()
    port_fb()
    res["port_hybrid_ms"] = cuda_ms(port_fb, target_ms=200.0)
    rnn.hybridize(False)
    res["torch_vs_port_rel_err"] = err
    print(f"lm yardstick: LSTM layer forward+backward at (T {c['bptt']}, "
          f"N {c['batch_size']}, {c['nhid']}), {c['nlayers']} layers: torch "
          f"fused LSTM (cuDNN) {res['torch_lstm_ms']:.3f} ms, the port's "
          f"layer eager {res['port_eager_ms']:.3f} ms, hybridized "
          f"{res['port_hybrid_ms']:.3f} ms (CUDA events); outputs "
          f"{err:.2e} apart", flush=True)
    check(err < 1e-4, f"torch's LSTM and the port's differ by {err}")
    return res


def phase_lm() -> dict:
    """The LM at the PTB medium recipe's widths through the Gluon loop:
    eager and with the LSTM layer hybridized in turns, losses falling over
    the run; a profiled step of each; hybridized = eager; one step's
    gradients card = CPU; torch's fused LSTM as a yardstick."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    c = LM_CFG
    ctx = mx.gpu(0)
    model = _lm_model(ctx)
    params = [p for p in model.collect_params().values()
              if p.grad_req != "null"]
    trainer = gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": c["lr"]})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    steps = 2 * LM_TURNS * LM_TURN_STEPS
    # each turn is one of the example's epochs over the same chunks: the
    # states start at zero and the chunks come again (one pass over fresh
    # chunks teaches a 10,000-word chain nothing in 48 steps)
    batches = _lm_corpus(LM_TURN_STEPS)
    tokens = c["bptt"] * c["batch_size"]
    cuda_ops.reset_launches()
    losses, times = [], {"eager": [], "hybrid": []}
    for turn in range(LM_TURNS):
        for mode in ("eager", "hybrid"):
            model.rnn.hybridize(mode == "hybrid")
            states = model.begin_state(c["batch_size"], ctx=ctx)
            ms = []
            for batch in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                loss, states = lm_step(model, trainer, params, batch,
                                       states, loss_fn)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                losses.append(loss.detach())
            skip = LM_WARM if mode == "hybrid" else 1
            times[mode].append(statistics.mean(ms[skip:]))
    launches = cuda_ops.launch_counts()
    losses = [float(v.asscalar()) for v in losses]
    step_ms = {m: statistics.median(v) for m, v in times.items()}
    head = statistics.mean(losses[:LM_TURN_STEPS])
    tail = statistics.mean(losses[-LM_TURN_STEPS:])
    res = {"config": dict(c), "steps": steps, "losses": losses,
           "turn_ms": times, "step_ms": step_ms,
           "tokens_per_s": {m: tokens / v * 1e3 for m, v in step_ms.items()},
           "loss_head": head, "loss_tail": tail, "launches": launches}
    print(f"lm (vocab {c['vocab']}, {c['emsize']}/{c['nhid']} x "
          f"{c['nlayers']}, tied, bptt {c['bptt']}, batch "
          f"{c['batch_size']}, dropout {c['dropout']}, SGD lr {c['lr']}, "
          f"clip {c['clip']}): step ms median over {LM_TURNS} turns eager "
          f"{step_ms['eager']:.3f} ({res['tokens_per_s']['eager']:,.0f} "
          f"tokens/s), LSTM hybridized {step_ms['hybrid']:.3f} "
          f"({res['tokens_per_s']['hybrid']:,.0f} tokens/s); turns "
          f"{times}; loss over {steps} steps {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first {LM_TURN_STEPS} mean {head:.4f}, last "
          f"{tail:.4f})", flush=True)
    check(all(onp.isfinite(losses)), f"lm: non-finite loss {losses}")
    check(tail < head, f"lm: the loss did not fall ({head} -> {tail})")
    check(not any(launches.values()), f"the LM launched attention kernels:"
          f" {launches}")
    res["profile"] = {}
    for mode in ("eager", "hybrid"):
        model.rnn.hybridize(mode == "hybrid")
        for _ in range(LM_WARM):
            _, states = lm_step(model, trainer, params, batches[-1], states,
                                loss_fn)
        prof = lm_profiled_step(model, trainer, params, batches[-1], states,
                                loss_fn, mode)
        # the device's share of the unprofiled step (the profiler slows the
        # host, so its own step's idle share is larger)
        prof["idle_share_of_timed_step"] = max(
            0.0, 1.0 - prof["device_ms"] / step_ms[mode])
        print(f"lm {mode}: device busy {prof['device_ms']:.3f} ms of the "
              f"{step_ms[mode]:.3f} ms timed step: idle share "
              f"{prof['idle_share_of_timed_step']:.1%}", flush=True)
        res["profile"][mode] = prof
    model.rnn.hybridize(False)
    res["hybrid_gate"] = lm_hybrid_gate(model, trainer, params, batches[0],
                                        loss_fn)
    res["grads_vs_cpu"] = lm_grads_vs_cpu(model, batches[0])
    res["yardstick"] = lm_torch_yardstick(model, batches[0])
    res["seconds"] = time.perf_counter() - t0
    print(f"lm: {res['seconds']:.1f} s", flush=True)
    del model, trainer
    return res


def lm_example_gates() -> dict:
    """The JAX package's two example tests on the card:
    ``word_language_model.py --steps 40 --epochs 2`` (perplexity below
    12) and ``dcgan.py --steps 300`` (the fake images' mean within 0.3
    and deviation within 0.4 of the real ones')."""
    from incubator_mxnet_tpu_torch.models import dcgan
    from incubator_mxnet_tpu_torch.models import word_language_model as wlm
    res = {}
    for name, run in (
            ("lm_example", lambda: wlm.lm_example(ctx=mx.gpu(0),
                                                  **LM_EXAMPLE)),
            ("dcgan_example", lambda: dcgan.dcgan_example(
                ctx=mx.gpu(0), **DCGAN_EXAMPLE))):
        gc.collect()
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        out = run()
        res[name] = {k: v for k, v in out.items() if k != "losses"}
        res[name]["seconds"] = time.perf_counter() - t0
        res[name]["launches"] = cuda_ops.launch_counts()
        check(not any(res[name]["launches"].values()),
              f"{name} launched attention kernels: "
              f"{res[name]['launches']}")
    lm, dc = res["lm_example"], res["dcgan_example"]
    dc.pop("lossD"), dc.pop("lossG")
    print(f"lm example gate {LM_EXAMPLE}: perplexity by epoch "
          f"{lm['epoch_ppl']} (gate {LM_EXAMPLE_GATE}), "
          f"{lm['seconds']:.1f} s", flush=True)
    print(f"dcgan example gate {DCGAN_EXAMPLE}: fake mean "
          f"{dc['fake_mean']:.4f} vs real {dc['real_mean']:.4f} (gate "
          f"{DCGAN_MEAN_GATE}), std {dc['fake_std']:.4f} vs "
          f"{dc['real_std']:.4f} (gate {DCGAN_STD_GATE}), "
          f"{dc['seconds']:.1f} s", flush=True)
    check(lm["ppl"] < LM_EXAMPLE_GATE, f"the LM example's perplexity "
          f"{lm['ppl']} >= {LM_EXAMPLE_GATE}")
    check(abs(dc["fake_mean"] - dc["real_mean"]) < DCGAN_MEAN_GATE
          and abs(dc["fake_std"] - dc["real_std"]) < DCGAN_STD_GATE,
          f"the DCGAN example's moments: {dc}")
    return res


def _opt_net(seed: int = 3):
    net = gluon.nn.HybridSequential(prefix="optnet_")
    with net.name_scope():
        net.add(gluon.nn.Dense(256, activation="tanh", in_units=128))
        net.add(gluon.nn.Dense(10, in_units=256))
    mx.random.seed(seed)
    net.initialize(ctx=mx.gpu(0))
    return net


def phase_optimizers(steps: int = 3) -> dict:
    """Each of the thirteen optimizers (and RMSProp centered) on the
    card: (a) ``update_multi`` over a small net's parameters against
    ``update`` per parameter, ``steps`` updates from the same state,
    within ``OPT_MULTI_RTOL``; (b) ``ShardedTrainer``'s fused step (a
    CUDA graph, device ``lr``/``t``) against its eager step, ``steps``
    steps, losses and weights within ``OPT_FUSED_RTOL`` (SGLD: both
    with the generator seeded alike, by ``mx.random.seed`` before each
    makes its state)."""
    from incubator_mxnet_tpu_torch import optimizer as opt_mod
    t0 = time.perf_counter()
    rng = onp.random.RandomState(8)
    batches = [(rng.randn(64, 128).astype("float32"),
                rng.randint(0, 10, 64).astype("float32"))
               for _ in range(steps)]
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    res = {}
    cuda_ops.reset_launches()
    for name, kw in OPT_CASES:
        tag = name + ("_centered" if kw.get("centered") else "")
        # (a) update_multi against update
        ws = [p.data()._data for p in _opt_net().collect_params().values()]
        a = [w.clone() for w in ws]
        b = [w.clone() for w in ws]
        oa, ob = opt_mod.create(name, **kw), opt_mod.create(name, **kw)
        # SGLD seeds its generator from mx.random when it makes its state
        mx.random.seed(OPT_SGLD_SEED)
        sa = [oa.create_state_multi_precision(i, w) for i, w in enumerate(a)]
        mx.random.seed(OPT_SGLD_SEED)
        sb = [ob.create_state_multi_precision(i, w) for i, w in enumerate(b)]
        gen = torch.Generator(device="cuda").manual_seed(4)
        for _ in range(steps):
            gs = [torch.randn(w.shape, device="cuda", generator=gen)
                  for w in ws]
            oa.update_multi(list(range(len(a))), a, gs, sa)
            for i in range(len(b)):
                sb[i] = ob.update(i, b[i], gs[i], sb[i])
        multi = max(float((x - y).detach().abs().max())
                    / max(float(y.detach().abs().max()), 1e-30)
                    for x, y in zip(a, b))
        # (b) the fused step against the eager one
        trainers = []
        for fused in (True, False):
            net = _opt_net()
            trainers.append(parallel.ShardedTrainer(
                net, lambda o, lab: ce(o, lab), name, dict(kw),
                device="cuda", fused=fused))
        lf, le = [], []
        for k, (x, y) in enumerate(batches + batches):
            for tr, out in zip(trainers, (lf, le)):
                if k == 0:   # the first step makes SGLD's state
                    mx.random.seed(OPT_SGLD_SEED)
                out.append(float(tr.step(x, y)))
        fw = dict(trainers[0]._block.named_parameters())
        ew = dict(trainers[1]._block.named_parameters())
        fused_err = max(float((fw[n] - ew[n]).detach().abs().max())
                        / max(float(ew[n].detach().abs().max()), 1e-30)
                        for n in ew)
        loss_err = max(abs(p - q) / max(abs(q), 1.0)
                       for p, q in zip(lf, le))
        res[tag] = {"multi_vs_update": multi, "fused_vs_eager": fused_err,
                    "loss_err": loss_err, "captures":
                        trainers[0].captures,
                    "last_path": trainers[0].last_path}
        check(multi <= OPT_MULTI_RTOL, f"{tag}: update_multi differs from "
              f"update by {multi}")
        check(fused_err <= OPT_FUSED_RTOL and loss_err <= OPT_FUSED_RTOL,
              f"{tag}: the fused step differs from the eager one: weights "
              f"{fused_err}, losses {loss_err}")
        check(trainers[0].captures == 1
              and trainers[0].last_step_graphs == 1,
              f"{tag}: the fused step did not replay one graph")
    launches = cuda_ops.launch_counts()
    check(not any(launches.values()), f"the optimizers launched attention "
          f"kernels: {launches}")
    secs = time.perf_counter() - t0
    print(f"optimizers on the card ({len(res)} cases, {steps} updates, "
          f"fused and eager {2 * steps} steps each): worst update_multi vs "
          f"update {max(r['multi_vs_update'] for r in res.values()):.2e} "
          f"(tol {OPT_MULTI_RTOL}), worst fused vs eager "
          f"{max(r['fused_vs_eager'] for r in res.values()):.2e} (tol "
          f"{OPT_FUSED_RTOL}); " + ", ".join(
              f"{k} {r['multi_vs_update']:.1e}/{r['fused_vs_eager']:.1e}"
              for k, r in res.items()) + f"; {secs:.1f} s", flush=True)
    return {"cases": res, "launches": launches, "seconds": secs}


def phase_gluon_rest() -> dict:
    """Phases 21-23: the LM, the two example gates, the optimizers."""
    t0 = time.perf_counter()
    res = {"lm": phase_lm(), "examples": lm_example_gates(),
           "optimizers": phase_optimizers()}
    res["seconds"] = time.perf_counter() - t0
    print(f"gluon rest: {res['seconds']:.1f} s", flush=True)
    return res


# -- 24. fault ---------------------------------------------------------------

#: the slice's entry point at the bench's configuration
FAULT_ARGS = ["--model", "bert_12_768_12", "--seq-len", str(TRAIN_SHAPE[1]),
              "--batch-size", str(TRAIN_SHAPE[0]), "--seed", "0"]
FAULT_STEPS = 8         # run U's steps
FAULT_SAVE_AT = 4       # the step every run saves after
FAULT_CRASH_AT = 6      # run K dies saving after this step
FAULT_TIMED = 10        # steps per timed turn in (c)
FAULT_TURNS = 2
#: the stacked encoder at BERT-base widths, float32
ENC_CFG = dict(num_layers=12, units=768, hidden_size=3072, num_heads=12)
ENC_RTOL = 1e-4         # card vs CPU, relative to the largest output
ENC_CPU_ROWS = 2        # rows of the batch the CPU forward computes


def _fault_build(**trainer_kw):
    """The slice's entry point, ``bert_pretraining.build``, at the bench's
    configuration: ``(trainer, batch placed on the card)``."""
    args = bert_pretraining.parse_args(FAULT_ARGS)
    _, tr, batch = bert_pretraining.build(args, device="cuda", **trainer_kw)
    return tr, tr.place(*batch)


def _state_of(tr) -> list:
    """Device copies of every parameter and optimizer state."""
    return [t.detach().clone() for t in list(tr._params)
            + tr._state_tensors()]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def fault_kill_resume(root: str) -> dict:
    """(a) Run U: ``FAULT_STEPS`` steps, saving after ``FAULT_SAVE_AT``
    (timed, with its bytes). Run K: saves after ``FAULT_SAVE_AT``, dies by
    ``ChaosCrash`` at ``checkpoint.arrays`` while saving after
    ``FAULT_CRASH_AT``. A new model and trainer R restore (timed) and run
    the remaining steps: losses, parameters and optimizer states bitwise
    equal to U's, 12 launches per kernel per step, the fused path."""
    u, placed = _fault_build()
    ref, save = [], {}
    for t in range(1, FAULT_STEPS + 1):
        ref.append(float(u.step(*placed)))
        if t == FAULT_SAVE_AT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = u.save_checkpoint(os.path.join(root, "u"), keep=2)
            save["save_s"] = time.perf_counter() - t0
            save["bytes"] = sum(os.path.getsize(os.path.join(path, f))
                                for f in os.listdir(path))
    want = _state_of(u)
    del u
    gc.collect()
    k, placed = _fault_build()
    kroot = os.path.join(root, "k")
    for t in range(1, FAULT_CRASH_AT + 1):
        k.step(*placed)
        if t == FAULT_SAVE_AT:
            k.save_checkpoint(kroot, keep=2)
    crashed = False
    with inject.chaos(seed=0, crash_sites=["checkpoint.arrays"]):
        try:
            k.save_checkpoint(kroot, keep=2)
        except inject.ChaosCrash:
            crashed = True
    check(crashed, "run K's save did not die at checkpoint.arrays")
    listed = fault.list_checkpoints(kroot)
    check(listed == [FAULT_SAVE_AT], f"after the crash {kroot} lists "
          f"{listed}, not [{FAULT_SAVE_AT}]")
    fault.load_checkpoint(kroot, FAULT_SAVE_AT)       # verifies the CRCs
    del k
    gc.collect()
    r, placed = _fault_build()
    r.step(*placed)          # set-up, as the entry point's first step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # Gluon prefixes count up
        restored = r.restore_checkpoint(kroot)
    torch.cuda.synchronize()
    save["restore_s"] = time.perf_counter() - t0
    check(restored == r.num_update == FAULT_SAVE_AT,
          f"restored step {restored}, num_update {r.num_update}")
    cuda_ops.reset_launches()
    got = [float(r.step(*placed))
           for _ in range(FAULT_SAVE_AT, FAULT_STEPS)]
    launches = cuda_ops.launch_counts()
    n = FAULT_STEPS - FAULT_SAVE_AT
    per_step = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    same_state = _same(_state_of(r), want)
    print(f"fault (a): run U losses {[round(x, 6) for x in ref]}; resumed "
          f"steps {FAULT_SAVE_AT + 1}-{FAULT_STEPS} {got}: losses "
          f"{'bitwise equal' if got == ref[FAULT_SAVE_AT:] else 'DIFFER'}, "
          f"parameters and states {'bitwise equal' if same_state else 'DIFFER'}"
          f"; launches {launches} over {n} steps, path {r.last_path}, "
          f"captures {r.captures}; save {save['save_s']:.3f} s for "
          f"{save['bytes']} bytes, restore {save['restore_s']:.3f} s",
          flush=True)
    check(got == ref[FAULT_SAVE_AT:], f"resumed losses {got} differ from "
          f"the uninterrupted run's {ref[FAULT_SAVE_AT:]}")
    check(same_state, "resumed parameters or optimizer states differ from "
          "the uninterrupted run's")
    for name, c in launches.items():
        check(c == per_step * n, f"fault: {name} launched {c} times in {n} "
              f"resumed steps of {per_step} attention calls")
    check(r.last_path == "fused" and r.last_step_graphs == 1,
          f"the resumed trainer's last step: {r.last_path}, "
          f"{r.last_step_graphs} graphs")
    return dict(save, losses=ref, resumed_losses=got, launches=launches,
                captures=r.captures, last_path=r.last_path)


def fault_guard() -> dict:
    """(b) ``StepGuard("skip_and_rollback")`` on the fused step: a step on
    a batch whose MLM weights are NaN (the loss and every gradient NaN)
    trips it and is rolled back bitwise, without a new capture; the next
    clean step equals a clean run's bitwise. ``nan_batch`` through the
    chaos hook (it poisons ``valid_length``, BERT's only float data
    argument) is reported; ``halt`` raises ``NonFiniteError``."""
    guard = fault.StepGuard("skip_and_rollback")
    g, placed = _fault_build(guard=guard)
    c, _ = _fault_build()
    bad = list(placed)
    bad[5] = torch.full_like(placed[5], float("nan"))    # mlm_weights
    for tr in (g, c):
        tr.step(*placed)
        tr.step(*placed)
    before, t_before, captures = _state_of(g), g.num_update, g.captures
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.step(*bad)
    rolled = _same(_state_of(g), before) and g.num_update == t_before
    lg, lc = float(g.step(*placed)), float(c.step(*placed))
    same_next = lg == lc and _same(_state_of(g), _state_of(c))
    with inject.chaos(seed=0, nan_prob=1.0) as monkey, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.step(*placed)
    nan_batch_tripped = guard.tripped > 1
    g._guard = fault.StepGuard("halt")
    try:
        g.step(*bad)
        halted = False
    except fault.NonFiniteError:
        halted = True
    res = {"tripped": guard.tripped, "skipped": guard.skipped,
           "history": [list(h) for h in guard.history],
           "rolled_back_bitwise": rolled, "next_step_bitwise": same_next,
           "captures": g.captures, "halt_raised": halted,
           "nan_batch_fired": monkey.log[0] == ("nan_batch", True),
           "nan_batch_tripped": nan_batch_tripped}
    print(f"fault (b): guard {res}", flush=True)
    check(guard.skipped == 1 and rolled, "the poisoned step was not "
          "rolled back bitwise")
    check(same_next, f"the step after the rollback ({lg}) differs from a "
          f"clean run's ({lc})")
    check(g.captures == captures == 1, f"captures {captures} -> "
          f"{g.captures}: the rollback recaptured the fused step")
    check(halted, "StepGuard('halt') did not raise NonFiniteError")
    return res


def fault_costs() -> dict:
    """(c) The fused step's ms (host clock around ``FAULT_TIMED``
    synchronised steps, in turns) unguarded, guarded with a snapshot every
    step and every 100 steps, and under an adaptive ``Watchdog``."""
    tr, placed = _fault_build()
    for _ in range(2):                       # eager run, capture
        tr.step(*placed)
    configs = (("unguarded", lambda: (None, None)),
               ("guard_snapshot_every_1",
                lambda: (fault.StepGuard("skip_and_rollback"), None)),
               ("guard_snapshot_every_100",
                lambda: (fault.StepGuard("skip_and_rollback",
                                         snapshot_every=100), None)),
               ("watchdog", lambda: (None, fault.Watchdog())))
    runs = {name: [] for name, _ in configs}
    for _ in range(FAULT_TURNS):
        for name, make in configs:
            tr._guard, tr._watchdog = make()
            runs[name].append(synced_ms(lambda: tr.step(*placed),
                                        FAULT_TIMED)[0])
    res = {name: {"runs_ms": ms, "ms": min(ms)} for name, ms in runs.items()}
    # one profiled step of each: where a snapshot's time goes (the
    # multi-tensor copies on the device, the host's launches after the
    # guard's read, when the device waits)
    for name, guard in (("unguarded", None), ("guard_snapshot_every_1",
                        fault.StepGuard("skip_and_rollback"))):
        tr._guard = guard
        tr.step(*placed)
        wall, per_kernel = device_split(lambda: tr.step(*placed))
        busy = sum(per_kernel.values())
        copies = sum(t for k, t in per_kernel.items() if "CopyFunctor" in k)
        res[name]["profile"] = {"wall_ms": wall, "device_ms": busy,
                                "idle_share": max(0.0, 1 - busy / wall),
                                "snapshot_copy_ms": copies}
    tr._guard = tr._watchdog = None
    res["captures"] = tr.captures
    card = card_line()
    print("fault (c): fused step ms " + ", ".join(
        f"{k} {v['ms']:.3f} (runs {[round(x, 3) for x in v['runs_ms']]})"
        for k, v in res.items() if k != "captures") + f" on {card}",
        flush=True)
    for name in ("unguarded", "guard_snapshot_every_1"):
        prof = res[name]["profile"]
        print(f"fault (c): one profiled {name} step: wall "
              f"{prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms"
              f", idle {prof['idle_share']:.1%}, multi-tensor copies "
              f"{prof['snapshot_copy_ms']:.3f} ms", flush=True)
    check(tr.captures == 1, f"the timed trainer captured {tr.captures} "
          "graphs")
    return res


def fault_encoder() -> dict:
    """(d) ``StackedTransformerEncoder`` at BERT-base widths, float32,
    batch ``TRAIN_SHAPE``: the card's forward against the CPU's on the
    first ``ENC_CPU_ROWS`` rows (rows are independent) within ``ENC_RTOL``
    of the largest output, and one ``ShardedTrainer`` step with a finite
    loss."""
    B, L = TRAIN_SHAPE
    nets = []
    for dev in ("cuda", "cpu"):
        net = models.StackedTransformerEncoder(**ENC_CFG)
        net.initialize(ctx=mx.Context.from_device(torch.device(dev)))
        nets.append(net)
    for name, p in nets[0]._reg_params.items():     # the same weights
        nets[1]._reg_params[name].set_data(p.data()._data.cpu())
    x = torch.from_numpy(onp.random.RandomState(0).randn(
        B, L, ENC_CFG["units"]).astype("float32"))
    with torch.no_grad():
        t0 = time.perf_counter()
        out = nets[0](x.cuda())
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        ref = nets[1](x[:ENC_CPU_ROWS])
    err = ((out[:ENC_CPU_ROWS].cpu() - ref).abs().max()
           / ref.abs().max()).item()
    tr = parallel.ShardedTrainer(nets[0],
                                 lambda o, y: ((o - y) ** 2).mean(-1),
                                 "adamw", {"learning_rate": 1e-4},
                                 device="cuda")
    loss = float(tr.step(x.cuda(), torch.zeros_like(x).cuda()))
    print(f"fault (d): stacked encoder {ENC_CFG}, batch {B} x {L}: card vs "
          f"CPU rel err {err:.2e} (first forward {card_ms:.1f} ms), one "
          f"{tr.last_path} ShardedTrainer step loss {loss:.6f}", flush=True)
    check(err <= ENC_RTOL, f"stacked encoder: card vs CPU {err:.2e} > "
          f"{ENC_RTOL}")
    check(onp.isfinite(loss), f"stacked encoder step loss {loss}")
    return {"rel_err": err, "first_forward_ms": card_ms, "loss": loss}


def phase_fault() -> dict:
    """24. fault (the module docstring): (a) and (b) under
    ``torch.use_deterministic_algorithms``, in a temporary directory
    removed at the end; then (c) and (d)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = {"card": card_line()}
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as root:
            res["resume"] = fault_kill_resume(root)
        gc.collect()
        res["guard"] = fault_guard()
    finally:
        torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()
    res["costs"] = fault_costs()
    gc.collect()
    res["encoder"] = fault_encoder()
    res["launches"] = res["resume"]["launches"]
    res["seconds"] = time.perf_counter() - t0
    print(f"fault: phase {res['seconds']:.1f} s on {res['card']}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res



# ---------------------------------------------------------------------------
# 25. data: a .rec file through gluon.data into the fused ResNet-50 step, a
# length-bucketed loader into the fused BERT-base step, and their resume
# ---------------------------------------------------------------------------

# (a)-(b): ImageNet-shaped records, the training crop of the bench's
# resnet workload
DATA_IMAGES, DATA_SIDE, DATA_CLASSES = 2048, 256, 1000
DATA_CROP, DATA_BATCH = 224, 32
DATA_MEAN, DATA_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
DATA_STEPS = 24          # (a): eager, capture, replays; then the timed
DATA_TIMED = 8           # (a): replays timed fed by the pipeline, and not
DATA_PROFILED = 6        # (a): steps fed by the pipeline under the profiler
DATA_RATE_BATCHES = 16   # (d): batches timed per pipeline configuration
DATA_GATE_STEPS = 8      # (b): steps of each run
# (c): bench.py's default workload at batch 8 over three buckets
TEXT_SEQS, TEXT_KEYS, TEXT_BATCH, TEXT_LOW = 4096, (128, 256, 512), 8, 64
TEXT_STEPS, TEXT_SAVE_AT, TEXT_TIMED = 12, 6, 36
TEXT_SEED = 7            # numpy's stream before each pass's order is drawn
JPEG_IMAGES, JPEG_SHORT = 512, 256   # (e)


def _data_record(raw: bytes) -> tuple:
    """One record of the phase's pack: ``(HWC uint8 image, label)``."""
    header, payload = recordio.unpack(raw)
    img = onp.frombuffer(payload, onp.uint8).reshape(DATA_SIDE, DATA_SIDE, 3)
    return img, onp.float32(header.label)


def data_pack(root: str) -> str:
    """``DATA_IMAGES`` seeded 256x256x3 uint8 images, raw pixels, labels
    from 1,000 classes, through ``recordio.MXIndexedRecordIO`` and
    ``pack``; returns the ``.rec`` path."""
    rec = os.path.join(root, "images.rec")
    w = recordio.MXIndexedRecordIO(os.path.join(root, "images.idx"), rec, "w")
    rng = onp.random.RandomState(0)
    labels = rng.randint(0, DATA_CLASSES, DATA_IMAGES)
    for i in range(DATA_IMAGES):
        img = rng.randint(0, 256, (DATA_SIDE, DATA_SIDE, 3), dtype=onp.uint8)
        w.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(labels[i]), i, 0), img.tobytes()))
    w.close()
    return rec


def data_loader(rec: str, train: bool, workers: int, prefetch=None,
                pin: bool = True, shuffle: bool = True):
    """``RecordFileDataset`` -> records -> the training transforms
    (``train``: random resized crop and flip; else the center crop) ->
    ``DataLoader`` of full batches."""
    T = gluon.data.vision.transforms
    aug = [T.RandomResizedCrop(DATA_CROP), T.RandomFlipLeftRight()] if train \
        else [T.CenterCrop(DATA_CROP)]
    ds = gluon.data.RecordFileDataset(rec).transform(_data_record)
    ds = ds.transform_first(T.Compose(
        aug + [T.ToTensor(), T.Normalize(DATA_MEAN, DATA_STD)]))
    return gluon.data.DataLoader(
        ds, batch_size=DATA_BATCH, shuffle=shuffle, num_workers=workers,
        last_batch="discard", pin_memory=pin, prefetch=prefetch, timeout=60)


def _vision_place(tr):
    """``trainer.place`` and the cast of the images to the net's
    bfloat16 (on the iterator's stream when it runs there)."""
    def place(b):
        x, y = tr.place(*b)
        return x.to(torch.bfloat16), y
    return place


def data_pipeline_rates(rec: str, worker_counts, prefetch) -> dict:
    """(d) The pipeline alone (decode, augment, batch, transport; host
    batches) in images/s for each worker count, shared memory on and
    off, in its steady state: ``prefetch + 1`` batches first (those the
    workers build at once while the first is awaited), then
    ``DATA_RATE_BATCHES`` timed."""
    res = {}
    with mx.cpu():
        for w in worker_counts:
            for shm in (("1", "0") if w else ("1",)):
                with mock.patch.dict(os.environ,
                                     {"MXTPU_DATALOADER_SHM": shm}):
                    loader = data_loader(rec, True, w, prefetch, pin=False)
                    onp.random.seed(0)
                    it = iter(loader)
                    for _ in range(prefetch + 1):
                        next(it)
                    t0 = time.perf_counter()
                    for _ in range(DATA_RATE_BATCHES):
                        next(it)
                    dt = time.perf_counter() - t0
                    del it
                    loader.close()
                key = f"workers_{w}" + ("" if not w else
                                        "_shm" if shm == "1" else "_pipe")
                res[key] = DATA_BATCH * DATA_RATE_BATCHES / dt
                print(f"data (d): pipeline alone, {key}: {res[key]:.1f} "
                      f"images/s", flush=True)
    return res


def data_h2d() -> dict:
    """(d) One float32 ResNet-50 batch host to device: pageable and
    pinned (CUDA events)."""
    x = onp.random.RandomState(0).rand(DATA_BATCH, 3, DATA_CROP,
                                       DATA_CROP).astype("float32")
    t = torch.from_numpy(x)
    pinned = t.pin_memory()
    res = {"bytes": x.nbytes,
           "pageable_ms": cuda_ms(lambda: t.to("cuda"), 100.0),
           "pinned_ms": cuda_ms(lambda: pinned.to("cuda", non_blocking=True),
                                100.0)}
    print(f"data (d): H2D of one batch ({x.nbytes} bytes): pageable "
          f"{res['pageable_ms']:.3f} ms, pinned {res['pinned_ms']:.3f} ms",
          flush=True)
    return res


def data_vision(rec: str, workers: int, prefetch: int, pids: list) -> dict:
    """(a) The vision path: the training pipeline through
    ``PrefetchIter(place=trainer.place)`` into the fused ResNet-50 step
    (the bench's ``resnet`` trainer); (d) its step fed through the
    pipeline against fed one batch already placed, the consumer's wait
    per batch, and the device's idle share over a profiled stretch."""
    tr, _, info = bench.build_resnet("cuda")
    loader = data_loader(rec, True, workers, prefetch)
    pids += [p.pid for p in loader._procs]
    onp.random.seed(0)
    it = mx.io.PrefetchIter(loader, place=_vision_place(tr))
    losses, waits = [], []

    def fed_step():
        t0 = time.perf_counter()
        batch = next(it)
        waits.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.step(*batch))
        return batch

    for _ in range(DATA_STEPS - DATA_TIMED):
        fed_step()
    # the steady state: the step waits on the pipeline, nothing queued
    fed_ms, _ = synced_ms(fed_step, DATA_TIMED)
    wall, per_kernel = device_split(
        lambda: [fed_step() for _ in range(DATA_PROFILED)])
    busy = sum(per_kernel.values())
    batch = fed_step()
    placed_ms, _ = synced_ms(lambda: tr.step(*batch), DATA_TIMED)
    alive = all(p.exitcode is None for p in loader._procs)
    it.close()
    loader.close()
    losses = [float(x) for x in losses]
    steady = sorted(waits[2:])
    res = {"losses": losses, "captures": tr.captures,
           "last_path": tr.last_path, "workers": workers,
           "prefetch": prefetch, "step_ms_fed": fed_ms,
           "step_ms_placed": placed_ms,
           "wait_ms_p50": steady[len(steady) // 2],
           "wait_ms_p95": steady[min(len(steady) - 1,
                                     int(0.95 * len(steady)))],
           "profile_wall_ms": wall, "profile_device_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall),
           "workers_alive": alive}
    print(f"data (a): resnet50_v1 bf16 fused from the .rec pipeline "
          f"({workers} workers, prefetch {prefetch}): losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {tr.captures} capture(s), "
          f"path {tr.last_path}; step {fed_ms:.3f} ms fed by the pipeline "
          f"= {DATA_BATCH / fed_ms * 1e3:.1f} imgs/s against {placed_ms:.3f} "
          f"ms on a placed batch; consumer wait p50 "
          f"{res['wait_ms_p50']:.3f} ms, p95 {res['wait_ms_p95']:.3f} ms; "
          f"{DATA_PROFILED} profiled steps: wall {wall:.3f} ms, device "
          f"{busy:.3f} ms, idle {res['idle_share']:.1%} on {card_line()}", flush=True)
    check(all(onp.isfinite(losses)), f"data (a): non-finite loss {losses}")
    check(tr.last_path == "fused" and tr.captures == 1,
          f"data (a): path {tr.last_path}, {tr.captures} captures")
    check(alive, "data (a): a DataLoader worker died")
    return res


def data_overlap_gate(rec: str, workers: int, prefetch: int,
                      pids: list) -> dict:
    """(b) The deterministic pipeline (center crop) twice, under
    ``torch.use_deterministic_algorithms``: run P places through
    ``PrefetchIter`` while the fused step runs, run S places on the main
    thread. Every batch the step received (its static input buffers after
    each ``load``, copied on the device and read after the loop) and every
    loss: bitwise equal."""
    runs = {}
    for mode in ("prefetch", "sync"):
        tr, _, _ = bench.build_resnet("cuda")
        loader = data_loader(rec, False, workers, prefetch)
        pids += [p.pid for p in loader._procs]
        place = _vision_place(tr)
        onp.random.seed(1)
        if mode == "prefetch":
            it = mx.io.PrefetchIter(loader, place=place)
        else:
            it = iter(loader)
        losses, seen = [], []
        for _ in range(DATA_GATE_STEPS):
            b = next(it)
            losses.append(tr.step(*(b if mode == "prefetch" else place(b))))
            entry = next(iter(tr._steps.values()))
            seen.append([t.clone() for t in entry.inputs])
        torch.cuda.synchronize()
        if mode == "prefetch":
            it.close()
        else:
            del it
        loader.close()
        runs[mode] = ([float(x) for x in losses], seen, tr.captures)
        del tr
        gc.collect()
    (lp, sp, cp), (ls, ss, cs) = runs["prefetch"], runs["sync"]
    same_batches = all(torch.equal(a, b) for xa, xb in zip(sp, ss)
                       for a, b in zip(xa, xb))
    res = {"losses_prefetch": lp, "losses_sync": ls,
           "batches_bitwise": same_batches, "losses_bitwise": lp == ls,
           "captures": [cp, cs]}
    print(f"data (b): {DATA_GATE_STEPS} steps placed under overlap vs on "
          f"the main thread: batches "
          f"{'bitwise equal' if same_batches else 'DIFFER'}, losses "
          f"{'bitwise equal' if lp == ls else 'DIFFER'} ({lp[-1]:.6f})",
          flush=True)
    check(same_batches, "data (b): a batch the step received under "
          "overlap differs from the synchronously placed one")
    check(lp == ls, f"data (b): losses differ: {lp} vs {ls}")
    return res


def text_loader(workers: int = 2):
    """The bucketed corpus (``bucket_lengths``: lengths 64-512, each
    bucket a whole number of batches) through ``FixedBucketSampler``
    (shuffled) and a ``DataLoader`` padding each batch to its bucket."""
    lengths = bert_pretraining.bucket_lengths(TEXT_SEQS, TEXT_KEYS,
                                              TEXT_BATCH, TEXT_LOW, seed=0)
    corpus = bert_pretraining.SyntheticCorpus(lengths, bench.VOCAB,
                                              TEXT_KEYS[-1], seed=1)
    sampler = gluon.data.FixedBucketSampler(
        lengths, TEXT_BATCH, bucket_keys=list(TEXT_KEYS), shuffle=True)
    loader = gluon.data.DataLoader(
        corpus, batch_sampler=sampler,
        batchify_fn=bert_pretraining.BucketBatchify(TEXT_KEYS),
        num_workers=workers, pin_memory=True, timeout=60)
    return loader, corpus


def _text_run(steps: int, pids: list, root=None, save_at=None,
              restore=False, timed: int = 0) -> dict:
    """One BERT-base run fed by the bucketed loader through
    ``PrefetchIter``: every step's loss, bucket, captures after it and
    batch (device copies of the first ``steps``), CUDA-event ms per step
    of ``timed`` more steps. ``save_at``: save after that step with
    ``data_state``; ``restore``: a set-up step, ``restore_checkpoint`` and
    ``restore_shard`` first."""
    tr, _, _ = bench.build("cuda")
    loader, corpus = text_loader()
    pids += [p.pid for p in loader._procs]
    first = 0
    if restore:
        setup = bert_pretraining.BucketBatchify(TEXT_KEYS)(
            [corpus[i] for i in range(TEXT_BATCH)])
        tr.step(*tr.place(*setup))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # Gluon prefixes count up
            first = tr.restore_checkpoint(root)
    onp.random.seed(TEXT_SEED)
    it = mx.io.PrefetchIter(loader, place=lambda b: tr.place(*b))
    if restore:
        onp.random.seed(TEXT_SEED)
        it.restore_shard(tr.last_restore_meta["data_state"])
    cuda_ops.reset_launches()
    out = {"losses": [], "keys": [], "captures": [], "batches": [],
           "step_ms": []}
    for t in range(first + 1, steps + timed + 1):
        batch = next(it)
        if t > steps:
            if t == steps + 1:
                torch.use_deterministic_algorithms(False)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        out["losses"].append(tr.step(*batch))
        out["keys"].append(int(batch[0].shape[1]))
        out["captures"].append(tr.captures)
        if t > steps:
            e1.record()
            out["step_ms"].append((e0, e1))
        else:
            out["batches"].append([b.clone() for b in batch])
        if t == save_at:
            torch.cuda.synchronize()
            tr.save_checkpoint(root, keep=1, data_state=it.shard_state())
            break
    torch.cuda.synchronize()
    out["launches"] = cuda_ops.launch_counts()
    out["losses"] = [float(x) for x in out["losses"]]
    out["step_ms"] = [a.elapsed_time(b) for a, b in out["step_ms"]]
    out["last_path"] = tr.last_path
    it.close()
    loader.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def data_text(root: str, pids: list) -> dict:
    """(c) Run U: ``TEXT_STEPS`` steps under deterministic algorithms, then
    ``TEXT_TIMED`` timed ones (step ms per bucket): 3 captures, each at
    its bucket's second step (the first runs eagerly), none after; 12
    launches per kernel per step. Run K saves at ``TEXT_SAVE_AT`` with
    ``data_state``; a new loader, iterator, model and trainer restore and
    run the remaining steps: losses and batches bitwise equal to U's, no
    sample replayed or dropped."""
    torch.use_deterministic_algorithms(True)
    try:
        u = _text_run(TEXT_STEPS, pids, timed=TEXT_TIMED)
        torch.use_deterministic_algorithms(True)
        k = _text_run(TEXT_STEPS, pids, root=root, save_at=TEXT_SAVE_AT)
        r = _text_run(TEXT_STEPS, pids, root=root, restore=True)
    finally:
        torch.use_deterministic_algorithms(False)
    n = len(u["losses"])
    per_step = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    seen, capture_at = {}, []
    prev = 0
    for key, cap in zip(u["keys"], u["captures"]):
        seen[key] = seen.get(key, 0) + 1
        if cap != prev:
            capture_at.append((key, seen[key]))
        prev = cap
    by_bucket = {}
    for key, ms in zip(u["keys"][TEXT_STEPS:], u["step_ms"]):
        by_bucket.setdefault(key, []).append(ms)
    step_ms = {k: statistics.median(v) for k, v in sorted(by_bucket.items())}
    same_losses = r["losses"] == u["losses"][TEXT_SAVE_AT:TEXT_STEPS]
    same_batches = len(r["batches"]) == TEXT_STEPS - TEXT_SAVE_AT and all(
        torch.equal(a, b) for xa, xb in zip(r["batches"],
                                            u["batches"][TEXT_SAVE_AT:])
        for a, b in zip(xa, xb))
    ids = [tuple(b[0][row].tolist()) for b in k["batches"] + r["batches"]
           for row in range(TEXT_BATCH)]
    res = {"losses": u["losses"], "keys": u["keys"],
           "captures": u["captures"][-1], "capture_at": capture_at,
           "launches": u["launches"], "step_ms_by_bucket": step_ms,
           "resumed_losses": r["losses"], "losses_bitwise": same_losses,
           "batches_bitwise": same_batches,
           "samples_distinct": len(set(ids)) == len(ids)}
    print(f"data (c): BERT-base bf16 from the bucketed loader, {n} steps, "
          f"buckets {dict(collections.Counter(u['keys']))}: captures "
          f"{u['captures'][-1]} at (bucket, its step) {capture_at}; "
          f"launches {u['launches']}; step ms by bucket (CUDA events, "
          f"median) {({k: round(v, 3) for k, v in step_ms.items()})}; "
          f"resumed steps {TEXT_SAVE_AT + 1}-{TEXT_STEPS} losses "
          f"{'bitwise equal' if same_losses else 'DIFFER'}, batches "
          f"{'bitwise equal' if same_batches else 'DIFFER'}, "
          f"{len(ids)} samples distinct {res['samples_distinct']} on "
          f"{card_line()}", flush=True)
    check(all(onp.isfinite(u["losses"])), "data (c): non-finite loss")
    check(u["captures"][-1] == len(TEXT_KEYS) and set(seen) == set(TEXT_KEYS)
          and all(c == 2 for _, c in capture_at),
          f"data (c): captures {u['captures'][-1]} at {capture_at}, "
          f"buckets seen {seen}")
    for name, c in u["launches"].items():
        check(c == per_step * n, f"data (c): {name} launched {c} times in "
              f"{n} steps of {per_step} attention calls")
    check(u["last_path"] == "fused", f"data (c): path {u['last_path']}")
    check(same_losses, f"data (c): resumed losses {r['losses']} differ "
          f"from the uninterrupted run's")
    check(same_batches, "data (c): resumed batches differ")
    check(res["samples_distinct"], "data (c): a sample was replayed")
    return res


def data_jpeg(root: str, threads: int) -> dict:
    """(e) ``JPEG_IMAGES`` JPEGs packed by the port's ``im2rec`` (short
    side 256), read by ``ImageRecordIter`` with random crop and mirror,
    mean and std on ``threads`` threads: images/s. Needs ``cv2``."""
    try:
        import cv2
    except ImportError as e:
        print(f"data (e): not run: cv2 does not import ({e})", flush=True)
        return {"ran": False, "reason": str(e)}
    from incubator_mxnet_tpu_torch.tools import im2rec
    folder = os.path.join(root, "jpeg")
    rng = onp.random.RandomState(3)
    yy, xx = onp.mgrid[0:300, 0:400]
    for i in range(JPEG_IMAGES):
        d = os.path.join(folder, f"class{i % 8}")
        os.makedirs(d, exist_ok=True)
        base = ((yy * (i % 7 + 1) + xx * (i % 5 + 1)) % 256)[..., None]
        img = onp.clip(base + rng.randint(0, 40, (300, 400, 3)), 0,
                       255).astype(onp.uint8)
        cv2.imwrite(os.path.join(d, f"{i}.jpg"), img)
    prefix = os.path.join(root, "jpeg_pack")
    t0 = time.perf_counter()
    im2rec.main(["--list", prefix, folder])
    im2rec.main([prefix, folder, "--resize", str(JPEG_SHORT)])
    pack_s = time.perf_counter() - t0
    it = mx.io.ImageRecordIter(
        path_imgrec=prefix + ".rec", data_shape=(3, DATA_CROP, DATA_CROP),
        batch_size=DATA_BATCH, rand_crop=True, rand_mirror=True,
        mean_r=123.68, mean_g=116.78, mean_b=103.94, std_r=58.4,
        std_g=57.12, std_b=57.38, preprocess_threads=threads, shuffle=True)
    next(it)
    t0 = time.perf_counter()
    n = 0
    for b in it:
        n += b.data[0].shape[0]
    torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t0)
    print(f"data (e): cv2 {cv2.__version__}: im2rec packed {JPEG_IMAGES} "
          f"JPEGs in {pack_s:.2f} s; ImageRecordIter ({threads} threads, "
          f"224 crops) {rate:.1f} images/s", flush=True)
    return {"ran": True, "cv2": cv2.__version__, "pack_s": pack_s,
            "images_per_s": rate, "threads": threads}


def phase_data() -> dict:
    """25. data (the module docstring): in a temporary directory removed
    at the end. Workers and prefetch are sized to the cores and to
    ``/dev/shm`` (half of its free bytes at most in flight)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    st = os.statvfs("/dev/shm")
    shm_free = st.f_frsize * st.f_bavail
    cores = os.cpu_count() or 2
    workers = max(1, min(6, cores - 2))
    batch_bytes = DATA_BATCH * 3 * DATA_CROP * DATA_CROP * 4
    prefetch = max(1, min(2 * workers, shm_free // 2 // batch_bytes))
    res = {"card": card_line(), "dev_shm_bytes": st.f_frsize * st.f_blocks,
           "dev_shm_free": shm_free, "cpu_count": cores,
           "workers": workers, "prefetch": prefetch}
    print(f"data: /dev/shm {res['dev_shm_bytes']} bytes ({shm_free} free), "
          f"{cores} cores: {workers} workers, prefetch {prefetch} batches "
          f"of {batch_bytes} bytes", flush=True)
    pids: list = []
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        rec = data_pack(root)
        res["pack_s"] = time.perf_counter() - t1
        res["rec_bytes"] = os.path.getsize(rec)
        print(f"data: packed {DATA_IMAGES} images, {res['rec_bytes']} "
              f"bytes, in {res['pack_s']:.2f} s", flush=True)
        res["pipeline"] = data_pipeline_rates(
            rec, sorted({0, min(4, cores), min(8, cores)}), prefetch)
        res["h2d"] = data_h2d()
        res["vision"] = data_vision(rec, workers, prefetch, pids)
        gc.collect()
        torch.use_deterministic_algorithms(True)
        try:
            res["overlap"] = data_overlap_gate(rec, workers, prefetch, pids)
        finally:
            torch.use_deterministic_algorithms(False)
        gc.collect()
        torch.cuda.empty_cache()
        res["text"] = data_text(os.path.join(root, "ckpt"), pids)
        res["jpeg"] = data_jpeg(root, workers)
    left = [p for pid in pids
            for p in glob.glob(f"/dev/shm/mxtpu_dl_{pid}_*")]
    res["segments_left"] = len(left)
    res["launches"] = res["text"]["launches"]
    res["seconds"] = time.perf_counter() - t0
    print(f"data: phase {res['seconds']:.1f} s, {len(left)} shared-memory "
          f"segments left on {res['card']}", flush=True)
    check(not left, f"data: segments left in /dev/shm: {left[:4]}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 26. serve tier: two replicas of BERT-base behind the router and the TCP
# server, a kill, a weight sync, shedding and generation over the wire
# ---------------------------------------------------------------------------
TIER_TABLE = {"batch": (1, 8), "seq": (8, 512)}    # 4 x 7 = 28 graphs each
TIER_STEADY = 32           # over the wire from 4 client threads, no kill
TIER_REQUESTS = 64         # over the wire from 4 client threads, r0 killed
TIER_KILL_AFTER = 16       # replies before r0 is killed
TIER_SAMPLES = 4           # wire replies held against the eager forward
TIER_BURST = 64            # concurrent short requests over the shed depth
TIER_BURST_LEN = 32
TIER_SHED_DEPTH = 1
#: the weight sync's perturbation, in standard deviations of each weight
TIER_WEIGHT_NOISE = 0.02
TIER_NMT_TABLE = {"batch": (1, 1), "src": (8, 128)}
TIER_NMT_PROMPTS = 4
TIER_NMT_NEW = 24
#: the decoder's per-tenant budget: 1 token/s refill, 32 tokens deep
TIER_NMT_BURST = 32


def _tier_bert():
    """BERT-base as every replica's loader builds it: seeded, so every
    build holds the same weights."""
    return models.get_bert("bert_12_768_12", vocab_size=30522,
                           max_length=512, use_decoder=False,
                           use_classifier=False, device="cuda")


def _tier_payload(req) -> dict:
    ids, tt, vl = req
    return {"model": "bert", "inputs": [ids.tolist(), tt.tolist(),
                                        float(vl)],
            "dtypes": ["int32", "int32", "float32"]}


def _tier_eager(ref, reqs) -> list:
    """Unbatched forwards of ``reqs`` on the plain attention path."""
    outs = []
    os.environ["MXTPU_ATTN_IMPL"] = "xla"
    try:
        with torch.inference_mode():
            for r in reqs:
                seq, pooled = ref(*(torch.from_numpy(onp.asarray(a)[None])
                                    .cuda() for a in r))
                outs.append((seq[0], pooled[0]))
    finally:
        del os.environ["MXTPU_ATTN_IMPL"]
    return outs


def _tier_err(got, want) -> float:
    """Largest error of a reply's or a future's (seq, pooled) rows."""
    return max(_max_err(onp.asarray(g, "float32"), w)
               for g, w in zip(got, want))


def _tier_steady(srv, reps, reqs) -> dict:
    """``reqs`` over TCP from 4 closed-loop client threads, nothing held
    or killed: the tier's steady req/s and latency. Each replica's
    ``predict`` (replay and copies, under its model lock) is timed
    meanwhile: the share of the window in which neither ran is a floor on
    the card's idle share, since the two share the card. Then the wire
    encoding of the window's replies (the server's ``tolist`` and
    ``json.dumps``, the client's ``json.loads``) is timed again on this
    thread, as a share of the window: the server and the clients do that
    work in this one process, under one interpreter lock."""
    n = len(reqs)
    replies, lat, errors, spans = [None] * n, [0.0] * n, [], []
    cms = [rep.registry.get("bert") for rep in reps]
    real = [cm.predict for cm in cms]

    def timed(fn):
        def predict(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spans.append((t0, time.perf_counter()))
        return predict

    def client(cid):
        try:
            for i in range(cid, n, 4):
                t0 = time.perf_counter()
                replies[i] = serve.client_call(
                    "127.0.0.1", srv.port, _tier_payload(reqs[i]),
                    timeout=300)
                lat[i] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    for cm, fn in zip(cms, real):
        cm.predict = timed(fn)
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
    finally:
        for cm, fn in zip(cms, real):
            cm.predict = fn
    check(not any(t.is_alive() for t in threads), "tier clients hung")
    check(not errors, f"tier client failed: {errors[:3]}")
    check(all(r is not None and r["ok"] for r in replies),
          f"a steady request over the wire failed: "
          f"{[r for r in replies if not (r and r['ok'])][:2]}")
    busy, end = 0.0, t0
    for a, b in sorted(spans):
        a = max(a, end)
        if b > a:
            busy, end = busy + b - a, b
    json_s, nbytes = 0.0, 0
    for r in replies:
        outs = [onp.asarray(o, "float32") for o in r["outputs"]]
        t1 = time.perf_counter()
        line = (json.dumps(dict(r, outputs=[o.tolist() for o in outs]))
                + "\n").encode("utf-8")
        json.loads(line.decode("utf-8"))
        json_s += time.perf_counter() - t1
        nbytes += len(line)
    lat = sorted(lat)
    return {"requests": n, "wall_s": wall, "req_s": n / wall,
            "p50_ms": float(onp.percentile(lat, 50)),
            "p99_ms": float(onp.percentile(lat, 99)),
            "predict_s": busy, "neither_predicting_share": 1 - busy / wall,
            "batches": len(spans), "json_s": json_s,
            "json_share": json_s / wall, "reply_bytes_mean": nbytes / n,
            "by_replica": {k: sum(r["replica"] == k for r in replies)
                           for k in ("r0", "r1")}}


def _tier_traffic(srv, reqs, reps, seed) -> dict:
    """Every request over TCP from 4 client threads (closed loop). After
    ``TIER_KILL_AFTER`` replies r0's next flush is held until a client's
    request waits in its queue (or 30 s pass); then, with every client's
    submit held at the replicas for that instant, r0 dies by the
    ``replica_kill`` chaos site in its request path (so the armed site
    fires on r0), its queued requests fail fast and the router fails them
    over to r1; the health loop restarts r0."""
    n = len(reqs)
    replies, lat, errors = [None] * n, [0.0] * n, []
    done = [0]
    lock = threading.Lock()

    def client(cid):
        try:
            for i in range(cid, n, 4):
                t0 = time.perf_counter()
                replies[i] = serve.client_call(
                    "127.0.0.1", srv.port, _tier_payload(reqs[i]),
                    timeout=300)
                lat[i] = (time.perf_counter() - t0) * 1e3
                with lock:
                    done[0] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    gate, hold = threading.Event(), threading.Event()
    gate.set()
    hold.set()
    real = [rep.submit for rep in reps]
    cm0 = reps[0].registry.get("bert")
    real_predict = cm0.predict

    def gated(k):
        def submit(model, *arrays):
            gate.wait(120)
            return real[k](model, *arrays)
        return submit

    def held(*args):
        hold.wait(120)
        return real_predict(*args)

    for k, rep in enumerate(reps):
        rep.submit = gated(k)
    cm0.predict = held
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    queued = 0
    try:
        deadline = time.monotonic() + 300
        while done[0] < TIER_KILL_AFTER and time.monotonic() < deadline \
                and not errors:
            time.sleep(0.01)
        hold.clear()
        deadline = time.monotonic() + 30
        while reps[0].queue_depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        gate.clear()
        queued = reps[0].queue_depth()
        with inject.chaos(seed=seed, crash_sites=["replica_kill"]):
            try:
                real[0]("bert", *reqs[0])
            except serve.ReplicaUnavailable:
                pass
        t_kill = time.perf_counter()
    finally:
        hold.set()
        gate.set()
        for rep, submit in zip(reps, real):
            rep.submit = submit
        cm0.predict = real_predict
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "tier clients hung")
    check(not errors, f"tier client failed: {errors[:3]}")
    check(reps[0].kills == 1, f"r0 was not killed: {reps[0].snapshot()}")
    return {"replies": replies, "latency_ms": lat, "wall_s": wall,
            "kill_at_s": t_kill - t0, "queued_at_kill": queued}


def _tier_burst(srv, rng) -> dict:
    """``TIER_BURST`` short requests at once over TCP: each is answered
    or shed with ``retry_after``."""
    reqs = _requests(rng, TIER_BURST)
    reqs = [(a[:TIER_BURST_LEN], b[:TIER_BURST_LEN],
             onp.array(min(TIER_BURST_LEN, int(c)), "float32"))
            for a, b, c in reqs]
    replies, errors = [None] * len(reqs), []
    barrier = threading.Barrier(len(reqs))

    def one(i):
        try:
            barrier.wait(60)
            replies[i] = serve.client_call("127.0.0.1", srv.port,
                                           _tier_payload(reqs[i]),
                                           timeout=300)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    check(not errors, f"burst client failed: {errors[:3]}")
    return {"replies": replies}


def _tier_generate(srv, seed) -> dict:
    """Transformer-big generation through ``client_generate`` against the
    in-process tokens, an over-budget tenant shed, and
    ``decode_replica_death``."""
    t0 = time.perf_counter()
    net = nmt_model(dropout=0.0, seed=seed)
    engine = serve.DecodeEngine(net, serve.BucketTable(TIER_NMT_TABLE),
                                max_batch=8, block_size=16,
                                max_target_len=64)
    engine.warmup()
    qos = serve.TokenRateBudget(tokens_per_s=1, burst=TIER_NMT_BURST)
    batcher = serve.DecodeBatcher(engine, qos=qos).start()
    srv.attach_decoder("nmt", batcher)
    build_s = time.perf_counter() - t0
    rng = onp.random.RandomState(seed + 26)
    prompts = [rng.randint(3, NMT_VOCAB, int(rng.randint(8, 128))).astype(
        "int32") for _ in range(TIER_NMT_PROMPTS)]
    res = {"build_s": build_s, "streams": []}
    try:
        for k, p in enumerate(prompts):
            want = batcher.submit(p, max_new_tokens=TIER_NMT_NEW,
                                  tenant=f"local{k}").result(timeout=300)
            t1 = time.perf_counter()
            docs = list(serve.client_generate(
                "127.0.0.1", srv.port,
                {"model": "nmt", "tokens": p.tolist(),
                 "max_new_tokens": TIER_NMT_NEW, "tenant": f"wire{k}"},
                timeout=300))
            ms = (time.perf_counter() - t1) * 1e3
            got = [d["token"] for d in docs[:-1]]
            check(all(d["ok"] for d in docs) and docs[-1].get("done")
                  and got == want == docs[-1]["tokens"],
                  f"generate over TCP gave {got}, in process {want}: "
                  f"{docs[-1]}")
            res["streams"].append({"prompt": len(p), "tokens": len(got),
                                   "wire_ms": ms})
        shed = list(serve.client_generate(
            "127.0.0.1", srv.port,
            {"model": "nmt", "tokens": prompts[0].tolist(),
             "max_new_tokens": TIER_NMT_BURST + 8, "tenant": "heavy"}))
        check(len(shed) == 1 and not shed[0]["ok"]
              and shed[0]["error"].startswith("ShedError")
              and shed[0]["retry_after"] > 0,
              f"an over-budget tenant was not shed: {shed}")
        res["shed"] = shed[0]
        with inject.chaos(seed=seed, decode_replica_death=1.0):
            died = list(serve.client_generate(
                "127.0.0.1", srv.port,
                {"model": "nmt", "tokens": prompts[1].tolist(),
                 "max_new_tokens": 8, "tenant": "victim"}))
            streams = [batcher.submit(p, max_new_tokens=8,
                                      tenant=f"victim{k}")
                       for k, p in enumerate(prompts[:2])]
            failed = 0
            for s in streams:
                try:
                    s.result(timeout=300)
                except serve.ReplicaUnavailable:
                    failed += 1
        check(len(died) == 1 and not died[0]["ok"]
              and died[0]["error"].startswith("ReplicaUnavailable")
              and failed == len(streams),
              f"decode_replica_death: wire {died}, {failed} of "
              f"{len(streams)} streams failed")
        after = list(serve.client_generate(
            "127.0.0.1", srv.port,
            {"model": "nmt", "tokens": prompts[2].tolist(),
             "max_new_tokens": 8, "tenant": "after"}, timeout=300))
        check(after[-1].get("done") and len(after) > 1,
              f"the request after the replica death was not served: "
              f"{after[-1]}")
        res["stats"] = engine.stats()
        check(res["stats"]["decode"]["post_warmup_compiles"] == 0
              and res["stats"]["prefill"]["post_warmup_compiles"] == 0,
              f"generation captured after warmup: {res['stats']}")
    finally:
        batcher.stop()
    return res


def phase_serve_tier(seed: int) -> dict:
    """26. serve tier (the module docstring)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = models.serve_spec("bert_encoder")
    example = (onp.zeros((1, 8), "int32"), onp.zeros((1, 8), "int32"),
               onp.zeros((1,), "float32"))
    table = serve.BucketTable(TIER_TABLE)

    def loader(rep):
        rep.load("bert", table=table, input_axes=spec["input_axes"],
                 factory=_tier_bert, example_args=example,
                 output_axes=spec["output_axes"],
                 pad_values=spec["pad_values"])

    reps = [serve.Replica(f"r{i}", loader, max_delay_ms=5.0) for i in (0, 1)]
    router = serve.Router(reps, heartbeat_ms=50, stall_s=30, retries=3,
                          request_timeout_s=300)
    router.start()
    load_s = time.perf_counter() - t0
    srv = serve.Server(router=router).start()
    ref = _tier_bert()
    card = card_line()
    cms = [rep.registry.get("bert") for rep in reps]
    for rep, cm in zip(reps, cms):
        check(len(cm._graphs) == table.num_buckets()
              and cm.cache_info()["post_warmup_compiles"] == 0,
              f"{rep.name}: {len(cm._graphs)} graphs for "
              f"{table.num_buckets()} buckets, {cm.cache_info()}")
    print(f"serve tier: 2 replicas of BERT-base loaded in {load_s:.1f} s, "
          f"{table.num_buckets()} CUDA graphs each; resident "
          f"{[cm.resident_bytes() for cm in cms]} bytes on {card}",
          flush=True)
    rng = onp.random.RandomState(seed + 26)
    reqs = _requests(rng, TIER_REQUESTS)
    steady = _requests(onp.random.RandomState(seed + 2600), TIER_STEADY)
    res = {"card": card, "load_s": load_s, "buckets": table.num_buckets()}
    cuda_ops.reset_launches()
    try:
        # (1): ragged traffic over the wire, nothing killed
        res["steady"] = t = _tier_steady(srv, reps, steady)
        print(f"serve tier: steady window of {TIER_STEADY} requests over "
              f"TCP (4 threads, 4-511 tokens) in {t['wall_s']:.3f} s = "
              f"{t['req_s']:.2f} req/s, latency p50 {t['p50_ms']:.1f} ms "
              f"p99 {t['p99_ms']:.1f} ms; {t['batches']} batches, neither "
              f"replica in predict {100 * t['neither_predicting_share']:.1f}"
              f"% of the window; the replies' wire encoding (mean "
              f"{t['reply_bytes_mean']:.0f} bytes) re-timed on one thread "
              f"{t['json_s']:.3f} s = {100 * t['json_share']:.1f}% of the "
              f"window; replies by replica {t['by_replica']} on {card}",
              flush=True)
        # (2): ragged traffic over the wire, r0 killed mid-run
        t1 = time.perf_counter()
        traffic = _tier_traffic(srv, reqs, reps, seed)
        deadline = time.monotonic() + 300
        while not all(r.healthy() for r in reps) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        res["wait_for_r0_s"] = time.perf_counter() - t1 - traffic["wall_s"]
        replies = traffic["replies"]
        stats = router.snapshot()["stats"]
        check(all(r is not None and r["ok"] for r in replies),
              f"a request over the wire failed: "
              f"{[r for r in replies if not (r and r['ok'])][:2]}")
        check(stats["accepted"] == stats["completed"]
              == TIER_STEADY + TIER_REQUESTS and stats["shed"] == 0,
              f"accepted requests lost across the kill: {stats}")
        check(reps[0].kills == 1 and reps[0].restarts == 1
              and reps[0].healthy() and reps[1].healthy()
              and stats["restarts"] == 1,
              f"r0 did not die and come back once: {router.snapshot()}")
        cms = [rep.registry.get("bert") for rep in reps]
        check(all(len(cm._graphs) == table.num_buckets()
                  and cm.cache_info()["post_warmup_compiles"] == 0
                  for cm in cms), f"captures after warmup: "
              f"{[cm.cache_info() for cm in cms]}")
        picks = sorted(range(TIER_REQUESTS), key=lambda i: reqs[i][2])
        picks = [picks[int(j)] for j in onp.linspace(
            0, TIER_REQUESTS - 1, TIER_SAMPLES)]
        direct = [reps[0].submit("bert", *reqs[i]).result(timeout=300)
                  for i in picks[:2]]
        want = _tier_eager(ref, [reqs[i] for i in picks])
        worst = max([_tier_err(replies[i]["outputs"], w)
                     for i, w in zip(picks, want)]
                    + [_tier_err(d, w) for d, w in zip(direct, want)])
        check(worst <= SERVE_ATOL, f"served over the wire vs the eager "
              f"plain forward: max abs err {worst} > {SERVE_ATOL}")
        lat = sorted(traffic["latency_ms"])
        res["traffic"] = {
            "requests": TIER_REQUESTS, "wall_s": traffic["wall_s"],
            "req_s": TIER_REQUESTS / traffic["wall_s"],
            "p50_ms": float(onp.percentile(lat, 50)),
            "p99_ms": float(onp.percentile(lat, 99)),
            "failovers": stats["failovers"], "retries": stats["retries"],
            "kill_at_s": traffic["kill_at_s"],
            "restart_s": router.restart_seconds[-1],
            "served_vs_xla_max_abs_err": worst,
            "by_replica": {k: sum(r["replica"] == k for r in replies)
                           for k in ("r0", "r1")}}
        t = res["traffic"]
        t["queued_at_kill"] = traffic["queued_at_kill"]
        print(f"serve tier: kill window of {TIER_REQUESTS} requests over "
              f"TCP (4 threads, 4-511 tokens, r0's flush held, the kill and "
              f"the restart inside) in {t['wall_s']:.3f} s = "
              f"{t['req_s']:.2f} req/s, latency p50 {t['p50_ms']:.1f} ms p99 "
              f"{t['p99_ms']:.1f} ms; r0 killed at {t['kill_at_s']:.2f} s "
              f"with {t['queued_at_kill']} queued, "
              f"{t['failovers']} failovers, restarted in "
              f"{t['restart_s']:.2f} s; replies by replica "
              f"{t['by_replica']}; vs eager xla max abs err {worst:.2e} "
              f"on {card}", flush=True)

        # (3): the weight pipe, a perturbed checkpoint, no capture
        t1 = time.perf_counter()
        wrng = onp.random.RandomState(seed + 260)
        named = sorted(ref.collect_params().items())
        new = {}
        for name, p in named:
            w = p.data().asnumpy()
            new[name] = (w + TIER_WEIGHT_NOISE * (w.std() + 1e-12)
                         * wrng.standard_normal(w.shape)).astype(w.dtype)
        compiles = [cm.cache_info()["compiles"] for cm in cms]
        with tempfile.TemporaryDirectory() as root:
            t1 = time.perf_counter()
            fault.checkpoint.save_checkpoint(
                root, {f"param:{i:04d}": new[name]
                       for i, (name, _) in enumerate(named)},
                {"param_names": [name for name, _ in named]}, step=1)
            save_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            out = router.sync_weights_once("bert", root)
            sync_s = time.perf_counter() - t1
        check(out["outcome"] == "applied"
              and sorted(out["replicas"]) == ["r0", "r1"],
              f"weight sync: {out}")
        check([cm.cache_info()["compiles"] for cm in cms] == compiles,
              f"the weight sync captured: {compiles} -> "
              f"{[cm.cache_info()['compiles'] for cm in cms]}")
        serve.apply_weights(ref, new)
        want_new = _tier_eager(ref, [reqs[i] for i in picks[:2]])
        worst_new, moved = 0.0, 0.0
        for rep in reps:
            for i, w_new, w_old in zip(picks[:2], want_new, want[:2]):
                got = rep.submit("bert", *reqs[i]).result(timeout=300)
                worst_new = max(worst_new, _tier_err(got, w_new))
                moved = max(moved, _tier_err(got, w_old))
        check(worst_new <= SERVE_ATOL and moved > 10 * SERVE_ATOL,
              f"after the sync: vs the new weights {worst_new}, vs the old "
              f"{moved}")
        res["weight_sync"] = {"phase_s": time.perf_counter() - t1,
                              "save_s": save_s, "sync_s": sync_s,
                              "vs_new_max_abs_err": worst_new,
                              "vs_old_max_abs_err": moved,
                              "captures_added": 0}
        print(f"serve tier: weight sync of {len(named)} arrays (checkpoint "
              f"written in {save_s:.2f} s) applied to {out['replicas']} in "
              f"{sync_s:.2f} s, 0 captures; served vs new weights "
              f"{worst_new:.2e}, vs old {moved:.2e} on {card}", flush=True)

        # (4): a burst over the shed depth
        t1 = time.perf_counter()
        before = router.snapshot()["stats"]
        router.set_overload_policy(shed_depth=TIER_SHED_DEPTH)
        burst = _tier_burst(srv, rng)["replies"]
        router.set_overload_policy(shed_depth=0)
        after = router.snapshot()["stats"]
        ok = [r for r in burst if r["ok"]]
        shed = [r for r in burst if not r["ok"]]
        check(shed and all(r["error"].startswith("ShedError")
                           and r["retry_after"] > 0 for r in shed),
              f"burst of {TIER_BURST}: {len(shed)} shed, e.g. {shed[:1]}")
        check(after["accepted"] - before["accepted"] == len(ok)
              == after["completed"] - before["completed"],
              f"accepted burst requests lost: {before} -> {after}")
        res["shed"] = {"phase_s": time.perf_counter() - t1,
                       "burst": TIER_BURST, "served": len(ok),
                       "shed": len(shed),
                       "retry_after": sorted({r["retry_after"]
                                              for r in shed})}
        print(f"serve tier: burst of {TIER_BURST} at shed depth "
              f"{TIER_SHED_DEPTH}: {len(ok)} served, {len(shed)} shed with "
              f"retry_after {res['shed']['retry_after']} s", flush=True)

        # the replicas' launches: every BERT forward of the tier so far
        launches = cuda_ops.launch_counts()
        batches = {rep.name: rep.snapshot()["models"]["bert"]["batches"]
                   for rep in reps}

        # (5): Transformer-big generation over the wire
        cuda_ops.reset_launches()
        t1 = time.perf_counter()
        res["generate"] = _tier_generate(srv, seed)
        res["generate"]["phase_s"] = time.perf_counter() - t1
        gen_launches = cuda_ops.launch_counts()
    finally:
        t1 = time.perf_counter()
        srv.stop()
        router.stop()
        res["stop_s"] = time.perf_counter() - t1
    g = res["generate"]
    print(f"serve tier: Transformer-big built and warmed in "
          f"{g['build_s']:.1f} s; generate over TCP = in process for "
          f"{len(g['streams'])} prompts "
          f"({[round(s['wire_ms'], 1) for s in g['streams']]} ms); "
          f"over-budget tenant shed, retry_after {g['shed']['retry_after']}"
          f"; decode_replica_death failed its streams, the next was served "
          f"on {card}", flush=True)
    # r0's batches before its death went with its registry, so the
    # replicas' current batches are a floor
    n_layers = models.BERT_CONFIGS["bert_12_768_12"]["num_layers"]
    n_batches = sum(batches.values())
    check(launches[fa.KERNEL] >= n_layers * n_batches > 0
          and batches["r1"] > 0,
          f"the replicas launched {fa.KERNEL} {launches[fa.KERNEL]} times "
          f"for {batches} batches of {n_layers} layers")
    check(gen_launches[fa.KERNEL] > 0, f"the generation launched "
          f"{fa.KERNEL} {gen_launches[fa.KERNEL]} times")
    for name in (fa.KERNEL_BWD_DKV, fa.KERNEL_BWD_DQ):
        check(launches[name] == gen_launches[name] == 0,
              f"the serve tier launched the backward kernel {name} "
              f"{launches[name]} + {gen_launches[name]} times")
    res["launches"] = launches
    res["launches_generate"] = gen_launches
    res["batches"] = batches
    res["seconds"] = time.perf_counter() - t0
    print(f"serve tier: the replicas' launches {launches} over {batches} "
          f"batches, the generation's {gen_launches}; {res['seconds']:.1f} "
          f"s (load {load_s:.1f}, steady {res['steady']['wall_s']:.1f}, "
          f"kill window {res['traffic']['wall_s']:.1f}, waiting "
          f"for r0 {res['wait_for_r0_s']:.1f}, weight sync "
          f"{res['weight_sync']['phase_s']:.1f}, burst "
          f"{res['shed']['phase_s']:.1f}, generate {g['phase_s']:.1f}, "
          f"stop {res['stop_s']:.1f})", flush=True)
    return res


# ---------------------------------------------------------------------------
# 27. symbol: the Module API and train_mnist.py on the card
# ---------------------------------------------------------------------------
#: the JAX package's MNIST example gate (tests/test_examples.py:20-26)
SYM_GATE = dict(num_epochs=3, num_synthetic=600, lr=0.05)
SYM_GATE_ACC = 0.9
SYM_BATCH = 64
SYM_FIT_STEPS = 20          # (b): steps of the Module.fit whose captures count
SYM_REPLAY_ATOL = 1e-5      # (b): replayed vs eager, of each tensor's largest
SYM_GRAD_RTOL = 1e-4        # (b): card float32 vs CPU float64 gradients
SYM_PREDICT_ATOL = 1e-5     # (c): card Module vs CPU Module predictions
SYM_MEM_SLACK = 16 << 20    # (d): free bytes read twice, nothing allocated
SYM_TURNS = 3               # (e): eager and replayed turns
SYM_TURN_STEPS = 20
SYM_PROFILED = 5            # (e): steps in the profiled window, per step


def _sym_lenet_values(seed: int, batch: int = SYM_BATCH) -> dict:
    """Seeded arguments of ``lenet_symbol`` at ``batch``: parameters
    uniform in +-sqrt(3 / fan-in), MNIST-like data and labels."""
    sym = models.lenet_symbol()
    shapes, _, _ = sym.infer_shape(data=(batch, 1, 28, 28),
                                   softmax_label=(batch,))
    rng = onp.random.RandomState(seed)
    vals = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name == "data":
            vals[name] = rng.rand(*shape).astype("float32")
        elif name == "softmax_label":
            vals[name] = rng.randint(0, 10, shape).astype("float32")
        else:
            fan = int(onp.prod(shape[1:])) if len(shape) > 1 else shape[0]
            vals[name] = rng.uniform(-1, 1, shape).astype("float32") * \
                (3.0 / fan) ** 0.5
    return vals


def _sym_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def symbol_example_gates() -> dict:
    """(a) ``models.mnist_example`` (the JAX ``examples/train_mnist.py``)
    on ``gpu(0)`` with the JAX gate's arguments, ``mlp`` and ``lenet``."""
    res = {}
    for network in ("mlp", "lenet"):
        gc.collect()
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        acc = models.mnist_example(network, ctx=mx.gpu(0), **SYM_GATE)
        res[network] = {"accuracy": acc,
                        "seconds": time.perf_counter() - t0,
                        "launches": cuda_ops.launch_counts()}
        print(f"symbol example gate {network} {SYM_GATE}: accuracy "
              f"{acc:.4f} (gate > {SYM_GATE_ACC}), "
              f"{res[network]['seconds']:.1f} s", flush=True)
        check(acc > SYM_GATE_ACC, f"train_mnist {network} accuracy {acc} "
              f"<= {SYM_GATE_ACC}")
    return res


def symbol_replay_gate() -> dict:
    """(b) ``lenet_symbol`` by ``simple_bind`` at batch 64 on the card:
    the replayed forward+backward (one CUDA graph) against the eager one
    under deterministic algorithms, twice (the second on new data); the
    gradients against the CPU Executor's float64 run."""
    sym = models.lenet_symbol()
    exe = sym.simple_bind(ctx=mx.gpu(0), data=(SYM_BATCH, 1, 28, 28),
                          softmax_label=(SYM_BATCH,))
    names = sym.list_arguments()
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for seed in (1, 2):
            vals = _sym_lenet_values(seed)
            for graphed in (False, True):
                exe._graphed = graphed
                exe.copy_params_from({k: v for k, v in vals.items()})
                out = exe.forward(is_train=True)[0]._data.clone()
                exe.backward()
                runs[seed, graphed] = [out] + [
                    exe.grad_dict[n]._data.clone() for n in names]
    finally:
        torch.use_deterministic_algorithms(False)
    check(exe.captures == 1, f"the replay gate captured {exe.captures} "
          "graphs for one signature")
    replay_err = max(_sym_rel(a, b) for seed in (1, 2)
                     for a, b in zip(runs[seed, True], runs[seed, False]))
    bitwise = all(torch.equal(a, b) for seed in (1, 2)
                  for a, b in zip(runs[seed, True], runs[seed, False]))
    vals = _sym_lenet_values(1)
    cpu = sym.bind(mx.cpu(), {k: nd.array(v, ctx=mx.cpu(), dtype="float64")
                              for k, v in vals.items()},
                   {k: nd.zeros(v.shape, ctx=mx.cpu(), dtype="float64")
                    for k, v in vals.items()})
    cpu.forward(is_train=True)
    cpu.backward()
    grad_err = {n: _sym_rel(g, cpu.grad_dict[n]._data)
                for n, g in zip(names, runs[1, True][1:])
                if n not in ("data", "softmax_label")}
    worst = max(grad_err, key=grad_err.get)
    print(f"symbol replay gate: lenet batch {SYM_BATCH}, replayed vs eager "
          f"forward+backward worst rel err {replay_err:.2e} (bitwise "
          f"{bitwise}, tol {SYM_REPLAY_ATOL}); card float32 vs CPU float64 "
          f"gradients worst {grad_err[worst]:.2e} at {worst} (tol "
          f"{SYM_GRAD_RTOL})", flush=True)
    check(replay_err <= SYM_REPLAY_ATOL, f"the Executor's replay differs "
          f"from its eager run by {replay_err}")
    check(grad_err[worst] <= SYM_GRAD_RTOL, f"card gradients differ from "
          f"the CPU's float64 ones: {grad_err}")
    return {"replay_rel_err": replay_err, "bitwise": bitwise,
            "grad_rel_err": grad_err}


def _sym_iters(n: int, batch: int = SYM_BATCH):
    """MNIST-shaped blobs (``models.lenet.mnist_iters``) as ``n`` training
    and 2 held-out batches on the current context, in a fixed order."""
    train, _ = models.lenet.mnist_iters(batch, False, None,
                                        int((n + 2) * batch / 0.9) + 1)
    x, y = train.data[0][1], train.label[0][1]
    return (mx.io.NDArrayIter(x[:n * batch], y[:n * batch], batch),
            mx.io.NDArrayIter(x[n * batch:(n + 2) * batch],
                              y[n * batch:(n + 2) * batch], batch))


def symbol_fit_and_checkpoint() -> dict:
    """(b) a ``SYM_FIT_STEPS``-step ``Module.fit`` of lenet on the card
    with ``eval_data``: one capture per (shapes, ``is_train``); (c) its
    checkpoint loaded into a CPU Module, whose ``predict`` agrees."""
    mx.random.seed(0)
    with mx.gpu(0):
        train, val = _sym_iters(SYM_FIT_STEPS)
        mod = mx.module.Module(models.lenet_symbol(), context=mx.gpu(0))
        steps = []
        mod.fit(train, eval_data=val, num_epoch=1, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.05),
                                  ("momentum", 0.9)),
                batch_end_callback=lambda p: steps.append(p.nbatch))
        exe = mod._exec
        keys = sorted(str(k[0]) for k in exe._graphs)
        check(len(steps) == SYM_FIT_STEPS and exe.captures == 2
              and keys == ["False", "True"],
              f"Module.fit: {len(steps)} steps, {exe.captures} captures "
              f"for signatures {keys} (one training, one scoring)")
        card_pred = mod.predict(val).asnumpy()
        root = tempfile.mkdtemp(prefix="mxsym_")
        try:
            mod.save_checkpoint(os.path.join(root, "lenet"), 1)
            with mx.cpu():
                cpu_val = mx.io.NDArrayIter(val.data[0][1], val.label[0][1],
                                            SYM_BATCH)
                cpu_mod = mx.module.Module.load(os.path.join(root, "lenet"),
                                                1, context=mx.cpu())
                cpu_mod.bind(cpu_val.provide_data, cpu_val.provide_label,
                             for_training=False)
                cpu_mod.init_params()
                cpu_pred = cpu_mod.predict(cpu_val).asnumpy()
        finally:
            shutil.rmtree(root, ignore_errors=True)
    err = float(onp.abs(card_pred - cpu_pred).max())
    print(f"symbol fit: {len(steps)} steps of lenet batch {SYM_BATCH} with "
          f"eval, {exe.captures} captures (signatures is_train {keys}); a "
          f"card checkpoint's CPU Module predicts within {err:.2e} (tol "
          f"{SYM_PREDICT_ATOL})", flush=True)
    check(err <= SYM_PREDICT_ATOL, f"the CPU Module's predictions differ "
          f"from the card's by {err}")
    return {"steps": len(steps), "captures": exe.captures,
            "predict_max_abs_err": err}


def symbol_queue_c() -> dict:
    """(d) Negative-step indexing with its gradient on a CUDA NDArray
    against the CPU's; ``mx.gpu_memory_info`` against
    ``torch.cuda.mem_get_info``; an array moved or made (in another dtype)
    on ``cpu_pinned`` is page-locked with the same values."""
    host = onp.random.RandomState(3).randn(6, 9).astype("float32")
    got = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        x = nd.array(host, ctx=ctx)
        x.attach_grad()
        w = nd.array(onp.arange(6 * 5, dtype="float32").reshape(6, 5),
                     ctx=ctx)
        with autograd.record():
            y = x[:, ::-2] * w
        y.backward()
        z = nd.zeros((6, 9), ctx=ctx)
        z[::-1, 1::3] = nd.array(host[:, :3], ctx=ctx)
        got[ctx.device_type] = (y.asnumpy(), x.grad.asnumpy(), z.asnumpy())
    same = all(onp.array_equal(a, b) for a, b in zip(got["gpu"],
                                                      got["cpu"]))
    card = nd.array(host, ctx=mx.gpu(0))
    moved = card.as_in_context(mx.cpu_pinned())
    made = nd.array(card._data, ctx=mx.cpu_pinned(), dtype="float16")
    pinned = (moved._data.is_pinned() and made._data.is_pinned()
              and onp.array_equal(moved.asnumpy(), host)
              and onp.array_equal(made.asnumpy(), host.astype("float16")))
    info = mx.gpu_memory_info(0)
    ref = torch.cuda.mem_get_info(0)
    stats = mx.gpu(0).memory_stats()
    print(f"symbol queue C: x[:, ::-2] with its gradient and x[::-1, 1::3] "
          f"= v on the card equal to the CPU: {same}; gpu_memory_info "
          f"{info} vs mem_get_info {ref}; memory_stats in use "
          f"{stats['bytes_in_use']} of {stats['bytes_limit']}; cpu_pinned "
          f"page-locked with equal values: {pinned}", flush=True)
    check(same, "negative-step indexing on the card differs from the CPU")
    check(pinned, "an array on cpu_pinned is not page-locked or differs")
    check(info[1] == ref[1] and abs(info[0] - ref[0]) <= SYM_MEM_SLACK,
          f"gpu_memory_info {info} vs torch.cuda.mem_get_info {ref}")
    return {"indexing_equal": same, "gpu_memory_info": list(info),
            "mem_get_info": list(ref), "cpu_pinned": pinned}


def _sym_module(network: str, graphed: bool):
    """A bound, initialised Module of ``network`` at batch 64 on the card
    and its training batches (one epoch of the gate's data)."""
    flat = network == "mlp"
    mx.random.seed(0)
    with mx.gpu(0):
        train, _ = models.lenet.mnist_iters(
            SYM_BATCH, flat, None, int(SYM_TURN_STEPS * SYM_BATCH / 0.9) + 1)
        sym = models.mlp_symbol() if flat else models.lenet_symbol()
        mod = mx.module.Module(sym, context=mx.gpu(0))
        mod.bind(train.provide_data, train.provide_label)
        mod.init_params(mx.init.Xavier(magnitude=2.0))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.05),
                                             ("momentum", 0.9)))
        mod._exec._graphed = graphed
        batches = list(train)
    return mod, batches


def _sym_step(mod, batch, metric) -> None:
    mod.forward_backward(batch)
    mod.update()
    mod.update_metric(metric, batch.label)


def symbol_step_times() -> dict:
    """(e) printed, not gated: ``Module.fit``'s step (forward_backward,
    update, update_metric) eager and replayed in turns, mlp and lenet at
    batch 64; a profiled window of ``SYM_PROFILED`` steps of each, per
    step, with its idle share."""
    res = {}
    for network in ("mlp", "lenet"):
        mods = {g: _sym_module(network, g) for g in (False, True)}
        times = {False: [], True: []}
        for _ in range(SYM_TURNS):
            for graphed, (mod, batches) in mods.items():
                metric = mx.metric.Accuracy()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches:
                    _sym_step(mod, b, metric)
                torch.cuda.synchronize()
                times[graphed].append((time.perf_counter() - t0) * 1e3
                                      / len(batches))
        rec = {}
        for graphed, (mod, batches) in mods.items():
            tag = "replayed" if graphed else "eager"
            metric = mx.metric.Accuracy()
            for _ in range(3):   # a trace now and then records no device event
                wall, per_kernel = device_split(lambda: [
                    _sym_step(mod, b, metric)
                    for b in batches[:SYM_PROFILED]])
                if per_kernel:
                    break
            wall /= SYM_PROFILED
            # a window whose traces all came back empty measured nothing:
            # its device time and idle share are not measured (None)
            busy = (sum(per_kernel.values()) / SYM_PROFILED if per_kernel
                    else None)
            rec[tag] = {"step_ms": statistics.median(times[graphed]),
                        "turns_ms": times[graphed],
                        "profiled_wall_ms": wall, "device_ms": busy,
                        "idle_share": (None if busy is None else
                                       max(0.0, 1.0 - busy / wall)),
                        "captures": mod._exec.captures}
        res[network] = rec

        def window(r):
            if r["device_ms"] is None:
                return (f"device not measured (no device event in 3 traces)"
                        f" in {r['profiled_wall_ms']:.3f} ms")
            return (f"{r['device_ms']:.3f} ms device in "
                    f"{r['profiled_wall_ms']:.3f} ms (idle "
                    f"{r['idle_share']:.1%})")
        print(f"symbol step {network} batch {SYM_BATCH} (median of "
              f"{SYM_TURNS} turns of {SYM_TURN_STEPS} steps): eager "
              f"{rec['eager']['step_ms']:.3f} ms, replayed "
              f"{rec['replayed']['step_ms']:.3f} ms; profiled, per step: "
              f"eager {window(rec['eager'])}, replayed "
              f"{window(rec['replayed'])}", flush=True)
    return res


def phase_symbol() -> dict:
    """27. symbol (the module docstring)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cuda_ops.reset_launches()
    res = {"examples": symbol_example_gates(),
           "replay": symbol_replay_gate(),
           "fit": symbol_fit_and_checkpoint(),
           "queue_c": symbol_queue_c(),
           "steps": symbol_step_times()}
    res["launches"] = cuda_ops.launch_counts()
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card_line()
    print(f"symbol: {res['seconds']:.1f} s on {res['card']}; attention "
          f"kernel launches {res['launches']}", flush=True)
    check(not any(res["launches"].values()), f"the symbol phase launched "
          f"attention kernels: {res['launches']}")
    return res


# ---------------------------------------------------------------------------
# 28. artifacts: BERT-base served from an exported artifact
# ---------------------------------------------------------------------------
ART_INPUTS = ["ids", "token_types", "valid_length"]
ART_EXAMPLE = (onp.zeros((1, 8), "int32"), onp.zeros((1, 8), "int32"),
               onp.full((1,), 8, "float32"))
#: (d): (batch, longest request) of the batches held against the factory
#: model, in four buckets of the tier's table
ART_BATCHES = ((1, 9), (3, 130), (8, 512), (5, 64))
#: (d), (e): artifact replies against the factory-built CompiledModel: the
#: serving gates' tolerance (the same ops on the same weights: expected 0)
ART_TOL = SERVE_ATOL
ART_LAYERS = 12
#: (g): the DENSE_ACT partition card vs CPU, relative to the largest output
ART_DENSE_RTOL = 1e-5
ART_EXAMPLE_REQUESTS = 64


def _art_batch(rng, B: int, L: int) -> list:
    """``B`` ragged BERT requests, the longest ``L``, as one zero-padded
    batch of numpy arrays."""
    lens = [L] + [int(x) for x in rng.randint(4, L + 1, B - 1)]
    ids = onp.zeros((B, L), "int32")
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, 30522, n)
    tt = (onp.arange(L)[None] >= L // 2).repeat(B, 0).astype("int32")
    return [ids, tt, onp.array(lens, "float32")]


def _art_err(got, want) -> float:
    return max(float((g._data.float() - w._data.float()).abs().max())
               for g, w in zip(got, want))


def _art_recorded_bert():
    """The tier's BERT-base with one recorded forward (the signature an
    export traces)."""
    net = _tier_bert()
    net(*(nd.array(a, ctx=mx.gpu(0), dtype=a.dtype) for a in ART_EXAMPLE))
    return net


def art_serve(root: str, load_kw: dict, seed: int) -> dict:
    """(a)-(e): export, the registry's cold load, replies against the
    factory-built model, the weights from a checkpoint."""
    res = {}
    t0 = time.perf_counter()
    net = _art_recorded_bert()
    res["build_s"] = time.perf_counter() - t0
    prefix = os.path.join(root, "export", "bert")
    os.makedirs(os.path.dirname(prefix))
    t0 = time.perf_counter()
    sym_file, params_file = serve.export_for_serving(
        net, prefix, load_kw["table"], load_kw["input_axes"])
    res["export_s"] = time.perf_counter() - t0
    with open(sym_file) as f:
        arch = json.load(f)
    files = {n: os.path.getsize(os.path.join(os.path.dirname(prefix), n))
             for n in os.listdir(os.path.dirname(prefix))}
    res["files"] = files
    programs = {e["pt2"] for e in arch["signatures"]}
    check(len(arch["signatures"]) == load_kw["table"].num_buckets()
          and len(programs) == 1, f"the manifest's signatures name "
          f"{len(programs)} programs for {len(arch['signatures'])} entries")
    print(f"artifacts: BERT-base built in {res['build_s']:.1f} s, exported "
          f"for {len(arch['signatures'])} buckets in {res['export_s']:.2f} s "
          f"(one program); files {files} bytes on {card_line()}",
          flush=True)

    # (b), (c): the registry's cold load and warmup from the files
    reg = serve.ModelRegistry()
    t0 = time.perf_counter()
    reg.load("bert", artifacts=prefix, input_names=ART_INPUTS, **load_kw)
    res["registry_load_s"] = time.perf_counter() - t0
    cm = reg.get("bert")
    blk = cm._block
    (ep,) = blk._loaded.values()
    nodes = sum(str(n.target).startswith("mxtpu.flash_attention_fwd")
                for n in ep.graph.nodes)
    res["flash_nodes"] = nodes
    check(nodes == ART_LAYERS and not ep.state_dict and not ep.constants,
          f"the exported program holds {nodes} flash nodes, "
          f"{len(ep.state_dict)} weights and {len(ep.constants)} constants")
    check(len(cm._graphs) == load_kw["table"].num_buckets()
          and cm.cache_info()["post_warmup_compiles"] == 0,
          f"artifact model: {len(cm._graphs)} graphs, {cm.cache_info()}")

    # (d): replies against the factory-built CompiledModel, the same weights
    ref = serve.CompiledModel(net, **load_kw)
    rng = onp.random.RandomState(seed + 28)
    batches = [_art_batch(rng, B, L) for B, L in ART_BATCHES]
    cuda_ops.reset_launches()
    got = [cm.predict(*b) for b in batches]
    torch.cuda.synchronize()
    res["launches"] = cuda_ops.launch_counts()
    want = [ref.predict(*b) for b in batches]
    errs = [_art_err(g, w) for g, w in zip(got, want)]
    res["vs_factory_max_abs_err"] = max(errs)
    res["bitwise"] = all(e == 0.0 for e in errs)
    check(max(errs) <= ART_TOL, f"artifact replies vs the factory model: "
          f"{errs} > {ART_TOL}")
    check(res["launches"][fa.KERNEL] == ART_LAYERS * len(batches),
          f"{res['launches']} for {len(batches)} batches of "
          f"{ART_LAYERS} layers")
    table = load_kw["table"]
    largest = {n: table.sizes(n)[-1] for n in table.axes}
    key = tuple(cm.signature_for(largest))
    _, per_kernel = device_split(cm._graphs[key].graph.replay)
    to_host = [k for k in per_kernel if "DtoH" in k]
    res["replay_kernels"] = len(per_kernel)
    check(per_kernel and not to_host, f"a replay moved data to the host: "
          f"{to_host} ({len(per_kernel)} device events)")
    print(f"artifacts: registry cold load (import, 28 captures) in "
          f"{res['registry_load_s']:.2f} s; {nodes} flash nodes; replies vs "
          f"the factory model max abs err {max(errs):.2e} (bitwise "
          f"{res['bitwise']}); forward launches {res['launches']} for "
          f"{len(batches)} batches; a replay of {largest}: "
          f"{len(per_kernel)} device events, none to the host", flush=True)

    # (e): the weights of a checkpoint through set_weights, in place
    wrng = onp.random.RandomState(seed + 280)
    named = sorted(net._collect_params_with_prefix().items())
    new = {}
    for name, p in named:
        w = p.data().asnumpy()
        new[name] = (w + TIER_WEIGHT_NOISE * (w.std() + 1e-12)
                     * wrng.standard_normal(w.shape)).astype(w.dtype)
    compiles = cm.cache_info()["compiles"]
    ckpt = os.path.join(root, "ckpt")
    fault.checkpoint.save_checkpoint(
        ckpt, {f"param:{i:04d}": new[n] for i, (n, _) in enumerate(named)},
        {"param_names": [n for n, _ in named]}, step=1)
    t0 = time.perf_counter()
    arrays, meta, _ = fault.checkpoint.load_latest(ckpt)
    applied = blk.set_weights(serve.map_checkpoint_arrays(arrays, meta))
    cm.refresh_params()
    res["set_weights_s"] = time.perf_counter() - t0
    serve.apply_weights(net, new)
    ref.refresh_params()
    got = [cm.predict(*b) for b in batches[:2]]
    want_new = [ref.predict(*b) for b in batches[:2]]
    after = max(_art_err(g, w) for g, w in zip(got, want_new))
    moved = max(_art_err(g, w) for g, w in zip(got, want[:2]))
    res["weights"] = {"applied": applied, "vs_new_max_abs_err": after,
                      "vs_old_max_abs_err": moved,
                      "captures_added": cm.cache_info()["compiles"]
                      - compiles}
    check(applied == len(named) and after <= ART_TOL
          and moved > 10 * ART_TOL
          and cm.cache_info()["compiles"] == compiles,
          f"set_weights from a checkpoint: {res['weights']}")
    print(f"artifacts: {applied} arrays of a checkpoint through set_weights "
          f"in {res['set_weights_s']:.2f} s, 0 captures; replies vs the new "
          f"weights {after:.2e}, vs the old {moved:.2e}", flush=True)
    return res


def art_restarts(root: str, load_kw: dict) -> dict:
    """(f): a replica's load timed three ways in turns: from the factory,
    through the cache on a miss (factory, export, put, load) and on a hit
    (no model built); then a corrupted entry evicted as a miss."""
    cache = serve.ArtifactCache(os.path.join(root, "cache"))
    built = []

    def factory():
        built.append(1)
        return _tier_bert()

    def loader(with_cache):
        def load(rep):
            rep.load("bert", factory=factory, example_args=ART_EXAMPLE,
                     input_names=ART_INPUTS,
                     cache=cache if with_cache else None, **load_kw)
        return load

    res = {}
    for how in ("factory", "miss", "hit"):
        gc.collect()
        torch.cuda.empty_cache()
        n_built = len(built)
        rep = serve.Replica(how, loader(how != "factory"))
        t0 = time.perf_counter()
        rep.start()
        res[f"{how}_s"] = time.perf_counter() - t0
        cm = rep.registry.get("bert")
        check(rep.healthy() and len(cm._graphs)
              == load_kw["table"].num_buckets()
              and cm._mode == ("block" if how == "factory" else "artifact")
              and len(built) - n_built == (0 if how == "hit" else 1),
              f"restart by {how}: {rep.state}, {len(cm._graphs)} graphs, "
              f"mode {cm._mode}, models built {len(built) - n_built}")
        rep.stop()
        del rep, cm
    stats = cache.snapshot()
    check(stats == {"hits": 1, "misses": 1, "corrupt": 0, "puts": 1},
          f"cache after miss and hit: {stats}")
    with inject.chaos(seed=28, crash_sites=["corrupt_artifact"]):
        missed = cache.get("bert", 1, load_kw["table"],
                           load_kw["input_axes"]) is None
    stats = res["cache"] = cache.snapshot()
    check(missed and stats["corrupt"] == 1 and not os.listdir(
        os.path.join(root, "cache", "bert")),
          f"a corrupted entry was not evicted as a miss: {stats}")
    print(f"artifacts: a replica's load from the factory "
          f"{res['factory_s']:.2f} s, through the cache on a miss "
          f"{res['miss_s']:.2f} s, on a hit {res['hit_s']:.2f} s (no model "
          f"built); a corrupted entry evicted as a miss; cache {stats} on "
          f"{card_line()}", flush=True)
    return res


def art_backends() -> dict:
    """(g): ``optimize_for("INT8")`` and a ``DENSE_ACT`` partition, card
    against CPU, from the same weights."""
    from incubator_mxnet_tpu_torch.quantization import _QuantizedLayerBase
    rng = onp.random.RandomState(28)
    x = rng.randn(4, 1, 12, 12).astype("float32")
    res = {}
    with tempfile.TemporaryDirectory() as root:
        outs, nets = {}, {}
        for dev, ctx in (("cpu", mx.cpu()), ("gpu", mx.gpu(0))):
            with ctx:
                net = gluon.nn.HybridSequential(prefix="q_")
                with net.name_scope():
                    net.add(gluon.nn.Conv2D(8, kernel_size=3, padding=1,
                                            activation="relu",
                                            in_channels=1))
                    net.add(gluon.nn.MaxPool2D(pool_size=2, strides=2))
                    net.add(gluon.nn.Flatten())
                    net.add(gluon.nn.Dense(32, activation="relu",
                                           in_units=288))
                    net.add(gluon.nn.Dense(10, in_units=32))
                if dev == "cpu":
                    mx.random.seed(28)
                    net.initialize(mx.init.Xavier())
                    net.save_parameters(f"{root}/q.params")
                else:
                    net.load_parameters(f"{root}/q.params", ctx=ctx)
                xs = nd.array(x)
                outs[dev] = net.optimize_for(
                    xs, backend="INT8", calib_data=[xs]).asnumpy()
                nets[dev] = net
        swapped = [c for c in nets["gpu"]._children.values()
                   if isinstance(c, _QuantizedLayerBase)]
        step = max(max(abs(v) for v in c._range) for c in swapped) / 127
        err = float(onp.abs(outs["gpu"] - outs["cpu"]).max())
        same_q = all(onp.array_equal(a.qweight.data().asnumpy(),
                                     b.qweight.data().asnumpy())
                     for a, b in zip(
                         [c for c in nets["cpu"]._children.values()
                          if isinstance(c, _QuantizedLayerBase)], swapped))
        res["int8"] = {"layers": len(swapped), "max_abs_err": err,
                       "int8_step": step, "qweights_equal": same_q}
        check(len(swapped) == 3 and same_q and err <= step,
              f"optimize_for INT8 card vs CPU: {res['int8']}")
        h = rng.randn(16, 64).astype("float32")
        outs = {}
        for dev, ctx in (("cpu", mx.cpu()), ("gpu", mx.gpu(0))):
            with ctx:
                net = gluon.nn.HybridSequential(prefix="da_")
                with net.name_scope():
                    net.add(gluon.nn.Dense(256, activation="tanh",
                                           in_units=64))
                    net.add(gluon.nn.Dense(10, in_units=256))
                if dev == "cpu":
                    mx.random.seed(29)
                    net.initialize(mx.init.Xavier())
                    net.save_parameters(f"{root}/d.params")
                else:
                    net.load_parameters(f"{root}/d.params", ctx=ctx)
                plain = net(nd.array(h)).asnumpy()
                part = net.optimize_for(nd.array(h), backend="DENSE_ACT")
                ops = [n._op for n in mx.sym._topo(net._sg_graph[0])]
                outs[dev] = (part.asnumpy(), plain, ops)
        scale = float(onp.abs(outs["cpu"][0]).max())
        res["dense_act"] = {
            "rel_err": float(onp.abs(outs["gpu"][0] - outs["cpu"][0]).max())
            / scale,
            "vs_plain_rel_err": float(onp.abs(
                outs["gpu"][0] - outs["gpu"][1]).max()) / scale,
            "fused": outs["gpu"][2].count("_sg_dense_act")}
        d = res["dense_act"]
        check(d["rel_err"] <= ART_DENSE_RTOL and d["fused"] == 1
              and d["vs_plain_rel_err"] <= ART_DENSE_RTOL,
              f"DENSE_ACT card vs CPU: {d}")
    print(f"artifacts: optimize_for INT8 card vs CPU {res['int8']}; "
          f"DENSE_ACT {res['dense_act']}", flush=True)
    return res


def phase_artifacts(seed: int) -> dict:
    """28. artifacts (the module docstring)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = models.serve_spec("bert_encoder")
    load_kw = dict(table=serve.BucketTable(TIER_TABLE),
                   input_axes=spec["input_axes"],
                   output_axes=spec["output_axes"],
                   pad_values=spec["pad_values"])
    root = tempfile.mkdtemp(prefix="mx-artifacts-")
    try:
        res = art_serve(root, load_kw, seed)
        res["card"] = card_line()
        launches = res["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        cuda_ops.reset_launches()
        res["restarts"] = art_restarts(root, load_kw)
        res["backends"] = art_backends()
        t1 = time.perf_counter()
        with mx.gpu(0):
            ex = models.serving_example(requests=ART_EXAMPLE_REQUESTS,
                                        export_dir=os.path.join(root, "ex"))
        cc = ex["metrics"]["compile_cache"]
        res["example"] = {"served": ex["served"], "seconds":
                          time.perf_counter() - t1, "compile_cache": cc}
        check(ex["served"] == ART_EXAMPLE_REQUESTS
              and cc["post_warmup_compiles"] == 0,
              f"serving_example: {res['example']}")
        rest = cuda_ops.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in (fa.KERNEL_BWD_DKV, fa.KERNEL_BWD_DQ):
        check(launches[name] == rest[name] == 0,
              f"the artifact phase launched the backward kernel {name}")
    res["seconds"] = time.perf_counter() - t0
    print(f"artifacts: serving_example served {ex['served']} requests in "
          f"{res['example']['seconds']:.1f} s, 0 captures after warmup "
          f"({cc['cached_executables']} buckets); phase "
          f"{res['seconds']:.1f} s", flush=True)
    return res


# -- parallel: the ring's hop, the ring's schedule, a one-rank NCCL group ---
# one ring hop of BERT-base at sp=4, and the train shape the ring cuts
PAR_HOP = (8, 12, 128, 64)
PAR_RING = (8, 12, 512, 64)
PAR_SP = 4
# flash_block vs its plain versions on the card (o, lse, dq/dk/dv): the
# kernels' own (atol, rtol) of phase 3 (3xTF32 float32; one bf16 ulp), as
# max abs err <= atol + rtol * max |plain value|
PAR_HOP_TOL = TOL
# the serial 4-hop ring vs flash_attention of the whole sequence: the same
# softmax merged over 4 hops in float32, another summation order; bf16:
# each hop's o is rounded to bf16 before the merge (one ulp, 2**-8
# relative, per hop) and each hop's dq/dk/dv before their sum over hops:
# per tensor, max abs err <= tol * max |whole-sequence value|
PAR_RING_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def par_flash_block() -> dict:
    """(a): ``flash_block`` on the card against its plain version, timed
    (module docstring, phase 29)."""
    B, H, L, D = PAR_HOP
    g = torch.Generator(device="cuda").manual_seed(29)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = PAR_HOP_TOL[dtype]
        q, k, v, do = (torch.randn(B, H, L, D, device="cuda",
                                   generator=g).to(dtype) for _ in range(4))
        dlse = torch.randn(B, H, L, device="cuda", generator=g)
        km = (torch.rand(B, L, device="cuda", generator=g) > 0.3).int()
        km[1] = 0                        # no key for batch row 1 here
        live = km.bool().any(-1)[:, None].expand(B, H)
        for causal in (False, True):
            a, b, c = (t.detach().clone().requires_grad_(True)
                       for t in (q, k, v))
            o, lse = fa.flash_block(a, b, c, km, causal, D ** -0.5)
            ((o.float() * do.float()).sum() + (lse * dlse).sum()).backward()
            ro, rlse = fa.flash_attention_reference(q, k, v, km, causal,
                                                    D ** -0.5)
            rdelta = (fa._delta(ro, do) - dlse).contiguous()
            rgrads = fa.flash_attention_bwd_reference(
                q, k, v, km, causal, D ** -0.5, None, ro, rlse, do, rdelta)
            res = [[t.detach().float() for t in
                    (o, lse, a.grad, b.grad, c.grad)],
                   [t.float() for t in (ro, rlse) + tuple(rgrads)]]
            errs = {}
            for name, got, want in zip(("o", "lse", "dq", "dk", "dv"),
                                       *res):
                if name == "lse":
                    check(bool((got[~live] < -1e29).all()),
                          "flash_block: a keyless row's lse is not ~-1e30")
                    got, want = got[live], want[live]
                err = (got - want).abs().max().item()
                errs[name] = err
                check(err <= atol + rtol * want.abs().max().item(),
                      f"flash_block {dtype} causal={causal}: {name} differs "
                      f"from the plain version by {err}")
            out[f"{dtype_name(dtype)}_mode{int(causal)}"] = errs
        scale = D ** -0.5
        o, lse = fa._fwd(q, k, v, km, False, scale)
        delta = (fa._delta(o, do) - dlse).contiguous()
        timed = {
            "fwd": (lambda: fa._fwd(q, k, v, km, False, scale),
                    lambda: fa.flash_attention_reference(
                        q, k, v, km, False, scale)),
            "bwd": (lambda: fa._bwd(q, k, v, km, False, scale, None, lse,
                                    do, delta),
                    lambda: fa.flash_attention_bwd_reference(
                        q, k, v, km, False, scale, None, o, lse, do, delta)),
        }
        for name, (kern, plain) in timed.items():
            out[f"{dtype_name(dtype)}_{name}_ms"] = cuda_ms(kern)
            out[f"{dtype_name(dtype)}_{name}_device_ms"] = device_ms(kern)
            out[f"{dtype_name(dtype)}_{name}_plain_ms"] = cuda_ms(plain)
    print(f"parallel (a): flash_block {PAR_HOP} vs plain: " + ", ".join(
        f"{k} {v if isinstance(v, dict) else round(v, 4)}"
        for k, v in out.items()), flush=True)
    return out


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ring_serial(q, k, v, km, causal):
    """The 4-hop ring schedule in one process: rank ``r`` holds query
    block ``r`` and meets the K/V blocks ``r, r-1, ...`` in turn, through
    ``ring._hop_attn`` and ``ring._merge``; the ranks' outputs gathered
    along the sequence."""
    from incubator_mxnet_tpu_torch.parallel import ring
    n, lq = PAR_SP, q.shape[2] // PAR_SP
    scale = q.shape[-1] ** -0.5
    kv = torch.stack([k, v])
    outs = []
    for r in range(n):
        qr = q[:, :, r * lq:(r + 1) * lq].contiguous()
        o = torch.zeros(qr.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(qr.shape[:3], -1e30, device=q.device)
        for i in range(n):
            src = (r - i) % n
            o_i, lse_i = ring._hop_attn(
                qr, kv[:, :, :, src * lq:(src + 1) * lq].contiguous(),
                km[:, src * lq:(src + 1) * lq].contiguous(),
                ring.hop_mode(src, r, causal), r * lq, src * lq, scale)
            o, lse = ring._merge(o, lse, o_i, lse_i)
        outs.append(ring._finish(o, lse, q.dtype))
    return torch.cat(outs, dim=2)


def par_ring_schedule() -> dict:
    """(b): the serial 4-hop ring against the whole sequence (module
    docstring, phase 29); returns the errors and the launches."""
    B, H, L, D = PAR_RING
    g = torch.Generator(device="cuda").manual_seed(30)
    res = {}
    launches = {n: 0 for n in fa.KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        tol = PAR_RING_TOL[dtype]
        q, k, v, do = (torch.randn(B, H, L, D, device="cuda",
                                   generator=g).to(dtype).contiguous()
                       for _ in range(4))
        km = (torch.rand(B, L, device="cuda", generator=g) > 0.2).int()
        km[2, L // PAR_SP:2 * L // PAR_SP] = 0  # a keyless shard, row 2
        km[:, 0] = 1     # every causal row sees a key (else the whole-
        #                  sequence kernel gives it the mean of V, the ring 0)
        for causal in (False, True):
            got, want = [], []
            for ring_path in (True, False):
                a, b, c = (t.detach().clone().requires_grad_(True)
                           for t in (q, k, v))
                if ring_path:
                    cuda_ops.reset_launches()
                    o = _ring_serial(a, b, c, km, causal)
                    (o.float() * do.float()).sum().backward()
                    torch.cuda.synchronize()
                    counts = cuda_ops.launch_counts()
                else:
                    o = fa.flash_attention(a, b, c, mask=km, causal=causal)
                    (o.float() * do.float()).sum().backward()
                (got if ring_path else want).extend(
                    t.detach().float() for t in (o, a.grad, b.grad, c.grad))
            live = 16 if not causal else 10
            check(all(counts[n] == live for n in fa.KERNELS),
                  f"ring schedule {dtype} causal={causal}: launches "
                  f"{counts}, expected {live} of each kernel")
            for n in fa.KERNELS:
                launches[n] += counts[n]
            errs = {}
            for name, x, y in zip(("o", "dq", "dk", "dv"), got, want):
                err = ((x - y).abs().max() / y.abs().max()).item()
                errs[name] = err
                check(err <= tol, f"ring schedule {dtype} causal={causal}: "
                      f"{name} rel err {err} > {tol}")
            res[f"{dtype_name(dtype)}_causal{int(causal)}"] = dict(
                errs, launches=counts)
    res["launches"] = launches
    print(f"parallel (b): 4-hop ring at {PAR_RING} vs whole sequence: "
          f"{res}", flush=True)
    return res


def par_nccl_trainer(steps: int = 3) -> dict:
    """(c): a one-rank NCCL group, the collectives, ``mx.kv``'s ``nccl``
    store and the mesh trainer against the mesh-less fused one (module
    docstring, phase 29). At one rank ``rules`` and ``zero1`` are no-ops:
    every parameter stays whole and the mesh trainer takes the fused path,
    so no line of the multi-rank step runs here."""
    from incubator_mxnet_tpu_torch.parallel import collectives as C
    parallel.initialize(backend="nccl")
    try:
        import torch.distributed as tdist
        check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
              "dist.initialize(backend='nccl') made no one-rank NCCL group")
        x = torch.randn(4, 1024, device="cuda")
        for name, y in (("all_reduce", C.all_reduce(x, None)),
                        ("all_gather", C.all_gather(x, None)),
                        ("reduce_scatter", C.reduce_scatter(x, None)),
                        ("broadcast", C.broadcast(x, None)),
                        ("all_to_all", C.all_to_all(x, None, 0, 1))):
            torch.cuda.synchronize()
            check(torch.equal(y, x), f"one-rank {name} changed its input")
        kv = mx.kv.create("nccl")
        kv.init(0, nd.zeros((4, 1024), ctx=mx.gpu(0)))
        kv.push(0, [nd.NDArray(x), nd.NDArray(x)])
        check(torch.equal(kv.pull(0)._data, 2 * x), "nccl store: push/pull")
        batch = bench.make_batch(8, 128)
        torch.use_deterministic_algorithms(True)
        try:
            nets, trainers = [], []
            for mesh in (parallel.make_mesh(), None):
                net = models.get_bert(
                    "bert_12_768_12", vocab_size=bench.VOCAB,
                    max_length=128, dropout=0.0, device="cuda",
                    generator=torch.Generator().manual_seed(0))
                kw = {} if mesh is None else dict(
                    mesh=mesh, rules=models.bert_sharding_rules(),
                    zero1=True)
                nets.append(net)
                trainers.append(parallel.ShardedTrainer(
                    net, models.bert_pretrain_loss, "adam",
                    {"learning_rate": 1e-4}, device="cuda", n_labels=3,
                    **kw))
            losses, counts = [], None
            for tr in trainers:
                cuda_ops.reset_launches()
                losses.append([float(tr.step(*batch))
                               for _ in range(steps)])
                torch.cuda.synchronize()
                # the count is the mesh trainer's alone
                counts = counts or cuda_ops.launch_counts()
        finally:
            torch.use_deterministic_algorithms(False)
        check(all(tr.last_path == "fused" and tr.last_step_graphs == 1
                  and tr.captures == 1 for tr in trainers),
              "the one-rank mesh trainer did not replay one graph a step")
        ref = dict(nets[1].named_parameters())
        same = all(torch.equal(p, ref[n]) for n, p in
                   nets[0].named_parameters())
        check(losses[0] == losses[1] and same,
              f"one-rank mesh trainer vs mesh-less: losses {losses}, "
              f"weights bitwise {same}")
        check(all(c == 12 * steps for c in counts.values()),
              f"mesh trainer launches {counts}, expected 12 a step")
        print(f"parallel (c): one-rank NCCL group: collectives and the "
              f"nccl store ok; BERT-base mesh trainer vs mesh-less fused, "
              f"{steps} steps: losses {losses[0]} bitwise, weights "
              f"bitwise, launches {counts}", flush=True)
        del nets, trainers
        gc.collect()
        return {"losses": losses[0], "bitwise": True, "launches": counts}
    finally:
        parallel.finalize()


def phase_parallel() -> dict:
    """Phase 29 (module docstring)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    res = {"flash_block": par_flash_block(), "ring": par_ring_schedule(),
           "nccl": par_nccl_trainer()}
    res["launches"] = res["ring"]["launches"]
    res["seconds"] = time.perf_counter() - t0
    print(f"parallel: phase {res['seconds']:.1f} s", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serving requests")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    # cuBLAS's deterministic configuration (32 MiB of workspace, Hopper's
    # default size), read when its first handle is made: the fused-step
    # gate runs under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 GEMMs
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build(list(cuda_ops.KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s wall {built}", flush=True)
    for name in cuda_ops.KERNELS:
        # ptxas reports each template instance: its mangled name, then its
        # spills and registers
        entry = ""
        for line in _build.build_log.get(name, "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill stores" in line or "registers" in line:
                print(f"  {name} {entry[-40:]}: {line.strip()}")

    results = []
    main_rec = phase_kernels(results)
    main_bwd = phase_kernels_bwd(results)
    served = phase_serve(N_REQUESTS, OFFERED_RATE, args.seed)
    model = served.pop("model")
    profiled = phase_profile(model)
    int8_res = phase_int8_serve(model, args.seed)
    del model
    trained = phase_train()
    gate = phase_train_fused_gate()
    grads = phase_train_grads()
    glu = phase_gluon(trained)
    vis = phase_vision()
    nmt_res = phase_nmt(args.seed)
    det_res = phase_detection()
    amp_res = phase_amp()
    nd_res = phase_nd_ops()
    mob_res = phase_mobilenet()
    zoo_res = phase_zoo()
    rest = phase_gluon_rest()
    fault_res = phase_fault()
    data_res = phase_data()
    tier_res = phase_serve_tier(args.seed)
    sym_res = phase_symbol()
    art_res = phase_artifacts(args.seed)
    par_res = phase_parallel()

    def worst(name, dtype):
        return max(r["max_abs_err"] for r in results
                   if r["kernel"] == name and r["dtype"] == dtype)

    sources = {fa.KERNEL: ("flash_attention_fwd.cu", 273),
               fa.KERNEL_BWD_DKV: ("flash_attention_bwd_dkv.cu", 450),
               fa.KERNEL_BWD_DQ: ("flash_attention_bwd_dq.cu", 487)}
    timed = dict(main_bwd, **{fa.KERNEL: main_rec})
    kernels = []
    for name, (src, line) in sources.items():
        rec = timed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"incubator_mxnet_tpu_torch/csrc/{src}",
            "replaces": "incubator_mxnet_tpu/ops/pallas/flash_attention.py:"
                        f"{line}",
            "launches": trained["launches"][name],
            "launches_by_path": {"serve": served["launches"][name],
                                 "train": trained["launches_eager"][name],
                                 "train_fused": trained["launches"][name],
                                 "gluon": glu["launches"][name],
                                 "gluon_hybrid":
                                     glu["launches_hybrid"][name],
                                 "vision": vis["launches"][name],
                                 "nmt_train": nmt_res["train"]["launches"][
                                     name],
                                 "nmt_train_eager": nmt_res["train"][
                                     "launches_eager"][name],
                                 "nmt_serve": nmt_res["serve"]["launches"][
                                     name],
                                 "mt_gate": nmt_res["mt_gate"]["launches"][
                                     name],
                                 "ssd": det_res["ssd"]["launches"][name],
                                 "frcnn": det_res["frcnn"]["launches"][name],
                                 "ssd_example": det_res["ssd_example"][
                                     "launches"][name],
                                 "frcnn_example": det_res["frcnn_example"][
                                     "launches"][name],
                                 "int8_serve": int8_res["launches"][name],
                                 "amp_train": amp_res["bert"]["fused"][
                                     "amp"]["launches"][name],
                                 "amp_train_eager": amp_res["bert"][
                                     "eager"]["amp"]["launches"][name],
                                 "amp_resnet": amp_res["resnet"]["amp"][
                                     "launches"][name],
                                 "amp_example": amp_res["example"][
                                     "launches"][name],
                                 "nd_ops": nd_res["launches"][name],
                                 "mobilenet": mob_res["launches"][name],
                                 "mobilenet_example": mob_res["example"][
                                     "launches"][name],
                                 "zoo": zoo_res["launches"][name],
                                 "lm": rest["lm"]["launches"][name],
                                 "lm_example": rest["examples"][
                                     "lm_example"]["launches"][name],
                                 "dcgan_example": rest["examples"][
                                     "dcgan_example"]["launches"][name],
                                 "optimizers": rest["optimizers"][
                                     "launches"][name],
                                 "fault": fault_res["launches"][name],
                                 "data": data_res["launches"][name],
                                 "serve_tier": tier_res["launches"][name],
                                 "serve_tier_generate": tier_res[
                                     "launches_generate"][name],
                                 "symbol": sym_res["launches"][name],
                                 "artifacts": art_res["launches"][name],
                                 "parallel": par_res["launches"][name],
                                 "parallel_trainer": par_res["nccl"][
                                     "launches"][name]},
            "max_abs_err": worst(name, "float32"),
            "max_abs_err_bf16": worst(name, "bfloat16"),
            "ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "shape": [rec[k] for k in ("B", "H", "Lq", "Lk", "D")],
            "dtype": rec["dtype"],
            "nmt_cross": {k: rec["nmt_cross"][k] for k in (
                "B", "H", "Lq", "Lk", "D", "dtype", "ms", "device_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernel_cases": results,
                       "serve": served, "profile": profiled,
                       "train": trained, "train_fused_gate": gate,
                       "train_gradients": grads,
                       "gluon": glu, "vision": vis, "nmt": nmt_res,
                       "detection": det_res, "int8_serve": int8_res,
                       "amp": amp_res, "nd_ops": nd_res,
                       "mobilenet": mob_res, "zoo": zoo_res,
                       "gluon_rest": rest, "fault": fault_res,
                       "data": data_res, "serve_tier": tier_res,
                       "symbol": sym_res, "artifacts": art_res,
                       "parallel": par_res,
                       "kernels": kernels},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
