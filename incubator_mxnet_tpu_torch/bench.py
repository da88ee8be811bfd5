"""Training throughput of the port, on the card: BERT pretraining, or a
ResNet, SSD or Faster-RCNN with ``MXTPU_BENCH_WORKLOAD=resnet``, ``ssd``
or ``frcnn``.

Counterpart: the JAX package's ``bench.py`` and its ``_measure``
(``:205-225``), with the same configurations, seeded numpy batches, FLOP
formulas and JSON keys:

- ``bert`` (the default; ``bench.py:923-981``): ``bert_12_768_12``,
  bfloat16, dropout 0.1, batch 8, sequence 512, 15% of positions masked,
  MLM + NSP heads, ``bert_pretrain_loss``, AdamW at lr 1e-4 with fp32
  master weights;
- ``resnet`` (``bench.py:228-296``, ``run_resnet``): the model zoo's
  ``resnet50_v1`` (or ``MXTPU_BENCH_MODEL``, one of the FLOP table's
  five), 1000 classes, ``Xavier``, ``cast("bfloat16")`` (BatchNorm stays
  float32), ``SoftmaxCrossEntropyLoss``, SGD at lr 0.05 with momentum 0.9
  and fp32 master weights, batch 32 of 224x224 NCHW images
  (``MXTPU_BENCH_BATCH``, ``MXTPU_BENCH_IMG``) drawn from
  ``RandomState(0)`` and cast to bfloat16, FLOPs ``3 * 2 * GMACs * batch``.
  The bench leaves ``torch.backends.cudnn.benchmark`` (the counterpart of
  XLA's autotuning) off, so cuDNN's heuristics pick each convolution's
  algorithm: on an H100 (cuDNN 9.22, PyTorch 2.11) a run of resnet18_v1 in
  float32 at batch 8, 64x64 under ``benchmark`` cached engines that made
  later gradients of stage 4 wrong by up to 15%, though each convolution
  shape alone was accurate (``tools/torch_cudnn_benchmark_probe.py``),
  and it bought no step time on ResNet-50. The record times the first step (the
  trainer's warm-up and eager first step) apart, as
  ``extra.first_step_ms``;
- ``ssd`` (``bench.py:299-342``, ``run_ssd``): ``models.SSD`` with 20
  classes (the VGG-style trunk of filters 32-64-128-128-128, four heads,
  29,596 anchors at 300x300), ``Xavier``, float32, ``SSDTargetLoss``
  (MultiBoxTarget with hard negative mining), SGD at lr 0.01 with
  momentum 0.9, batch 16 of 300x300 images from ``RandomState(0)`` with
  one box each; FLOPs ``3 * 2 * _ssd_gmacs * batch``;
- ``frcnn`` (``bench.py:364-423``, ``run_frcnn``): ``models.FasterRCNN``
  with 20 classes, scales (4, 8, 16), ratios (0.5, 1, 2), stride 8, RPN
  top 1000 before and 128 after NMS, min size 4, backbone 32-64-128,
  ``output_rpn``; ``FasterRCNNTargetLoss``; SGD at lr 0.01 with momentum
  0.9; batch 8 of 224x224 images with up to 4 gt boxes each from
  ``RandomState(0)``, the inputs ``(x, im_info, gt, gt, im_info)``; FLOPs
  ``3 * 2 * _frcnn_gmacs * batch``.

The trainer takes its fused step on the card (one CUDA-graph replay per
step) unless ``MXTPU_FUSED_STEP=0``. Knobs: ``MXTPU_BENCH_WORKLOAD``,
``MXTPU_BENCH_MODEL``, ``MXTPU_BENCH_BATCH``, ``MXTPU_BENCH_SEQ``,
``MXTPU_BENCH_IMG``, ``MXTPU_BENCH_STEPS``, ``MXTPU_BENCH_DROPOUT``,
``MXTPU_FUSED_STEP`` and ``MXTPU_PEAK_TFLOPS``. Run on the card from the
root of a checkout::

    python3 -m incubator_mxnet_tpu_torch.bench
    MXTPU_BENCH_WORKLOAD=resnet python3 -m incubator_mxnet_tpu_torch.bench
    MXTPU_BENCH_WORKLOAD=ssd python3 -m incubator_mxnet_tpu_torch.bench
    MXTPU_BENCH_WORKLOAD=frcnn python3 -m incubator_mxnet_tpu_torch.bench

It prints one JSON line. It runs on the card and raises without one;
``run(device="cpu")``, ``run_resnet(device="cpu")`` and
``run_detection("ssd", device="cpu")`` drive the same code on the CPU for
tests.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as onp
import torch

from . import gluon, initializer, models, random
from .context import Context, resolve_device
from .parallel import ShardedTrainer
from .util import getenv, peak_tflops

__all__ = ["make_batch", "build", "measure", "result", "run",
           "make_image_batch", "build_resnet", "resnet_result",
           "run_resnet", "build_ssd", "build_frcnn", "detection_result",
           "run_detection", "main"]

VOCAB = 30522
#: fwd GMACs per image at 224x224 (``bench.py:198-200``); FLOPs = 2x MACs,
#: a train step ~ 3x the forward, the spatial cost scales with (img/224)^2
RESNET_FWD_GMACS_224 = {"resnet18_v1": 1.82, "resnet34_v1": 3.67,
                        "resnet50_v1": 3.87, "resnet101_v1": 7.58,
                        "resnet50_v2": 4.10}
#: the knobs whose default depends on the workload (``bench.py:54``)
_WORKLOAD_DEFAULTS = {
    "resnet": {"MXTPU_BENCH_MODEL": "resnet50_v1", "MXTPU_BENCH_BATCH": "32",
               "MXTPU_BENCH_IMG": "224"},
    "ssd": {"MXTPU_BENCH_BATCH": "16", "MXTPU_BENCH_IMG": "300"},
    "frcnn": {"MXTPU_BENCH_BATCH": "8", "MXTPU_BENCH_IMG": "224"},
}
#: the detection workloads' classes (``bench.py:315``, ``:382``)
DETECTION_CLASSES = 20
#: Faster-RCNN's rois per image after NMS (``bench.py:383``)
FRCNN_ROIS = 128


def make_batch(B: int, L: int, vocab: int = VOCAB) -> tuple:
    """The bench's batch: ``(ids, token_types, valid_length,
    masked_positions, mlm_labels, mlm_weights, nsp_labels)`` as numpy
    arrays, drawn from seed 0 in ``bench.py``'s order
    (``bench.py:951-959``)."""
    P = max(1, round(0.15 * L))      # BERT's 15% masking rate
    rng = onp.random.RandomState(0)
    ids = rng.randint(0, vocab, (B, L)).astype("int32")
    tt = rng.randint(0, 2, (B, L)).astype("int32")
    vl = onp.full((B,), L, "float32")
    pos = rng.randint(0, L, (B, P)).astype("int32")
    mlm_lab = rng.randint(0, vocab, (B, P)).astype("float32")
    mlm_w = onp.ones((B, P), "float32")
    nsp = rng.randint(0, 2, (B,)).astype("float32")
    return ids, tt, vl, pos, mlm_lab, mlm_w, nsp


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(trainer: ShardedTrainer, batch: tuple, steps: int,
            timings: Optional[dict] = None) -> tuple:
    """``bench.py``'s protocol (``_measure``): a first step (set-up), the
    batch placed on the device, a warm step, then ``steps`` timed steps
    with one synchronize at the end. Returns ``(seconds per step, every
    step's loss)``; the losses are device scalars, read after the timing.
    A fused trainer runs its first step eagerly and captures its graph on
    the warm step, so the timed steps are replays. ``timings``, when
    given, receives ``first_step_s`` and ``warm_step_s``."""
    t0 = time.perf_counter()
    losses = [trainer.step(*batch)]
    _sync(trainer.device)
    t1 = time.perf_counter()
    batch = trainer.place(*batch)
    t2 = time.perf_counter()
    losses.append(trainer.step(*batch))
    _sync(trainer.device)
    if timings is not None:
        timings["first_step_s"] = t1 - t0
        timings["warm_step_s"] = time.perf_counter() - t2
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.step(*batch))
    _sync(trainer.device)
    return (time.perf_counter() - t0) / steps, losses


def build(device=None, fused: Optional[bool] = None) -> tuple:
    """The bench's model, trainer and batch on ``device`` (default: the
    card): ``(trainer, batch, info)``, ``info`` holding what
    :func:`result` needs (model name and config, batch, sequence, device,
    parameter count). ``fused`` is ``ShardedTrainer``'s."""
    dev = resolve_device(device)
    model_name = getenv("MXTPU_BENCH_MODEL")
    B = int(getenv("MXTPU_BENCH_BATCH"))
    L = int(getenv("MXTPU_BENCH_SEQ"))
    dropout = float(getenv("MXTPU_BENCH_DROPOUT"))
    net = models.get_bert(model_name, vocab_size=VOCAB, max_length=L,
                          dropout=dropout, dtype="bfloat16", device=dev,
                          generator=torch.Generator().manual_seed(0))
    trainer = ShardedTrainer(net, models.bert_pretrain_loss, "adamw",
                             {"learning_rate": 1e-4,
                              "multi_precision": True},
                             device=dev, n_labels=3, fused=fused)
    info = {"model": model_name, "cfg": models.BERT_CONFIGS[model_name],
            "batch": B, "seq": L, "device": dev,
            "params": sum(p.numel() for p in net.parameters())}
    return trainer, make_batch(B, L), info


def result(info: dict, dt: float, losses) -> dict:
    """``bench.py``'s result record (``bench.py:963-980``) for ``dt``
    seconds per step, ending at ``losses[-1]``."""
    B, L, cfg = info["batch"], info["seq"], info["cfg"]
    tokens_per_sec = B * L / dt
    # 6 * n_params * n_tokens for the matmuls plus 12 * layers * units *
    # L^2 * B for attention (fwd + bwd): bench.py:967-970
    flops = (6 * info["params"] * B * L
             + 12 * cfg["num_layers"] * cfg["units"] * L * L * B)
    mfu = (flops / dt) / (peak_tflops() * 1e12)
    return {
        "metric": f"{info['model']}_pretrain_tokens_per_sec_per_chip",
        "value": round(tokens_per_sec, 1),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(mfu / 0.40, 4),
        "extra": {"step_ms": round(dt * 1e3, 2), "mfu": round(mfu, 4),
                  "batch": B, "seq": L, "remat": False,
                  "params": info["params"], "backend": info["device"].type,
                  "loss": float(losses[-1])},
    }


def run(device=None, steps: Optional[int] = None) -> tuple:
    """Build, train and time the bench on ``device`` (default: the card).
    Returns ``(record, losses)``: ``bench.py``'s result record and every
    step's loss as floats."""
    steps = int(getenv("MXTPU_BENCH_STEPS")) if steps is None else steps
    trainer, batch, info = build(device)
    dt, losses = measure(trainer, batch, steps)
    losses = [float(x) for x in losses]
    return result(info, dt, losses), losses


def _knob(workload: str, name: str) -> str:
    return os.environ.get(name) or _WORKLOAD_DEFAULTS[workload][name]


def make_image_batch(B: int, img: int, classes: int = 1000) -> tuple:
    """``run_resnet``'s batch: ``(images, labels)``, NCHW float32 images
    from ``RandomState(0)`` cast to bfloat16 (a CPU tensor: numpy has no
    bfloat16) and float32 class labels (``bench.py:262-264``)."""
    rng = onp.random.RandomState(0)
    x = rng.randn(B, 3, img, img).astype(onp.float32)
    y = rng.randint(0, classes, (B,)).astype("float32")
    return torch.from_numpy(x).to(torch.bfloat16), y


def build_resnet(device=None, fused: Optional[bool] = None) -> tuple:
    """``run_resnet``'s model, trainer and batch on ``device`` (default:
    the card): ``(trainer, batch, info)``. The net's shapes are deferred:
    the trainer's first step initialises it (``Xavier`` from seed 0)."""
    dev = resolve_device(device)
    model_name = _knob("resnet", "MXTPU_BENCH_MODEL")
    if model_name not in RESNET_FWD_GMACS_224:     # before any device work
        raise SystemExit(
            f"MXTPU_BENCH_MODEL={model_name!r} has no FLOP table entry; "
            f"choose one of {sorted(RESNET_FWD_GMACS_224)}")
    B = int(_knob("resnet", "MXTPU_BENCH_BATCH"))
    img = int(_knob("resnet", "MXTPU_BENCH_IMG"))
    classes = 1000
    net = gluon.model_zoo.vision.get_model(model_name, classes=classes)
    net.initialize(initializer.Xavier(
        generator=torch.Generator().manual_seed(0)),
        ctx=Context.from_device(dev))
    net.cast("bfloat16")
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = ShardedTrainer(
        net, lambda out, label: ce(out, label), "sgd",
        {"learning_rate": 0.05, "momentum": 0.9, "multi_precision": True},
        device=dev, n_labels=1, fused=fused)
    info = {"model": model_name, "batch": B, "img": img, "device": dev,
            "net": net}
    return trainer, make_image_batch(B, img, classes), info


def resnet_result(info: dict, dt: float, losses,
                  first_step_s: Optional[float] = None) -> dict:
    """``run_resnet``'s record (``bench.py:266-296``) for ``dt`` seconds
    per step, ending at ``losses[-1]``; ``backend`` names the card."""
    B, img, name = info["batch"], info["img"], info["model"]
    fwd_gmacs = RESNET_FWD_GMACS_224[name] * (img / 224.0) ** 2
    flops = 3.0 * 2.0 * fwd_gmacs * 1e9 * B   # train = 3x fwd, FLOP = 2 MAC
    mfu = (flops / dt) / (peak_tflops() * 1e12)
    dev = info["device"]
    extra = {"step_ms": round(dt * 1e3, 2), "mfu": round(mfu, 4),
             "batch": B, "img": img,
             "backend": torch.cuda.get_device_name(dev)
             if dev.type == "cuda" else dev.type,
             "loss": float(losses[-1])}
    if first_step_s is not None:
        extra["first_step_ms"] = round(first_step_s * 1e3, 2)
    return {"metric": f"{name}_train_imgs_per_sec_per_chip",
            "value": round(B / dt, 2), "unit": "imgs/sec/chip",
            "vs_baseline": round(mfu / 0.40, 4), "extra": extra}


def run_resnet(device=None, steps: Optional[int] = None) -> tuple:
    """Build, train and time the ResNet workload on ``device`` (default:
    the card). Returns ``(record, losses)``."""
    steps = int(getenv("MXTPU_BENCH_STEPS")) if steps is None else steps
    trainer, batch, info = build_resnet(device)
    timings = {}
    dt, losses = measure(trainer, batch, steps, timings)
    losses = [float(x) for x in losses]
    return resnet_result(info, dt, losses, timings["first_step_s"]), losses


def _ssd_gmacs(img: int, num_classes: int,
               filters=(32, 64, 128, 128, 128),
               anchors_per_pos: int = 4) -> float:
    """Analytic forward GMACs of ``models.SSD`` (``bench.py:280-296``): two
    3x3 convolutions per trunk scale, the class and box heads on every
    scale but the stem."""
    macs = 0.0
    cin, s = 3, img
    feats = []
    for f in filters:
        macs += 9 * cin * f * s * s + 9 * f * f * s * s
        s //= 2
        feats.append((f, s))
        cin = f
    for f, sp in feats[1:]:
        macs += 9 * f * (anchors_per_pos * (num_classes + 1)) * sp * sp
        macs += 9 * f * (anchors_per_pos * 4) * sp * sp
    return macs / 1e9


def _frcnn_gmacs(img: int, filters=(32, 64, 128), A: int = 9, R: int = 128,
                 num_classes: int = 20, roi: int = 7,
                 head: int = 128) -> float:
    """Analytic forward GMACs of ``models.FasterRCNN`` (``bench.py:345-361``):
    one 3x3 convolution per backbone scale, the RPN's 3x3 convolution and
    1x1 heads, the per-roi dense head over the ROIAlign crop."""
    macs = 0.0
    cin, s = 3, img
    for f in filters:
        macs += 9 * cin * f * s * s
        s //= 2
        cin = f
    f = filters[-1]
    macs += 9 * f * f * s * s
    macs += f * (2 * A + 4 * A) * s * s
    C1 = num_classes + 1
    macs += R * (f * roi * roi * head + head * C1 + head * 4 * C1)
    return macs / 1e9


def _sgd_trainer(net, loss_fn, dev, n_labels, fused):
    return ShardedTrainer(net, loss_fn, "sgd",
                          {"learning_rate": 0.01, "momentum": 0.9},
                          device=dev, n_labels=n_labels, fused=fused)


def _seeded_init(net, dev, *example) -> None:
    """``Xavier`` and the layers' own initializers (the RPN's and heads'
    ``Normal``), all drawn from the CPU stream seeded with 0 by a forward
    on ``example`` (numpy arrays), so every build has the same weights
    whichever net takes its first step first."""
    random.seed(0)
    net.initialize(initializer.Xavier(), ctx=Context.from_device(dev))
    with torch.no_grad():
        net(*(torch.from_numpy(a[:1]).to(dev) for a in example))


def build_ssd(device=None, fused: Optional[bool] = None) -> tuple:
    """``run_ssd``'s model, trainer and batch on ``device`` (default: the
    card): ``(trainer, (images, labels), info)`` (``bench.py:310-330``)."""
    dev = resolve_device(device)
    B = int(_knob("ssd", "MXTPU_BENCH_BATCH"))
    img = int(_knob("ssd", "MXTPU_BENCH_IMG"))
    classes = DETECTION_CLASSES
    net = models.SSD(num_classes=classes)
    loss = models.SSDTargetLoss()
    trainer = _sgd_trainer(
        net, lambda out, label: loss(out[0], out[1], out[2], label), dev, 1,
        fused)
    rng = onp.random.RandomState(0)
    x = rng.rand(B, 3, img, img).astype(onp.float32)
    lab = onp.zeros((B, 1, 5), onp.float32)
    lab[:, 0, 0] = rng.randint(0, classes, B)
    lab[:, 0, 1:3] = 0.2
    lab[:, 0, 3:5] = 0.7
    _seeded_init(net, dev, x)
    info = {"workload": "ssd", "batch": B, "img": img, "device": dev,
            "net": net,
            "gmacs": _ssd_gmacs(img, classes)}
    return trainer, (x, lab), info


def build_frcnn(device=None, fused: Optional[bool] = None) -> tuple:
    """``run_frcnn``'s model, trainer and batch on ``device`` (default: the
    card): ``(trainer, (x, info, gt, gt, info), info)``
    (``bench.py:377-408``)."""
    dev = resolve_device(device)
    B = int(_knob("frcnn", "MXTPU_BENCH_BATCH"))
    img = int(_knob("frcnn", "MXTPU_BENCH_IMG"))
    classes, R = DETECTION_CLASSES, FRCNN_ROIS
    net = models.FasterRCNN(
        num_classes=classes, scales=(4, 8, 16), ratios=(0.5, 1, 2),
        feature_stride=8, rpn_pre_nms_top_n=1000, rpn_post_nms_top_n=R,
        rpn_min_size=4, backbone_filters=(32, 64, 128), output_rpn=True)
    loss = models.FasterRCNNTargetLoss(
        num_classes=classes, scales=(4, 8, 16), ratios=(0.5, 1, 2),
        feature_stride=8)
    trainer = _sgd_trainer(
        net, lambda out, gt, im_info: loss(out[0], out[1], out[2], out[3],
                                           out[4], gt, im_info), dev, 2,
        fused)
    rng = onp.random.RandomState(0)
    x = rng.rand(B, 3, img, img).astype(onp.float32)
    gt = onp.full((B, 4, 5), -1.0, onp.float32)     # up to 4 boxes, padded
    for b in range(B):
        for m in range(rng.randint(1, 5)):
            w, h = rng.randint(img // 4, img // 2 + 1, 2)
            x0 = rng.randint(0, img - w)
            y0 = rng.randint(0, img - h)
            gt[b, m] = [rng.randint(0, classes), x0, y0,
                        x0 + w - 1, y0 + h - 1]
    im_info = onp.tile([img, img, 1.0], (B, 1)).astype(onp.float32)
    _seeded_init(net, dev, x, im_info)
    info = {"workload": "frcnn", "batch": B, "img": img, "device": dev,
            "net": net, "rois": R,
            "gmacs": _frcnn_gmacs(img, A=9, R=R + gt.shape[1],
                                  num_classes=classes)}
    return trainer, (x, im_info, gt, gt, im_info), info


def detection_result(info: dict, dt: float, losses,
                     first_step_s: Optional[float] = None) -> dict:
    """``run_ssd``'s or ``run_frcnn``'s record (``bench.py:332-342``,
    ``:410-423``) for ``dt`` seconds per step, ending at ``losses[-1]``;
    ``backend`` names the card."""
    B, img = info["batch"], info["img"]
    flops = 3.0 * 2.0 * info["gmacs"] * 1e9 * B
    mfu = (flops / dt) / (peak_tflops() * 1e12)
    dev = info["device"]
    extra = {"step_ms": round(dt * 1e3, 2), "mfu": round(mfu, 4),
             "batch": B, "img": img}
    if "rois" in info:
        extra["rois"] = info["rois"]
    extra.update(backend=torch.cuda.get_device_name(dev)
                 if dev.type == "cuda" else dev.type,
                 loss=float(losses[-1]))
    if first_step_s is not None:
        extra["first_step_ms"] = round(first_step_s * 1e3, 2)
    metric = {"ssd": "ssd300", "frcnn": "frcnn"}[info["workload"]]
    return {"metric": f"{metric}_train_imgs_per_sec_per_chip",
            "value": round(B / dt, 2), "unit": "imgs/sec/chip",
            "vs_baseline": round(mfu / 0.40, 4), "extra": extra}


def run_detection(workload: str, device=None,
                  steps: Optional[int] = None) -> tuple:
    """Build, train and time the ``ssd`` or ``frcnn`` workload on
    ``device`` (default: the card). Returns ``(record, losses)``."""
    steps = int(getenv("MXTPU_BENCH_STEPS")) if steps is None else steps
    build = {"ssd": build_ssd, "frcnn": build_frcnn}[workload]
    trainer, batch, info = build(device)
    timings = {}
    dt, losses = measure(trainer, batch, steps, timings)
    losses = [float(x) for x in losses]
    return detection_result(info, dt, losses,
                            timings["first_step_s"]), losses


def main() -> None:
    workload = getenv("MXTPU_BENCH_WORKLOAD")
    if workload == "resnet":
        print(json.dumps(run_resnet()[0]))
    elif workload in ("ssd", "frcnn"):
        print(json.dumps(run_detection(workload)[0]))
    elif workload == "bert":
        print(json.dumps(run()[0]))
    else:
        raise SystemExit(f"MXTPU_BENCH_WORKLOAD={workload!r}: choose bert, "
                         "resnet, ssd or frcnn")


if __name__ == "__main__":
    main()
