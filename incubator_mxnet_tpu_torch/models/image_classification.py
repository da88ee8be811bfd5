"""The image-classification example loop (JAX counterpart:
``examples/image_classification.py:26-95``; reference: GluonCV's
``scripts/classification/imagenet/train_imagenet.py``, scaled down).

A model of the vision zoo by name (``thumbnail`` below 64 pixels),
``Xavier(magnitude=2)``, ``hybridize()``, SGD with momentum through
``gluon.Trainer``, ``SoftmaxCrossEntropyLoss`` and ``metric.Accuracy``,
on a synthetic labeled set (class prototypes plus noise, ``RandomState(0)``;
the iterator shuffles with numpy's global stream, as in the JAX package).
``amp=True`` (``--amp``) calls ``amp.init()`` first: bfloat16 mixed
precision with float32 weights. ``--ckpt-dir`` saves a ``fault``
checkpoint of the trainer after every epoch, as the JAX example does
(``:91-92``); ``--rec`` reads an im2rec ``.rec`` file through
``io.ImageRecordIter`` (shuffled, ``data_shape`` ``(3, S, S)``), as the
JAX example does (``:69-74``). Run on the card::

    python3 -m incubator_mxnet_tpu_torch.models.image_classification \\
        --model resnet18_v1 --epochs 3 --amp
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as onp

__all__ = ["synthetic_iter", "record_iter", "image_classification_example",
           "main"]


def synthetic_iter(batch_size: int, classes: int, size: int, n: int = 512):
    """The example's synthetic set as a shuffling ``io.NDArrayIter`` (JAX
    counterpart: ``examples/image_classification.py:26``)."""
    from ..io import NDArrayIter
    rng = onp.random.RandomState(0)
    protos = rng.rand(classes, 3, size, size).astype("float32")
    y = rng.randint(0, classes, n)
    x = protos[y] + 0.1 * rng.randn(n, 3, size, size).astype("float32")
    return NDArrayIter(x, y.astype("float32"), batch_size=batch_size,
                       shuffle=True)


def record_iter(rec: str, batch_size: int, size: int):
    """The example's ``--rec`` iterator (JAX counterpart:
    ``examples/image_classification.py:69-74``)."""
    from ..io import ImageRecordIter
    return ImageRecordIter(path_imgrec=rec, batch_size=batch_size,
                           data_shape=(3, size, size), shuffle=True)


def image_classification_example(model: str = "resnet18_v1",
                                 classes: int = 8, image_size: int = 32,
                                 epochs: int = 3, batch_size: int = 32,
                                 lr: float = 0.05, rec: Optional[str] = None,
                                 amp: bool = False, kvstore: str = "device",
                                 ckpt_dir: Optional[str] = None,
                                 seed: Optional[int] = None,
                                 ctx=None) -> dict:
    """The example's loop on ``ctx`` (default: the current context).
    Returns ``{"losses": [each step's mean loss], "accuracy": the last
    epoch's training accuracy, "epochs": [each epoch's accuracy],
    "epoch_seconds": [each epoch's wall time]}`` (the accuracy update
    reads every step's output, so an epoch's time includes its device
    work)."""
    from .. import autograd, gluon, initializer, metric, random
    from ..context import current_context
    from ..gluon.model_zoo import vision

    ctx = ctx or current_context()
    random.seed(seed if seed is not None
                else int(os.environ.get("MXNET_TEST_SEED", "42")))
    if amp:
        from .. import amp as amp_mod
        amp_mod.init()

    kwargs = {"classes": classes}
    if model.startswith("resnet"):
        kwargs["thumbnail"] = image_size < 64
    with ctx:
        net = vision.get_model(model, **kwargs)
        net.initialize(initializer.Xavier(magnitude=2.0), ctx=ctx)
        net.hybridize()
        it = record_iter(rec, batch_size, image_size) if rec \
            else synthetic_iter(batch_size, classes, image_size)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": lr, "momentum": 0.9},
                                kvstore=kvstore)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        acc_metric = metric.Accuracy()
        losses, accs, secs = [], [], []
        for _ in range(epochs):
            t0 = time.perf_counter()
            it.reset()
            acc_metric.reset()
            for batch in it:
                with autograd.record():
                    out = net(batch.data[0])
                    loss = loss_fn(out, batch.label[0])
                loss.backward()
                trainer.step(batch_size)
                acc_metric.update(batch.label[0], out)
                losses.append(loss._data.detach().mean())
            if ckpt_dir:
                trainer.save_checkpoint(ckpt_dir)
            accs.append(acc_metric.get()[1])
            secs.append(time.perf_counter() - t0)
    return {"losses": [float(v) for v in losses], "accuracy": accs[-1],
            "epochs": accs, "epoch_seconds": secs}


def main(argv=None) -> float:
    """The example's command line (JAX counterpart:
    ``examples/image_classification.py:35``); prints each epoch's
    accuracy and returns the last."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet18_v1")
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rec", default=None,
                    help="im2rec .rec file (default: a synthetic set)")
    ap.add_argument("--amp", action="store_true", help="bf16 mixed precision")
    ap.add_argument("--kvstore", default="device")
    ap.add_argument("--ckpt-dir", default=None,
                    help="mx.fault checkpoint directory, saved every epoch")
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed; default: MXNET_TEST_SEED or 42")
    args = ap.parse_args(argv)
    out = image_classification_example(
        model=args.model, classes=args.classes, image_size=args.image_size,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        rec=args.rec, amp=args.amp, kvstore=args.kvstore,
        ckpt_dir=args.ckpt_dir, seed=args.seed)
    for epoch, acc in enumerate(out["epochs"]):
        print(f"epoch {epoch}: accuracy={acc:.4f}")
    return out["accuracy"]


if __name__ == "__main__":
    main()
