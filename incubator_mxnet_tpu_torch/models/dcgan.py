"""The DCGAN example loop (JAX counterpart: ``examples/dcgan.py``;
reference: ``example/gluon/dcgan.py``, scaled down).

A generator of ``Conv2DTranspose``/BatchNorm/ReLU doublings from a
projected latent to 16x16 images, against a discriminator of strided
convolutions and ``LeakyReLU(0.2)`` whose logits feed
``SigmoidBinaryCrossEntropyLoss``; two Adam trainers. The "images" are
synthetic discs of random radius and brightness (``RandomState(11)``);
success is the generator matching the real data's first moments.
``--ckpt-dir`` saves both trainers' ``fault`` checkpoints (``D/``, ``G/``)
every 50 steps and at the last, as the JAX example does (``:121-123``).
Run on the card::

    python3 -m incubator_mxnet_tpu_torch.models.dcgan --steps 300
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as onp


__all__ = ["build_generator", "build_discriminator", "real_batch",
           "dcgan_example", "main"]


def build_generator(latent: int):
    """Dense -> (32, 4, 4) -> BatchNorm/ReLU -> two transposed
    convolutions to (1, 16, 16), tanh (JAX counterpart: ``:25``)."""
    from ..gluon import nn
    net = nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        net.add(nn.Dense(4 * 4 * 32, in_units=latent))
        net.add(nn.HybridLambda(lambda F, x: x.reshape((-1, 32, 4, 4))))
        net.add(nn.BatchNorm(in_channels=32))
        net.add(nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(16, 4, strides=(2, 2), padding=(1, 1),
                                   in_channels=32, use_bias=False))
        net.add(nn.BatchNorm(in_channels=16))
        net.add(nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(1, 4, strides=(2, 2), padding=(1, 1),
                                   in_channels=16))
        net.add(nn.Activation("tanh"))
    return net


def build_discriminator():
    """Two strided convolutions with ``LeakyReLU(0.2)`` and a Dense logit
    (JAX counterpart: ``:44``)."""
    from ..gluon import nn
    net = nn.HybridSequential(prefix="disc_")
    with net.name_scope():
        net.add(nn.Conv2D(16, 4, strides=(2, 2), padding=(1, 1),
                          in_channels=1))
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(32, 4, strides=(2, 2), padding=(1, 1),
                          in_channels=16, use_bias=False))
        net.add(nn.BatchNorm(in_channels=32))
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Dense(1, in_units=32 * 4 * 4))
    return net


def real_batch(rng, n: int, size: int = 16) -> onp.ndarray:
    """Discs of varying radius and brightness on a dark field, in [-1, 1],
    NCHW (JAX counterpart: ``:60``)."""
    yy, xx = onp.mgrid[:size, :size]
    d2 = (yy - size / 2 + 0.5) ** 2 + (xx - size / 2 + 0.5) ** 2
    radius = rng.uniform(3.0, 6.0, (n, 1, 1))
    bright = rng.uniform(0.6, 1.0, (n, 1, 1))
    img = onp.where(d2[None] <= radius ** 2, bright, -0.9)
    return img[:, None].astype("float32")


def dcgan_example(latent: int = 32, batch_size: int = 32, steps: int = 200,
                  lr: float = 2e-4, beta1: float = 0.5,
                  ckpt_dir: Optional[str] = None,
                  params_g: Optional[str] = None,
                  params_d: Optional[str] = None, ctx=None) -> dict:
    """The example's loop on ``ctx`` (default: the current context);
    ``params_g``/``params_d`` name ``.params`` files to start the two nets
    from (``Normal(0.02)`` otherwise). Returns the example's moments
    (``fake_mean``, ``real_mean``, ``fake_std``, ``real_std``,
    ``d_acc_tail``) and each step's ``lossD`` and ``lossG``."""
    from .. import autograd, gluon, initializer, random
    from .. import ndarray as nd
    from ..context import current_context

    ctx = ctx or current_context()
    random.seed(int(os.environ.get("MXNET_TEST_SEED", "11")))
    rng = onp.random.RandomState(11)
    with ctx:
        netG, netD = build_generator(latent), build_discriminator()
        netG.initialize(initializer.Normal(0.02), ctx=ctx)
        netD.initialize(initializer.Normal(0.02), ctx=ctx)
        if params_g is not None:
            netG.load_parameters(params_g, ctx=ctx)
        if params_d is not None:
            netD.load_parameters(params_d, ctx=ctx)
        opts = {"learning_rate": lr, "beta1": beta1}
        trainerG = gluon.Trainer(netG.collect_params(), "adam", opts)
        trainerD = gluon.Trainer(netD.collect_params(), "adam", opts)
        loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
        B = batch_size
        ones = nd.array(onp.ones((B, 1), "float32"), ctx=ctx)
        zeros = nd.array(onp.zeros((B, 1), "float32"), ctx=ctx)
        d_acc, lossesD, lossesG = [], [], []
        for step in range(steps):
            real = nd.array(real_batch(rng, B), ctx=ctx)
            z = nd.array(rng.randn(B, latent).astype("float32"), ctx=ctx)
            with autograd.record():
                fake = netG(z).detach()
                out_real = netD(real)
                out_fake = netD(fake)
                lossD = (loss_fn(out_real, ones)
                         + loss_fn(out_fake, zeros)).mean()
            lossD.backward()
            trainerD.step(1)
            z = nd.array(rng.randn(B, latent).astype("float32"), ctx=ctx)
            with autograd.record():
                lossG = loss_fn(netD(netG(z)), ones).mean()
            lossG.backward()
            trainerG.step(1)
            pr = 1.0 / (1.0 + onp.exp(-out_real.asnumpy()))
            pf = 1.0 / (1.0 + onp.exp(-out_fake.asnumpy()))
            d_acc.append(((pr > 0.5).mean() + (pf < 0.5).mean()) / 2)
            if ckpt_dir and (step % 50 == 0 or step == steps - 1):
                trainerD.save_checkpoint(os.path.join(ckpt_dir, "D"))
                trainerG.save_checkpoint(os.path.join(ckpt_dir, "G"))
            lossesD.append(float(lossD.asnumpy()))
            lossesG.append(float(lossG.asnumpy()))
        z = nd.array(rng.randn(256, latent).astype("float32"), ctx=ctx)
        with autograd.predict_mode():
            fakes = netG(z).asnumpy()
    reals = real_batch(rng, 256)
    return {"fake_mean": float(fakes.mean()), "real_mean": float(reals.mean()),
            "fake_std": float(fakes.std()), "real_std": float(reals.std()),
            "d_acc_tail": float(onp.mean(d_acc[-20:])),
            "lossD": lossesD, "lossG": lossesG}


def main(argv=None) -> dict:
    """The example's command line (JAX counterpart: ``:70``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--latent", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--beta1", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default=None,
                    help="mx.fault checkpoint root (D/ and G/), saved "
                         "every 50 steps and at the last")
    args = ap.parse_args(argv)
    stats = dcgan_example(latent=args.latent, batch_size=args.batch_size,
                          steps=args.steps, lr=args.lr, beta1=args.beta1,
                          ckpt_dir=args.ckpt_dir)
    print({k: round(v, 3) for k, v in stats.items()
           if not isinstance(v, list)})
    return stats


if __name__ == "__main__":
    main()
