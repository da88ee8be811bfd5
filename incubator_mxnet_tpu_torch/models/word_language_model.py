"""The word language model example loop (JAX counterpart:
``examples/word_language_model.py``; reference: ``example/rnn/word_lm``,
the PTB recipe).

``RNNModel``: Embedding -> multi-layer ``gluon.rnn.LSTM`` -> a decoder
tied to the embedding weight (``nn.Dense(..., params=encoder.params)``:
one parameter, updated once a step). :func:`lm_example` trains it by
truncated BPTT (the states carried between chunks, detached),
``clip_global_norm`` on every step's gradients and SGD through
``gluon.Trainer``, with the rate quartered when an epoch's perplexity
does not fall, on the example's synthetic corpus: a Markov chain that
steps ``(3 * cur + 7) % vocab`` with probability 0.9, else uniformly
(perplexity floor ~2.1 at vocab 50; PTB is not in the repo and is not
fetched). ``--ckpt-dir`` saves a ``fault`` checkpoint of the trainer
after every epoch, as the JAX example does (``:142-143``). Run on the
card::

    python3 -m incubator_mxnet_tpu_torch.models.word_language_model \\
        --steps 40 --epochs 2
"""
from __future__ import annotations

import argparse
import math
import os
from typing import Optional

import numpy as onp

from ..gluon.block import Block

__all__ = ["RNNModel", "make_corpus", "batchify", "lm_example", "main"]


class RNNModel(Block):
    """Embedding -> LSTM -> (tied) decoder over ``(T, N)`` token ids
    (JAX counterpart: ``examples/word_language_model.py:27``)."""

    def __init__(self, vocab_size, embed_size, hidden_size, num_layers,
                 dropout=0.2, tied=True, **kwargs):
        from ..gluon import nn, rnn
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, embed_size)
            self.rnn = rnn.LSTM(hidden_size, num_layers, layout="TNC",
                                dropout=dropout, input_size=embed_size)
            if tied:
                if hidden_size != embed_size:
                    raise ValueError("tied weights need hidden == embed size")
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        in_units=hidden_size,
                                        params=self.encoder.params)
            else:
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        in_units=hidden_size)

    def forward(self, inputs, states):
        emb = self.drop(self.encoder(inputs))
        out, states = self.rnn(emb, states)
        return self.decoder(self.drop(out)), states

    def begin_state(self, batch_size, **kwargs):
        return self.rnn.begin_state(batch_size, **kwargs)


def make_corpus(length: int, vocab: int, rng) -> onp.ndarray:
    """The example's Markov chain: next = ``(3 * cur + 7) % vocab`` with
    probability 0.9, else uniform (JAX counterpart: ``:64``)."""
    toks = onp.empty(length, "int32")
    toks[0] = rng.randint(vocab)
    jumps = rng.rand(length) < 0.1
    noise = rng.randint(0, vocab, length)
    for i in range(1, length):
        toks[i] = noise[i] if jumps[i] else (3 * toks[i - 1] + 7) % vocab
    return toks


def batchify(data: onp.ndarray, batch_size: int) -> onp.ndarray:
    """``(T, N)`` columns of the corpus (JAX counterpart: ``:76``)."""
    nbatch = len(data) // batch_size
    return data[:nbatch * batch_size].reshape(batch_size, nbatch).T


def lm_example(vocab: int = 50, emsize: int = 64, nhid: int = 64,
               nlayers: int = 2, bptt: int = 16, batch_size: int = 32,
               steps: int = 60, epochs: int = 3, lr: float = 5.0,
               clip: float = 0.25, dropout: float = 0.1, tied: bool = True,
               ckpt_dir: Optional[str] = None, seed: Optional[int] = None,
               params: Optional[str] = None, ctx=None) -> dict:
    """The example's loop on ``ctx`` (default: the current context).
    ``params`` names a ``.params`` file to start from (the model is
    initialised with ``Xavier`` otherwise). Returns ``{"ppl": the last
    epoch's training perplexity, "epoch_ppl": each epoch's, "losses":
    each step's mean loss, "lr": the final rate}``."""
    from .. import autograd, gluon, initializer, random
    from .. import ndarray as nd
    from ..context import current_context

    ctx = ctx or current_context()
    random.seed(seed if seed is not None
                else int(os.environ.get("MXNET_TEST_SEED", "42")))
    rng = onp.random.RandomState(7)
    corpus = batchify(make_corpus((steps * bptt + 1) * batch_size + 1,
                                  vocab, rng), batch_size)
    with ctx:
        model = RNNModel(vocab, emsize, nhid, nlayers, dropout=dropout,
                         tied=tied)
        model.initialize(initializer.Xavier(), ctx=ctx)
        if params is not None:
            model.load_parameters(params, ctx=ctx)
        trainer = gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": lr})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        grads_of = [p for p in model.collect_params().values()
                    if p.grad_req != "null"]
        prev_ppl, epoch_ppl, losses = float("inf"), [], []
        for _ in range(epochs):
            states = model.begin_state(batch_size, ctx=ctx)
            total_nll, total_tok = 0.0, 0
            for step in range(steps):
                lo = step * bptt
                data = nd.array(corpus[lo:lo + bptt], ctx=ctx)
                target = nd.array(corpus[lo + 1:lo + 1 + bptt].reshape(-1)
                                  .astype("float32"), ctx=ctx)
                states = [s.detach() for s in states]
                with autograd.record():
                    logits, states = model(data, states)
                    loss = loss_fn(logits.reshape((-1, vocab)),
                                   target).mean()
                loss.backward()
                gluon.utils.clip_global_norm([p.grad() for p in grads_of],
                                             clip)
                trainer.step(1)
                value = float(loss.asnumpy())
                losses.append(value)
                total_nll += value * data.shape[0] * data.shape[1]
                total_tok += data.shape[0] * data.shape[1]
            ppl = math.exp(total_nll / total_tok)
            epoch_ppl.append(ppl)
            if ckpt_dir:
                trainer.save_checkpoint(ckpt_dir)
            if ppl > prev_ppl:            # anneal the rate on a plateau
                trainer.set_learning_rate(trainer.learning_rate / 4.0)
            prev_ppl = ppl
    return {"ppl": epoch_ppl[-1], "epoch_ppl": epoch_ppl, "losses": losses,
            "lr": trainer.learning_rate}


def main(argv=None) -> float:
    """The example's command line (JAX counterpart: ``:83``); prints each
    epoch's perplexity and returns the last."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=50)
    ap.add_argument("--emsize", type=int, default=64)
    ap.add_argument("--nhid", type=int, default=64)
    ap.add_argument("--nlayers", type=int, default=2)
    ap.add_argument("--bptt", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=60,
                    help="BPTT chunks per epoch")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=5.0)
    ap.add_argument("--clip", type=float, default=0.25)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--no-tied", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="mx.fault checkpoint directory, saved every epoch")
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed; default: MXNET_TEST_SEED or 42")
    args = ap.parse_args(argv)
    out = lm_example(
        vocab=args.vocab, emsize=args.emsize, nhid=args.nhid,
        nlayers=args.nlayers, bptt=args.bptt, batch_size=args.batch_size,
        steps=args.steps, epochs=args.epochs, lr=args.lr, clip=args.clip,
        dropout=args.dropout, tied=not args.no_tied, ckpt_dir=args.ckpt_dir,
        seed=args.seed)
    for epoch, ppl in enumerate(out["epoch_ppl"]):
        print(f"epoch {epoch}  train ppl {ppl:.2f}")
    return out["ppl"]


if __name__ == "__main__":
    main()
