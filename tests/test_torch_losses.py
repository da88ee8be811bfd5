"""PyTorch port: the sixteen Gluon losses and the ``CTCLoss`` op, held
against the JAX package on the CPU.

- Every loss of ``gluon.loss`` (and each alias) on seeded inputs with
  ``weight``, ``sample_weight``, its options (``from_sigmoid``,
  ``pos_weight``, ``from_logits``, ``label_format``, ``compute_full``,
  ``margin``, ``rho``, ``smoothing_parameter``, layouts): values within
  1e-5 of the largest, and the gradient of their sum with respect to the
  prediction within 1e-5. The JAX references of the whole table are one
  jitted program.
- The ``CTCLoss``/``ctc_loss`` op (``mx.nd``): both blank conventions,
  -1 padding, data and label lengths, and a label too long for its data
  (the JAX convention: "impossible" is -1e30, so that loss is 1e30):
  losses within 1e-5 relative, gradients of the feasible losses within
  1e-5 of the largest; on feasible inputs also against
  ``torch.nn.functional.ctc_loss`` (another algorithm) within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon import loss as jloss
from incubator_mxnet_tpu.ops import nn as jnn
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.gluon import loss as ploss

TOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _cases():
    """(label, class name, constructor kwargs, inputs): the first input
    is the one differentiated."""
    rng = onp.random.RandomState(0)

    def r(*s, lo=None, hi=None):
        if lo is not None:
            return rng.uniform(lo, hi, s).astype("float32")
        return rng.randn(*s).astype("float32")

    sw = r(4, 1, lo=0.5, hi=1.5)
    binary = (rng.rand(4, 3) > 0.5).astype("float32")
    signed = 2 * binary - 1
    probs = onp.exp(r(4, 5))
    probs = (probs / probs.sum(-1, keepdims=True)).astype("float32")
    sparse = rng.randint(0, 5, (4,)).astype("float32")
    cases = [
        ("L2", "L2Loss", {}, [r(4, 3), r(4, 3)]),
        ("L2 weighted", "L2Loss", dict(weight=0.7), [r(4, 3), r(4, 3), sw]),
        ("L1", "L1Loss", {}, [r(4, 3), r(4, 3), sw]),
        ("SigmoidBCE", "SigmoidBinaryCrossEntropyLoss", {},
         [r(4, 3), binary]),
        ("SigmoidBCE pos_weight", "SigmoidBCELoss", dict(weight=2.0),
         [r(4, 3), binary, sw, r(4, 3, lo=0.5, hi=3.0)]),
        ("SigmoidBCE from_sigmoid", "SigmoidBCELoss",
         dict(from_sigmoid=True), [r(4, 3, lo=0.05, hi=0.95), binary]),
        ("SigmoidBCE from_sigmoid pos_weight", "SigmoidBCELoss",
         dict(from_sigmoid=True),
         [r(4, 3, lo=0.05, hi=0.95), binary, sw, r(4, 3, lo=0.5, hi=3.0)]),
        ("SoftmaxCE", "SoftmaxCrossEntropyLoss", {}, [r(4, 5), sparse]),
        ("SoftmaxCE dense", "SoftmaxCELoss", dict(sparse_label=False),
         [r(4, 5), probs]),
        ("KLDiv", "KLDivLoss", {}, [onp.log(probs[::-1].copy()), probs]),
        ("KLDiv logits", "KLDivLoss", dict(from_logits=False, weight=0.5),
         [r(4, 5), probs, sw]),
        ("Huber", "HuberLoss", dict(rho=0.7), [2 * r(4, 3), r(4, 3), sw]),
        ("Hinge", "HingeLoss", {}, [r(4, 3), signed]),
        ("Hinge margin", "HingeLoss", dict(margin=0.5, weight=1.5),
         [r(4, 3), signed, sw]),
        ("SquaredHinge", "SquaredHingeLoss", {}, [r(4, 3), signed]),
        ("Logistic signed", "LogisticLoss", {}, [r(4, 3), signed]),
        ("Logistic binary", "LogisticLoss", dict(label_format="binary"),
         [r(4, 3), binary, sw]),
        ("Triplet", "TripletLoss", dict(margin=0.5),
         [r(4, 3, 2), r(4, 3, 2), r(4, 3, 2)]),
        ("PoissonNLL", "PoissonNLLLoss", {},
         [r(4, 3), r(4, 3, lo=0.0, hi=4.0)]),
        ("PoissonNLL full", "PoissonNLLLoss",
         dict(from_logits=False, compute_full=True),
         [r(4, 3, lo=0.5, hi=3.0), r(4, 3, lo=0.0, hi=4.0)]),
        ("CosineEmbedding", "CosineEmbeddingLoss", dict(margin=0.2),
         [r(4, 6), r(4, 6), signed[:, 0]]),
        ("SDML", "SDMLLoss", dict(smoothing_parameter=0.2),
         [r(5, 4), r(5, 4)]),
    ]
    T, N, C = 9, 4, 5
    label = onp.array([[1, 2, 2, 0], [3, 4, 0, 0], [1, 1, 1, 1],
                       [2, 4, 3, 1]], "float32")
    cases += [("CTC NTC", "CTCLoss", {}, [r(N, T, C), label]),
              ("CTC TNC TN weighted", "CTCLoss",
               dict(layout="TNC", label_layout="TN", weight=0.5),
               [r(T, N, C), label.T.copy(), onp.full(N, T, "float32"),
                onp.array([2, 2, 4, 4], "float32"), sw[:, 0]])]
    return cases


def test_losses_match_jax():
    """Values and prediction gradients of every loss, against the JAX
    loss classes."""
    cases = _cases()

    def run(arrays):
        out = []
        for (_, cls, ctor, _), args in zip(cases, arrays):
            lf = getattr(jloss, cls)(**ctor)

            def f(p, args=args, lf=lf):
                v = lf(jmx.nd.NDArray(p), *[jmx.nd.NDArray(a)
                                            for a in args[1:]])
                return jnp.sum(v._data), v._data
            (_, v), g = jax.value_and_grad(f, has_aux=True)(args[0])
            out.append((v, g))
        return out

    arrays = [c[3] for c in cases]
    refs = jax.jit(run).lower(arrays).compile(FAST_COMPILE)(arrays)
    for (label, cls, ctor, args), (want, wgrad) in zip(cases, refs):
        p = nd.array(args[0])
        p.attach_grad()
        with mx.autograd.record():
            got = getattr(ploss, cls)(**ctor)(
                p, *[nd.array(a) for a in args[1:]])
        got.backward()
        for what, g, w in (("value", got.asnumpy(), want),
                           ("gradient", p.grad.asnumpy(), wgrad)):
            w = onp.asarray(w)
            assert g.shape == w.shape, (label, what, g.shape, w.shape)
            scale = max(1.0, float(onp.abs(w).max()))
            err = float(onp.abs(g - w).max()) / scale
            assert err <= TOL, f"{label} {what}: {err:.3e}"
    assert ploss.SigmoidBCELoss is ploss.SigmoidBinaryCrossEntropyLoss
    assert ploss.SoftmaxCELoss is ploss.SoftmaxCrossEntropyLoss


def _ctc_cases():
    rng = onp.random.RandomState(1)
    T, N, C = 12, 5, 6
    first = onp.array([[1, 2, 2, -1], [3, 0, 0, 0], [1, 2, 3, 4],
                       [5, 5, 5, 5], [4, -1, -1, -1]], "float32")
    last = onp.array([[0, 1, 1, -1], [2, -1, -1, -1], [0, 1, 2, 3],
                      [4, 4, 4, 4], [3, -1, -1, -1]], "float32")
    dl = onp.array([12, 10, 8, 3, 6], "float32")   # row 3: infeasible
    ll = onp.array([3, 1, 4, 4, 1], "float32")
    out = []
    for blank, label in (("first", first), ("last", last)):
        for use in (False, True):
            out.append((f"blank={blank} lengths={use}",
                        rng.randn(T, N, C).astype("float32"), label,
                        dict(use_data_lengths=use, use_label_lengths=use,
                             blank_label=blank)))
    return out, dl, ll


def test_ctc_op_matches_jax_and_torch():
    """The op's losses (the infeasible one near 1e30) and gradients
    against the JAX op; feasible losses against torch's ``ctc_loss``."""
    cases, dl, ll = _ctc_cases()
    feasible = onp.array([1, 1, 1, 0, 1], "float32")

    def run(datas):
        out = []
        for (_, _, label, kw), d in zip(cases, datas):
            def f(x, label=label, kw=kw):
                v = jnn.ctc_loss(x, jnp.asarray(label), jnp.asarray(dl),
                                 jnp.asarray(ll), **kw)
                return jnp.sum(v * feasible), v
            (_, v), g = jax.value_and_grad(f, has_aux=True)(d)
            out.append((v, g))
        return out

    datas = [c[1] for c in cases]
    refs = jax.jit(run).lower(datas).compile(FAST_COMPILE)(datas)
    for (name, data, label, kw), (want, wgrad) in zip(cases, refs):
        x = nd.array(data)
        x.attach_grad()
        with mx.autograd.record():
            got = nd.ctc_loss(x, nd.array(label), nd.array(dl),
                              nd.array(ll), **kw)
            (got * nd.array(feasible)).sum().backward()
        assert nd.CTCLoss is nd.ctc_loss
        onp.testing.assert_allclose(got.asnumpy(), onp.asarray(want),
                                    rtol=TOL, err_msg=name)
        wgrad = onp.asarray(wgrad)
        err = float(onp.abs(x.grad.asnumpy() - wgrad).max()) \
            / max(1.0, float(onp.abs(wgrad).max()))
        assert err <= TOL, f"{name} gradient: {err:.3e}"
        if not kw["use_label_lengths"]:
            continue
        # torch's own CTC (blank 0 or C-1, targets without padding)
        C = data.shape[2]
        blank = 0 if kw["blank_label"] == "first" else C - 1
        rows = [i for i in range(len(ll)) if feasible[i]]
        logp = torch.log_softmax(torch.tensor(data), -1)[:, rows]
        tgt = torch.tensor(label[rows].clip(min=0)).long()
        ref = torch.nn.functional.ctc_loss(
            logp, tgt, torch.tensor(dl[rows]).long(),
            torch.tensor(ll[rows]).long(), blank=blank, reduction="none")
        onp.testing.assert_allclose(got.asnumpy()[rows], ref.numpy(),
                                    rtol=1e-4, err_msg=name + " torch")
    assert float(got.asnumpy()[3]) > 1e29
