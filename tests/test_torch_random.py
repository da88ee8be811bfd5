"""PyTorch port: ``mx.nd.random`` / ``mx.random`` samplers and the engine
facade, on the CPU.

The port's streams (PyTorch generators, one per device) cannot match the
JAX package's threefry draws, so the samplers are held to what both
packages promise: the shape, dtype and context of the reference's call
signatures (parameter-shaped draws included), the support, the first two
moments, the same draws after the same ``mx.random.seed``, and gradients
into NDArray parameters. Moments: over N = 200,000 draws, the sample mean
within 5 standard errors of the distribution's mean and the sample
variance within 5 standard errors (estimated from the draws) of its
variance.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, engine, nd

N = 200_000
K_SE = 5.0

#: sampler call -> (mean, variance, support check)
MOMENTS = {
    "uniform": (lambda s: nd.random.uniform(-1.0, 3.0, shape=s),
                1.0, 16.0 / 12.0, lambda x: (x >= -1) & (x < 3)),
    "normal": (lambda s: nd.random.normal(2.0, 3.0, shape=s), 2.0, 9.0,
               None),
    "randn": (lambda s: nd.random.randn(*s, loc=-1.0, scale=0.5), -1.0,
              0.25, None),
    "randint": (lambda s: nd.random.randint(-3, 5, shape=s), 0.5, 5.25,
                lambda x: (x >= -3) & (x < 5)),
    "exponential": (lambda s: nd.random.exponential(2.0, shape=s), 2.0, 4.0,
                    lambda x: x >= 0),
    "gamma": (lambda s: nd.random.gamma(3.0, 2.0, shape=s), 6.0, 12.0,
              lambda x: x > 0),
    "poisson": (lambda s: nd.random.poisson(4.0, shape=s), 4.0, 4.0,
                lambda x: (x >= 0) & (x == onp.round(x))),
    "negative_binomial": (lambda s: nd.random.negative_binomial(
        3, 0.4, shape=s), 4.5, 11.25, lambda x: (x >= 0) & (x == onp.round(
            x))),
    "generalized_negative_binomial": (
        lambda s: nd.random.generalized_negative_binomial(2.0, 0.5, shape=s),
        2.0, 4.0, lambda x: (x >= 0) & (x == onp.round(x))),
    "bernoulli": (lambda s: nd.random.bernoulli(0.3, shape=s), 0.3, 0.21,
                  lambda x: (x == 0) | (x == 1)),
}


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


def test_samplers_shapes_dtypes_and_names():
    """The reference's signatures: shape, dtype and context of each
    sampler, as the JAX package gives them; parameter-shaped draws; the
    flat ``mx.nd.random_*`` names and ``mx.random`` delegates."""
    calls = [
        ("uniform", dict(low=0.0, high=1.0, shape=(2, 3))),
        ("normal", dict(loc=0.0, scale=1.0, shape=(4,), dtype="float16")),
        ("randint", dict(low=0, high=9, shape=(3, 2))),
        ("exponential", dict(scale=1.0, shape=5)),
        ("uniform", dict()),
    ]
    for name, kw in calls:
        got = getattr(nd.random, name)(**kw)
        want = getattr(jmx.nd.random, name)(**kw)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert str(got.dtype) == str(want.dtype), (name, got.dtype,
                                                   want.dtype)
        assert got.context == mx.cpu()
    # the rest as the JAX package gives them (float32 unless dtype=)
    for name, kw in (("gamma", dict(alpha=2.0, beta=1.0, shape=(2, 2))),
                     ("poisson", dict(lam=3.0, shape=(3,))),
                     ("negative_binomial", dict(k=2, p=0.5, shape=(2,))),
                     ("generalized_negative_binomial",
                      dict(mu=1.0, alpha=0.5, shape=(2,))),
                     ("bernoulli", dict(prob=0.5, shape=(6,))),
                     ("poisson", dict(lam=3.0, shape=4, dtype="int32"))):
        got = getattr(nd.random, name)(**kw)
        shape = kw["shape"] if isinstance(kw["shape"], tuple) \
            else (kw["shape"],)
        assert got.shape == shape and str(got.dtype) == kw.get(
            "dtype", "float32"), name
    assert nd.random.randn(2, 3).shape == (2, 3)
    # parameter-shaped: an NDArray parameter gives the output its shape
    lo, hi = nd.array([0.0, 10.0, 20.0]), nd.array([1.0, 11.0, 21.0])
    u = nd.random.uniform(lo, hi).asnumpy()
    assert u.shape == (3,) and ((u >= [0, 10, 20]) & (u < [1, 11, 21])).all()
    assert nd.random.normal(nd.zeros((2, 4)), 1.0).shape == (2, 4)
    assert nd.random.poisson(nd.array([1.0, 50.0])).shape == (2,)
    out = nd.zeros((5,))
    assert nd.random.uniform(2.0, 3.0, shape=(5,), out=out) is out
    assert (out.asnumpy() >= 2).all()
    for flat, name in (("random_uniform", "uniform"),
                       ("random_normal", "normal"),
                       ("random_randint", "randint"),
                       ("random_exponential", "exponential"),
                       ("random_poisson", "poisson"),
                       ("random_gamma", "gamma"),
                       ("random_negative_binomial", "negative_binomial"),
                       ("random_generalized_negative_binomial",
                        "generalized_negative_binomial"),
                       ("sample_multinomial", "multinomial"),
                       ("shuffle", "shuffle")):
        assert getattr(nd, flat) is getattr(nd.random, name), flat
    mx.random.seed(3)
    a = mx.random.gamma(2.0, shape=(4,)).asnumpy()
    mx.random.seed(3)
    onp.testing.assert_array_equal(nd.random.gamma(2.0, shape=(4,))
                                   .asnumpy(), a)
    p = nd.array([[0.1, 0.9], [0.8, 0.2]])
    for shape in (1, 3, (2, 2)):
        got = nd.random.multinomial(p, shape=shape)
        want = jmx.nd.random.multinomial(jmx.nd.array(p.asnumpy()),
                                         shape=shape)
        assert got.shape == want.shape and str(got.dtype) == str(want.dtype)


def test_sampler_moments_and_support():
    failed = []
    for name in sorted(MOMENTS):
        draw, mean, var, support = MOMENTS[name]
        mx.random.seed(7)
        x = draw((N,)).asnumpy().astype("float64")
        assert x.shape == (N,)
        if support is not None and not support(x).all():
            failed.append(f"{name}: a draw outside the support")
        m, v = x.mean(), x.var()
        se_m = onp.sqrt(var / N)
        se_v = ((x - m) ** 2).std() / onp.sqrt(N)
        if abs(m - mean) >= K_SE * se_m:
            failed.append(f"{name}: mean {m} against {mean} (SE {se_m})")
        if abs(v - var) >= K_SE * se_v:
            failed.append(f"{name}: variance {v} against {var} (SE {se_v})")
    assert not failed, "\n".join(failed)


def test_multinomial_and_shuffle():
    """Category frequencies within 5 standard errors; draws per row;
    ``get_prob``'s log-probabilities and their gradient into the
    probabilities (the REINFORCE use); ``shuffle`` permutes rows."""
    mx.random.seed(5)
    p = onp.array([0.1, 0.2, 0.7], "float32")
    idx = nd.random.multinomial(nd.array(p), shape=N).asnumpy()
    assert idx.dtype == onp.int32 and set(onp.unique(idx)) <= {0, 1, 2}
    freq = onp.bincount(idx, minlength=3) / N
    assert (onp.abs(freq - p) < K_SE * onp.sqrt(p * (1 - p) / N)).all(), freq
    probs = nd.array([[0.5, 0.5, 0.0], [0.0, 0.25, 0.75]])
    probs.attach_grad()
    with autograd.record():
        s, logp = nd.random.multinomial(probs, shape=4, get_prob=True)
        logp.sum().backward()
    s = s.asnumpy()
    assert s.shape == logp.shape == (2, 4)
    assert (s[0] < 2).all() and (s[1] > 0).all()
    onp.testing.assert_allclose(
        logp.asnumpy(), onp.log(probs.asnumpy()[[[0], [1]], s]), rtol=1e-6)
    counts = onp.stack([onp.bincount(r, minlength=3) for r in s])
    with onp.errstate(divide="ignore", invalid="ignore"):
        want = onp.where(counts > 0, counts / probs.asnumpy(), 0.0)
    onp.testing.assert_allclose(probs.grad.asnumpy(), want, rtol=1e-5)
    x = nd.array(onp.arange(40, dtype="float32").reshape(10, 4))
    mx.random.seed(1)
    y = nd.random.shuffle(x).asnumpy()
    assert not (y == x.asnumpy()).all()
    onp.testing.assert_array_equal(onp.sort(y[:, 0]), x.asnumpy()[:, 0])
    onp.testing.assert_array_equal(y[:, 1:] - y[:, :1], x.asnumpy()[:, 1:]
                                   - x.asnumpy()[:, :1])
    mx.random.seed(1)
    onp.testing.assert_array_equal(nd.shuffle(x).asnumpy(), y)


def test_same_seed_same_draws():
    """Every sampler repeats its draws after the same ``mx.random.seed``
    and changes them after another; ``seed(n, ctx)`` seeds one device."""
    def draws():
        return [MOMENTS[n][0]((64,)).asnumpy() for n in sorted(MOMENTS)] + [
            nd.random.multinomial(nd.array([0.3, 0.7]), shape=64).asnumpy(),
            nd.random.shuffle(nd.arange(64)).asnumpy()]
    mx.random.seed(11)
    a = draws()
    mx.random.seed(11)
    b = draws()
    mx.random.seed(12)
    c = draws()
    for name, x, y, z in zip(sorted(MOMENTS) + ["multinomial", "shuffle"],
                             a, b, c):
        onp.testing.assert_array_equal(x, y, err_msg=name)
        assert (x != z).any(), name
    mx.random.seed(4, ctx=mx.cpu())
    u = nd.random.uniform(shape=(8,)).asnumpy()
    mx.random.seed(4, ctx=mx.cpu())
    onp.testing.assert_array_equal(nd.random.uniform(shape=(8,)).asnumpy(), u)


def test_parameter_gradients_and_engine():
    """Under ``record()`` the gradient flows into NDArray parameters
    (``uniform``: ``d/dlow = 1 - u``, ``d/dhigh = u``; ``normal``:
    ``d/dloc = 1``, ``d/dscale = z``); ``waitall`` and the engine's inert
    knobs."""
    lo, hi = nd.array([1.0, 2.0]), nd.array([3.0, 6.0])
    lo.attach_grad()
    hi.attach_grad()
    with autograd.record():
        x = nd.random.uniform(lo, hi)
        x.sum().backward()
    u = (x.asnumpy() - [1.0, 2.0]) / [2.0, 4.0]
    onp.testing.assert_allclose(lo.grad.asnumpy(), 1 - u, rtol=1e-5,
                                atol=1e-6)
    onp.testing.assert_allclose(hi.grad.asnumpy(), u, rtol=1e-5, atol=1e-6)
    mu, sd = nd.array([0.5]), nd.array([2.0])
    mu.attach_grad()
    sd.attach_grad()
    with autograd.record():
        y = nd.random.normal(mu, sd, shape=(3,))
        y.sum().backward()
    z = (y.asnumpy() - 0.5) / 2.0
    onp.testing.assert_allclose(mu.grad.asnumpy(), [3.0], rtol=1e-6)
    onp.testing.assert_allclose(sd.grad.asnumpy(), [z.sum()], rtol=1e-5,
                                atol=1e-6)
    mx.waitall()
    nd.waitall()
    assert engine.engine_type() == "ThreadedEnginePerDevice"
    with engine.bulk(4):
        assert engine.set_bulk_size(7) == 4
    assert engine.set_bulk_size(15) == 15
    with engine.naive_engine():
        assert nd.ones((2,)).sum().asscalar() == 2.0
