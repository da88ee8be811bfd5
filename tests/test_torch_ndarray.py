"""PyTorch port: the core array layer held against the JAX package on the
CPU.

The same numpy inputs, made from a seed, go through ``mx.nd`` of both
packages: arithmetic, comparisons, indexing, ``astype``, reductions, shape
ops, ``attach_grad``/``backward`` and ``autograd.grad``, the recording and
training flags, ``grad_req`` 'write' against 'add', and ``.params`` files
(the port writes the JAX package's bytes, and each reads the other's).
Tolerance: float32 rtol 1e-5, atol 1e-6 (elementwise ops and small sums in
another order), unless a test says otherwise; dtypes and shapes exactly.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6


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
    """The port's default context is the card; these tests ask for the
    CPU."""
    with mx.cpu():
        yield


def _inputs(seed=0, shape=(3, 4)):
    rng = onp.random.RandomState(seed)
    a = rng.randn(*shape).astype("float32")
    b = (rng.rand(*shape).astype("float32") + 0.5)
    return a, b


def _same(got, want, rtol=RTOL, atol=ATOL):
    """Equal values, dtype names and shapes."""
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    assert got.shape == want.shape
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=rtol,
                                atol=atol)


BINARY = {
    "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
    "mul": lambda x, y: x * y, "div": lambda x, y: x / y,
    "pow": lambda x, y: abs(x) ** y, "floordiv": lambda x, y: x // y,
    "mod": lambda x, y: x % y, "radd": lambda x, y: 2.0 + x,
    "rsub": lambda x, y: 2.0 - x, "rmul": lambda x, y: 3.0 * y,
    "rdiv": lambda x, y: 1.0 / y, "neg": lambda x, y: -x,
    "scalar": lambda x, y: x * 0.5 + 1.0, "eq": lambda x, y: x == x,
    "ne": lambda x, y: x != y, "lt": lambda x, y: x < y,
    "le": lambda x, y: x <= y, "gt": lambda x, y: x > y,
    "ge": lambda x, y: x >= y, "numpy_rhs": lambda x, y: x + y.asnumpy(),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_arithmetic_matches_jax(op):
    a, b = _inputs()
    fn = BINARY[op]
    _same(fn(nd.array(a), nd.array(b)), fn(jmx.nd.array(a), jmx.nd.array(b)))


def test_integer_arithmetic_dtypes_match_jax():
    i = onp.array([1, 2, 7], "int32")
    for fn in (lambda x: x / 2, lambda x: x * 1.5, lambda x: x + x,
               lambda x: x // 2, lambda x: x == 2):
        _same(fn(nd.array(i)), fn(jmx.nd.array(i)))
    # factories and dtype defaults, as mx.nd.array
    assert str(nd.array([1, 2]).dtype) == "float32"
    assert str(nd.array(onp.arange(3)).dtype) == "int32"
    assert str(nd.array(onp.ones(2)).dtype) == "float32"
    for got, want in ((nd.arange(0, 5), jmx.nd.arange(0, 5)),
                      (nd.zeros((2, 3)), jmx.nd.zeros((2, 3))),
                      (nd.ones(4, dtype="int32"), jmx.nd.ones(4,
                                                              dtype="int32")),
                      (nd.full((2,), 7.0), jmx.nd.full((2,), 7.0))):
        _same(got, want)


def test_indexing_matches_jax():
    a, _ = _inputs(1, (4, 5))
    x, jx = nd.array(a), jmx.nd.array(a)
    for key in (1, slice(1, 3), (slice(None), 2), (2, 3), (-1,),
                (slice(None), slice(1, 4))):
        _same(x[key], jx[key])
    idx = onp.array([3, 0, 0], "float32")
    _same(x[nd.array(idx)], jx[jmx.nd.array(idx)])
    x[0] = 5.0
    jx[0] = 5.0
    x[1:3, 2] = nd.array([7.0, 8.0])
    jx[1:3, 2] = jmx.nd.array([7.0, 8.0])
    _same(x, jx)
    x[:] = 1.5
    jx[:] = 1.5
    _same(x, jx)
    assert len(x) == 4 and float(x[0, 0]) == 1.5
    assert [r.shape for r in x] == [(5,)] * 4


def test_astype_shapes_and_reductions_match_jax():
    a, _ = _inputs(2, (2, 3, 4))
    x, jx = nd.array(a), jmx.nd.array(a)
    cases = [
        lambda m, v: v.astype("int32"), lambda m, v: v.astype("float16"),
        lambda m, v: v.sum(), lambda m, v: v.sum(axis=1),
        lambda m, v: v.mean(axis=(0, 2), keepdims=True),
        lambda m, v: v.max(axis=-1), lambda m, v: v.min(),
        lambda m, v: v.reshape((0, -1)), lambda m, v: v.reshape(4, 6),
        lambda m, v: v.transpose(), lambda m, v: v.transpose((1, 0, 2)),
        lambda m, v: v.expand_dims(1), lambda m, v: v.flatten(),
        lambda m, v: v.abs().sqrt(), lambda m, v: v.exp().log(),
        lambda m, v: v.tanh(), lambda m, v: v.sigmoid(),
        lambda m, v: v.relu(), lambda m, v: v.square(),
        lambda m, v: v.softmax(), lambda m, v: v.log_softmax(axis=1),
        lambda m, v: v.clip(-0.5, 0.5), lambda m, v: v.slice_axis(2, 1, 3),
        lambda m, v: m.softmax(v, axis=0),
        lambda m, v: m.take(v, m.array([[1.0, 0.0]]), axis=1),
        lambda m, v: m.pick(v, m.array([[0, 3, 1], [2, 2, 9]]), axis=2),
        lambda m, v: m.concatenate([v, v], axis=1),
        lambda m, v: m.dot(v.reshape((6, 4)), v.reshape((4, 6))),
        lambda m, v: m.FullyConnected(v, m.ones((5, 12)), m.zeros((5,)),
                                      num_hidden=5),
        lambda m, v: m.Activation(v, act_type="relu"),
    ]
    for i, fn in enumerate(cases):
        got, want = fn(nd, x), fn(jmx.nd, jx)
        assert got.shape == want.shape, i
        assert str(got.dtype) == str(want.dtype), i
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL,
                                    atol=ATOL, err_msg=str(i))
    assert x.sum().asscalar() == pytest.approx(float(a.sum()), rel=1e-6)
    assert x.context == mx.cpu(0) and x.size == 24 and x.ndim == 3


def _grads(pkg, a, b, req="write"):
    """Gradients of ``sum(w * x * x + exp(x) / y)`` with respect to x and
    y, with a head gradient of 2, in package ``pkg``."""
    x, y = pkg.nd.array(a), pkg.nd.array(b)
    x.attach_grad(req)
    y.attach_grad(req)
    with pkg.autograd.record():
        z = (x * x * 3.0 + x.exp() / y).sum()
    z.backward(pkg.nd.array(2.0))
    return x.grad, y.grad


def test_attach_grad_backward_matches_jax():
    a, b = _inputs(3)
    for got, want in zip(_grads(mx, a, b), _grads(jmx, a, b)):
        _same(got, want)
    # autograd.grad: the gradients as new arrays, leaving .grad alone
    for pkg in (mx, jmx):
        x = pkg.nd.array(a)
        x.attach_grad()
        with pkg.autograd.record():
            z = (x * x).sum()
        (g,) = pkg.autograd.grad(z, [x])
        onp.testing.assert_allclose(g.asnumpy(), 2 * a, rtol=RTOL)
        assert not x.grad.asnumpy().any()


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_vs_add(req):
    """Two backward calls and no step: 'write' holds one gradient, 'add'
    twice the gradient, as in the JAX package."""
    a, b = _inputs(4)
    for pkg in (mx, jmx):
        x = pkg.nd.array(a)
        x.attach_grad(req)
        for _ in range(2):
            with pkg.autograd.record():
                z = (x * x).sum()
            z.backward()
        want = (2 if req == "add" else 1) * 2 * a
        onp.testing.assert_allclose(x.grad.asnumpy(), want, rtol=RTOL)


def test_record_pause_and_modes_match_jax():
    for pkg in (mx, jmx):
        ag = pkg.autograd
        seen = [(ag.is_recording(), ag.is_training())]
        with ag.record():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                seen.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                seen.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            seen.append((ag.is_recording(), ag.is_training()))
        with ag.train_mode():
            seen.append((ag.is_recording(), ag.is_training()))
        prev = ag.set_training(True)
        seen.append((prev, ag.is_training()))
        ag.set_training(prev)
        assert seen == [(False, False), (True, True), (False, False),
                        (True, False), (True, False), (False, True),
                        (False, True)], pkg.__name__
    # the port builds a graph only under record(), never under pause()
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    assert not (x * 2)._data.requires_grad
    with autograd.record():
        assert (x * 2)._data.requires_grad
        with autograd.pause():
            assert not (x * 2)._data.requires_grad
    with pytest.raises(MXNetError, match="record"):
        (x * 2).backward()


def test_params_file_bytes_match_jax(tmp_path):
    """For the same dict, the port's ``nd.save`` writes the JAX package's
    bytes; each package loads the other's file to equal arrays."""
    rng = onp.random.RandomState(5)
    host = {"w": rng.randn(3, 4).astype("float32"),
            "ids": rng.randint(0, 9, (5,)).astype("int32"),
            "h": rng.randn(2, 2).astype("float16"),
            "bf": rng.randn(4).astype("float32"),
            "s": onp.array(2.5, "float32")}
    port = {k: nd.array(v, dtype="bfloat16" if k == "bf" else None)
            for k, v in host.items()}
    ref = {k: jmx.nd.array(v, dtype="bfloat16" if k == "bf" else None)
           for k, v in host.items()}
    pf, jf = str(tmp_path / "port.params"), str(tmp_path / "jax.params")
    nd.save(pf, port)
    jmx.nd.save(jf, ref)
    assert open(pf, "rb").read() == open(jf, "rb").read()
    from_port, from_jax = jmx.nd.load(pf), nd.load(jf)
    assert list(from_port) == list(from_jax) == list(host)
    for k in host:
        assert str(from_jax[k].dtype) == str(ref[k].dtype)
        onp.testing.assert_array_equal(from_jax[k].asnumpy(),
                                       onp.asarray(ref[k].asnumpy(),
                                                   "float32"
                                                   if k == "bf" else None))
        onp.testing.assert_array_equal(
            onp.asarray(from_port[k].asnumpy(), "float32"),
            port[k].asnumpy().reshape(from_port[k].shape))
    # lists and a single array: no names
    nd.save(pf, [port["w"], port["ids"]])
    jmx.nd.save(jf, [ref["w"], ref["ids"]])
    assert open(pf, "rb").read() == open(jf, "rb").read()
    got = nd.load(pf)
    assert isinstance(got, list) and len(got) == 2
    onp.testing.assert_array_equal(got[1].asnumpy(), host["ids"])
    with pytest.raises(MXNetError, match="not a saved NDArray"):
        open(pf, "wb").write(b"not a params file at all")
        nd.load(pf)


def test_contexts_and_random_streams(monkeypatch):
    """``gpu(i)`` is ``cuda:i``; without a card the default context raises
    instead of running on the CPU; one seed gives one stream per device."""
    assert mx.gpu(1).device_type == "gpu" and mx.Context("cpu") == mx.cpu(0)
    assert str(mx.cpu()) == "cpu(0)" and mx.current_context() == mx.cpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with mx.gpu(0):
        assert mx.current_context() == mx.gpu(0)
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.zeros((2,))
        with pytest.raises(MXNetError, match="no CUDA device"):
            nd.array([1.0])
    mx.random.seed(11)
    u = mx.random.uniform(0, 1, (5,), ctx=mx.cpu()).asnumpy()
    mx.random.seed(11)
    assert (mx.random.uniform(0, 1, (5,)).asnumpy() == u).all()
    mx.random.seed(12)
    assert (mx.random.uniform(0, 1, (5,)).asnumpy() != u).any()
    x = nd.array([1.0, 2.0])
    y = x.copyto(mx.cpu())
    assert y is not x and x.as_in_context(mx.cpu()) is x
    x.wait_to_read()
