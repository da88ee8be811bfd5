"""PyTorch port: ``mx.np``, ``mx.npx``, ``mx.util``'s numpy switches,
``nd.sparse``, ``Parameter(stype=)`` and ``mx.test_utils`` held against the
JAX package on the CPU.

- ``mx.np``: the JAX tests' names (``array``, ``trapz`` with its
  gradient, ``shares_memory``, ``may_share_memory``, ``ascontiguousarray``:
  ``tests/test_ndarray.py:277-297``), the factories' dtypes (float32 and
  int32 by default), and the functions of ``NUMPY_SAME`` on seeded inputs
  against the JAX ``mx.np`` (within 1e-6 of the largest value; integer
  results equal); a name outside the list raises ``AttributeError``
  naming it. ``mx.npx``'s ops equal the JAX ones (1e-6).
- ``set_np``/``reset_np``/``np_shape``/``use_np_shape``: the same states
  in both packages after the same calls.
- ``nd.sparse`` (JAX ``tests/test_sparse_ctc_dlpack.py:89-147, 245``): csr
  round trips (dense, the ``(data, indices, indptr)`` triple, empty rows,
  duplicate entries adding up), ``dot`` with and without ``transpose_a``
  and against a vector (1e-5, as the JAX test), row-sparse arrays and
  ``cast_storage``, the dense-budget guard; ``indices``/``indptr``/``data``
  equal the JAX arrays.
- ``gluon.Parameter(stype=, grad_stype=)`` is taken as the JAX package
  takes it (and refused for an unknown type).
- ``mx.test_utils``: ``rand_ndarray`` gives the JAX values from the same
  numpy seed, ``assert_almost_equal``/``almost_equal``/``same`` agree, and
  ``check_numeric_gradient``/``check_consistency`` pass on the port.
"""
import functools

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import numpy_extension as jnpx
from incubator_mxnet_tpu import test_utils as jtu
from incubator_mxnet_tpu import util as jutil

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import test_utils as tu
from incubator_mxnet_tpu_torch import util

TOL = 1e-6


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


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else onp.asarray(a)


def _close(got, want, tol=TOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype.kind in "biu":
        onp.testing.assert_array_equal(g, w)
        return
    scale = max(float(onp.abs(w).max()) if w.size else 0.0, 1.0)
    onp.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


#: mx.np calls of both packages on (a, b, y): a, b normal (4, 5), y
#: uniform in (0.5, 1.5), i integer
NP_CASES = {
    "exp": lambda np, a, b, y, i: np.exp(a),
    "log": lambda np, a, b, y, i: np.log(y),
    "sqrt": lambda np, a, b, y, i: np.sqrt(y),
    "tanh": lambda np, a, b, y, i: np.tanh(a),
    "arctan2": lambda np, a, b, y, i: np.arctan2(a, b),
    "maximum": lambda np, a, b, y, i: np.maximum(a, b),
    "where": lambda np, a, b, y, i: np.where(np.greater(a, 0), a, b),
    "clip": lambda np, a, b, y, i: np.clip(a, -0.5, 0.5),
    "matmul": lambda np, a, b, y, i: np.matmul(a, b.T),
    "outer": lambda np, a, b, y, i: np.outer(a[0], b[0]),
    "sum": lambda np, a, b, y, i: np.sum(a, axis=1),
    "prod": lambda np, a, b, y, i: np.prod(y, axis=0),
    "amax": lambda np, a, b, y, i: np.amax(a, axis=0),
    "argmax": lambda np, a, b, y, i: np.argmax(a, axis=1),
    "concatenate": lambda np, a, b, y, i: np.concatenate([a, b], axis=1),
    "stack": lambda np, a, b, y, i: np.stack([a, b], axis=0),
    "diff": lambda np, a, b, y, i: np.diff(a, axis=1),
    "tril": lambda np, a, b, y, i: np.tril(a),
    "logaddexp": lambda np, a, b, y, i: np.logaddexp(a, b),
    "isfinite": lambda np, a, b, y, i: np.isfinite(np.log(a)),
    "ravel": lambda np, a, b, y, i: np.ravel(a),
    "absolute": lambda np, a, b, y, i: np.absolute(i),
    "add_int": lambda np, a, b, y, i: np.add(i, i),
}


def _np_inputs():
    rng = onp.random.RandomState(3)
    return (rng.randn(4, 5).astype("float32"),
            rng.randn(4, 5).astype("float32"),
            rng.uniform(0.5, 1.5, (4, 5)).astype("float32"),
            rng.randint(-9, 9, (4, 5)).astype("int32"))


@functools.lru_cache(maxsize=None)
def _jax_np():
    ins = [jmx.np.array(v) for v in _np_inputs()]
    out = {k: _np(f(jmx.np, *ins)) for k, f in NP_CASES.items()}
    y = jmx.np.array([1.0, 2.0, 3.0])
    y.attach_grad()
    with jmx.autograd.record():
        z = jmx.np.trapz(y)
    z.backward()
    out["trapz"], out["trapz_grad"] = _np(z), _np(y.grad)
    x = jmx.nd.array(onp.random.RandomState(4).randn(2, 6).astype("float32"))
    out["npx"] = [_np(jnpx.softmax(x)), _np(jnpx.log_softmax(x)),
                  _np(jnpx.relu(x)), _np(jnpx.sigmoid(x)),
                  _np(jnpx.topk(x, k=2)),
                  _np(jnpx.one_hot(jmx.nd.array([0, 2]), 3))]
    return out


def test_np_names_and_npx_match_jax():
    want = _jax_np()
    ins = [mx.np.array(v) for v in _np_inputs()]
    for k, f in NP_CASES.items():
        got = _np(f(mx.np, *ins))
        w = want[k]
        if w.dtype.kind in "biu":
            assert got.dtype.kind == w.dtype.kind, (k, got.dtype, w.dtype)
        _close(got, w)
    y = mx.np.array([1.0, 2.0, 3.0])
    assert y.dtype == onp.float32
    y.attach_grad()
    with mx.autograd.record():
        z = mx.np.trapz(y)
    z.backward()
    _close(z, want["trapz"])
    _close(y.grad, want["trapz_grad"])
    # the JAX test's tail (tests/test_ndarray.py:277-297)
    a, b = mx.np.array([1.0]), mx.np.array([1.0])
    assert mx.np.shares_memory(a, b) is False
    assert mx.np.may_share_memory(a, b) is False
    assert mx.np.ascontiguousarray(a).shape == (1,)
    base = onp.zeros(10)
    assert mx.np.may_share_memory(base, base[2:5]) is True
    view = mx.np.zeros(10)
    assert mx.np.shares_memory(view, view[2:5]) is True
    assert mx.np.shares_memory(view[:3], view[5:]) is False
    # factories: float32 and int32 by default, as the JAX package
    for got, j in ((mx.np.zeros((2,)), jmx.np.zeros((2,))),
                   (mx.np.full((2,), 3), jmx.np.full((2,), 3)),
                   (mx.np.arange(4), jmx.np.arange(4)),
                   (mx.np.arange(0.0, 1.0, 0.25), jmx.np.arange(0.0, 1.0,
                                                                 0.25))):
        assert _np(got).dtype == _np(j).dtype
        _close(got, j)
    with pytest.raises(AttributeError, match="cumsum"):
        mx.np.cumsum
    x = mx.nd.array(onp.random.RandomState(4).randn(2, 6).astype("float32"))
    got = [mx.npx.softmax(x), mx.npx.log_softmax(x), mx.npx.relu(x),
           mx.npx.sigmoid(x), mx.npx.topk(x, k=2),
           mx.npx.one_hot(mx.nd.array([0, 2]), 3)]
    for g, w in zip(got, want["npx"]):
        _close(g, w)
    mx.np.random.seed(5)
    r1 = _np(mx.np.random.uniform(size=(3,)))
    mx.np.random.seed(5)
    assert (_np(mx.np.random.uniform(size=(3,))) == r1).all()
    assert mx.np.random.randint(4, size=(2, 2)).dtype == onp.int32


def test_util_np_switches_match_jax():
    states = []
    for u, npx in ((util, mx.npx), (jutil, jnpx)):
        seq = [(u.is_np_shape(), u.is_np_array())]
        u.set_np()
        seq.append((npx.is_np_shape(), npx.is_np_array()))
        with u.np_shape(False):
            seq.append(u.is_np_shape())
        u.set_np(shape=False, array=True)
        seq.append((u.is_np_shape(), u.is_np_array()))
        seq.append(u.use_np_shape(lambda: u.is_np_shape())())
        seq.append(u.is_np_shape())
        npx.reset_np()
        seq.append((u.is_np_shape(), u.is_np_array()))
        states.append(seq)
    assert states[0] == states[1]
    assert states[0][0] == (True, False)


def _rand_csr(m, k, density, rng):
    dense = rng.randn(m, k).astype("float32")
    dense[rng.rand(m, k) >= density] = 0.0
    return dense


def _csr_cases(lib):
    nd = lib.nd
    rng = onp.random.RandomState(0)
    dense = _rand_csr(7, 9, 0.3, rng)
    sp = nd.sparse.csr_matrix(dense)
    out = [sp.asnumpy(), _np(sp.indptr), _np(sp.indices), _np(sp.data)]
    sp2 = nd.sparse.csr_matrix(
        (_np(sp.data), _np(sp.indices), _np(sp.indptr)), shape=dense.shape)
    out.append(sp2.asnumpy())
    empty = onp.zeros((4, 5), "float32")
    empty[2, 3] = 2.5
    e = nd.sparse.csr_matrix(empty)
    out += [e.asnumpy(), _np(e.indptr)]
    # a duplicated (row, col) entry adds up, in the array and in dot
    dup = nd.sparse.csr_matrix(
        (onp.array([1.0, 2.0, 3.0], "float32"), onp.array([1, 1, 0]),
         onp.array([0, 2, 3])), shape=(2, 3))
    out.append(dup.asnumpy())
    rng = onp.random.RandomState(1)
    d1 = _rand_csr(6, 8, 0.25, rng)
    B = rng.randn(8, 3).astype("float32")
    out.append(_np(nd.sparse.dot(nd.sparse.csr_matrix(d1), nd.array(B))))
    rng = onp.random.RandomState(2)
    d2 = _rand_csr(6, 8, 0.25, rng)
    B2 = rng.randn(6, 4).astype("float32")
    out.append(_np(nd.sparse.dot(nd.sparse.csr_matrix(d2), nd.array(B2),
                                 transpose_a=True)))
    rng = onp.random.RandomState(4)
    d3 = _rand_csr(5, 7, 0.4, rng)
    b = rng.randn(7).astype("float32")
    out.append(_np(nd.sparse.dot(nd.sparse.csr_matrix(d3), nd.array(b))))
    out.append(_np(nd.sparse.dot(dup, nd.array(onp.eye(3, dtype="float32"))
                                 )))
    rng = onp.random.RandomState(5)
    dense = rng.randn(6, 4).astype("float32")
    dense[[1, 3, 5]] = 0.0
    rs = nd.sparse.cast_storage(nd.array(dense), "row_sparse")
    out += [rs.asnumpy(), _np(rs.indices), _np(rs.data),
            rs.tostype("default").asnumpy(),
            nd.array(dense).tostype("csr").asnumpy(),
            nd.sparse.zeros("row_sparse", (3, 2)).asnumpy(),
            _np(nd.sparse.row_sparse_array(
                (onp.ones((2, 4), "float32"), [0, 2]), shape=(5, 4)))]
    kinds = [sp.stype, rs.stype, nd.array(dense).tostype("csr").stype]
    return out, kinds, (d1, B, d2, B2, d3, b)


@functools.lru_cache(maxsize=None)
def _jax_csr():
    out, kinds, _ = _csr_cases(jmx)
    return [_np(o) for o in out], kinds


def test_sparse_round_trips_dot_and_budget_guard(monkeypatch):
    want, j_kinds = _jax_csr()
    got, kinds, (d1, B, d2, B2, d3, b) = _csr_cases(mx)
    assert kinds == j_kinds == ["csr", "row_sparse", "csr"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    _close(got[0], _rand_csr(7, 9, 0.3, onp.random.RandomState(0)))
    _close(got[6], [0, 0, 0, 1, 1])
    _close(got[8], d1 @ B, 1e-5)
    _close(got[9], d2.T @ B2, 1e-5)
    _close(got[10], d3 @ b, 1e-5)
    with pytest.raises(mx.MXNetError, match="MXTPU_SPARSE_DENSE_LIMIT"):
        mx.nd.sparse.row_sparse_array(
            (onp.ones((2, 1024), "float32"), [0, 1]),
            shape=(23_000_000, 1024))
    monkeypatch.setenv("MXTPU_SPARSE_DENSE_LIMIT", "16")
    with pytest.raises(mx.MXNetError, match="MXTPU_SPARSE_DENSE_LIMIT"):
        mx.nd.sparse.csr_matrix(onp.eye(4, dtype="float32"))
    monkeypatch.setenv("MXTPU_SPARSE_DENSE_LIMIT", "0")
    arr = mx.nd.sparse.row_sparse_array(
        (onp.ones((2, 4), "float32"), [0, 2]), shape=(5, 4))
    assert arr.shape == (5, 4)
    with pytest.raises(mx.MXNetError, match="CSR lhs"):
        mx.nd.sparse.dot(arr, mx.nd.ones((4, 2)))


def test_parameter_stype_and_test_utils_match_jax():
    for lib in (mx, jmx):
        p = lib.gluon.Parameter("emb_weight", shape=(4, 3),
                                stype="row_sparse", grad_stype="row_sparse")
        assert (p._stype, p._grad_stype) == ("row_sparse", "row_sparse")
    p = mx.gluon.Parameter("w", shape=(2, 2), stype="csr")
    assert p.stype == "csr" and p.grad_stype == "default"
    p.initialize()
    assert p.data().tostype(p.stype).stype == "csr"
    with pytest.raises(ValueError, match="stype"):
        mx.gluon.Parameter("bad", stype="dense")
    # test_utils: the same numpy stream gives the JAX values
    for stype in ("default", "row_sparse", "csr"):
        onp.random.seed(7)
        got = tu.rand_ndarray((3, 4), stype=stype, ctx=mx.cpu())
        onp.random.seed(7)
        want = jtu.rand_ndarray((3, 4), stype=stype, ctx=jmx.cpu())
        assert got.stype == want.stype == stype
        _close(got, want)
    a = onp.array([1.0, 2.0], "float32")
    for lib_tu in (tu, jtu):
        assert lib_tu.same(a, a.copy())
        assert lib_tu.almost_equal(a, a + 1e-7)
        assert not lib_tu.almost_equal(a, a + 1e-2)
        lib_tu.assert_almost_equal(a, a + 1e-6)
        with pytest.raises(AssertionError):
            lib_tu.assert_almost_equal(a, a + 1e-2)
        assert lib_tu.effective_dtype_tol("float16") == 1e-2
    assert tu.default_context() == mx.cpu()
    tu.set_default_context(mx.cpu())
    try:
        tu.check_numeric_gradient(lambda x: mx.nd.tanh(x) * x,
                                  [onp.random.RandomState(1).randn(3, 2)])
        tu.check_consistency(lambda x: mx.nd.sigmoid(x).sum(axis=0),
                             [onp.random.RandomState(2).randn(4, 3)],
                             ctx_list=[mx.cpu(0), mx.cpu(0)],
                             dtypes=("float32", "float64"))
    finally:
        tu.set_default_context(None)
