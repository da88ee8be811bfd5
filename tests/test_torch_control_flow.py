"""PyTorch port: control flow (``foreach``, ``while_loop``, ``cond``) held
against the JAX package on the CPU (the cases of ``tests/test_control_flow.py``).

- Eager calls (NDArrays, outside a hybridized block) run a Python loop or
  branch in both packages: outputs, final states and the gradients that
  reach data and closed-over arrays agree within 1e-6 of the largest value
  (float32, the same ops in the same order). ``while_loop`` returns exactly
  the executed steps; a host-reading body fires once a step.
- A hybridized block takes the graph form: the port's from its first call
  (its CUDA-graph form), the JAX package's from its second (its first is
  the eager warm-up); the port's calls equal the JAX compiled call.
  ``while_loop`` pads the rows after the last executed step with zeros.
  ``cond``'s gradient reaches the taken branch only, also when the untaken
  branch's gradient is NaN (``sqrt`` of a negative).
- ``mx.sym.contrib.foreach``/``while_loop``/``cond``: the ``tojson`` of
  graphs built in fresh name managers is the JAX string byte for byte; each
  package loads the other's JSON and evaluates it to the JAX ``eval``
  (within 1e-6); ``Executor.backward`` through ``_foreach`` gives the JAX
  gradients.
- The bucketed RNN over ``foreach`` (JAX ``tests/test_control_flow.py:225-287``):
  one ``RNNCell`` scanned over buckets of 3, 5 and 9 steps gives the JAX
  cell's final state with the same weights and the port's unrolled loop's
  (2e-5, as the JAX test), and the same gradients as the unrolled loop.
"""
import functools

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx

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
    scale = max(float(onp.abs(w).max()) if w.size else 0.0, 1.0)
    onp.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


def _grad(a):
    return a.grad() if callable(a.grad) else a.grad


def _foreach_cases(lib, x, a, b, w0):
    nd, autograd = lib.nd, lib.autograd
    outs, states = nd.contrib.foreach(
        lambda d, s: (d + s, d + s), nd.array(x), nd.zeros((3,)))

    def body(data, st):
        da, db = data
        s1, s2 = st
        return [da + db, s1], [s1 + da, s2 * 1.0]

    m_outs, m_states = nd.contrib.foreach(
        body, [nd.array(a), nd.array(b)], [nd.zeros((2,)), nd.ones((2,))])
    data = nd.array(x[:3, :2])
    data.attach_grad()
    w = nd.array(w0)
    w.attach_grad()
    with autograd.record():
        _, st = nd.contrib.foreach(lambda d, s: (d * w, s + d * w), data,
                                   nd.zeros((2,)))
        loss = (st * st).sum()
    loss.backward()
    return [outs, states, *m_outs, *m_states, _grad(w), _grad(data)]


def _cum_block(lib):
    class Cum(lib.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            outs, _ = lib.nd.contrib.foreach(
                lambda d, s: (d + s, d * s + 1.0), x, F.zeros_like(x[0]))
            return outs
    return Cum()


@functools.lru_cache(maxsize=None)
def _jax_foreach(seed):
    rng = onp.random.RandomState(seed)
    args = (rng.randn(4, 3).astype("float32"),
            rng.randn(5, 2).astype("float32"),
            rng.randn(5, 2).astype("float32"),
            rng.randn(2).astype("float32"))
    want = [_np(v) for v in _foreach_cases(jmx, *args)]
    net = _cum_block(jmx)
    net.initialize()
    net.hybridize()
    x = jmx.nd.array(args[0])
    first = _np(net(x))
    compiled = _np(net(x))
    return args, want, first, compiled


def test_foreach_eager_grads_and_hybridized_match_jax():
    args, want, j_first, j_compiled = _jax_foreach(0)
    for got, ref in zip(_foreach_cases(mx, *args), want):
        _close(got, ref)
    # the JAX first (eager) and compiled calls agree, and so do the port's
    # hybridized calls (graph form from the first) and its plain block
    _close(j_first, j_compiled)
    net = _cum_block(mx)
    net.initialize()
    x = mx.nd.array(args[0])
    _close(net(x), j_compiled)
    net.hybridize()
    for _ in range(2):
        _close(net(x), j_compiled)
    # an imperative body reads the host once a step (eager form)
    seen = []

    def host_body(d, s):
        seen.append(float(d.asnumpy().sum()))
        return d * (2.0 if seen[-1] > 4 else 1.0), s + d

    xs = onp.arange(6, dtype="float32").reshape(3, 2)
    outs, st = mx.nd.contrib.foreach(host_body, mx.nd.array(xs),
                                     mx.nd.zeros((2,)))
    assert seen == [1.0, 5.0, 9.0]
    _close(outs, onp.stack([xs[0], 2 * xs[1], 2 * xs[2]]))
    _close(st, xs.sum(axis=0))


def _while_block(lib):
    class W(lib.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            outs, fin = lib.nd.contrib.while_loop(
                cond=lambda i: i.sum() < 3.0,
                func=lambda i: (i + 0.5, [i + 1.0]),
                loop_vars=[F.zeros_like(x)], max_iterations=5)
            return outs
    return W()


def _while_eager(lib):
    nd, autograd = lib.nd, lib.autograd
    outs, fin = nd.contrib.while_loop(
        cond=lambda i, s: i < 5, func=lambda i, s: (i * 10, [i + 1, s + i]),
        loop_vars=[nd.array([0.0]), nd.array([0.0])], max_iterations=20)
    x = nd.array([2.0])
    x.attach_grad()
    with autograd.record():
        _, g_fin = nd.contrib.while_loop(
            cond=lambda v: v < 20, func=lambda v: (v, [v * 2.0]),
            loop_vars=[x], max_iterations=10)
        loss = g_fin[0].sum()
    loss.backward()
    return [outs, fin[0], fin[1], _grad(x)]


@functools.lru_cache(maxsize=None)
def _jax_while():
    want = [_np(v) for v in _while_eager(jmx)]
    net = _while_block(jmx)
    net.initialize()
    net.hybridize()
    x = jmx.nd.array([1.0])
    return want, _np(net(x)), _np(net(x))


def test_while_loop_eager_grads_and_hybridized_zero_pad():
    want, j_first, j_compiled = _jax_while()
    got = _while_eager(mx)
    assert got[0].shape == (5, 1)          # exactly the executed steps
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[3], [16.0])
    # JAX: eager warm-up, then the masked scan's zero-padded rows
    _close(j_first.ravel(), [0.5, 1.5, 2.5])
    _close(j_compiled.ravel(), [0.5, 1.5, 2.5, 0.0, 0.0])
    plain = _while_block(mx)
    plain.initialize()
    _close(plain(mx.nd.array([1.0])), j_first)
    hyb = _while_block(mx)
    hyb.initialize()
    hyb.hybridize()
    for _ in range(2):
        _close(hyb(mx.nd.array([1.0])), j_compiled)


def _cond_block(lib):
    class C(lib.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return lib.nd.contrib.cond(x.sum() > 0, lambda: F.sqrt(x) * 3.0,
                                       lambda: x * -2.0)
    return C()


def _cond_grads(lib, values, hybridize):
    nd, autograd = lib.nd, lib.autograd
    out = []
    x = nd.array([3.0])
    x.attach_grad()
    with autograd.record():
        y = nd.contrib.cond(lambda: x.sum() > 0, lambda: x * 5.0,
                            lambda: x * 7.0)
    y.backward()
    out.append(_np(_grad(x)))
    net = _cond_block(lib)
    if hybridize:
        net.hybridize()
    for v in values:
        a = nd.array(v)
        a.attach_grad()
        with autograd.record():
            r = net(a)
        r.backward()
        out += [_np(r), _np(_grad(a))]
    return out


#: negative first: the untaken sqrt branch has NaN values and gradients
COND_VALUES = (onp.array([-4.0, -1.0], "float32"),
               onp.array([-4.0, -1.0], "float32"),
               onp.array([4.0, 1.0], "float32"))


@functools.lru_cache(maxsize=None)
def _jax_cond():
    return _cond_grads(jmx, COND_VALUES, hybridize=True)


def test_cond_grads_reach_the_taken_branch_only():
    want = _jax_cond()
    _close(want[0], [5.0])
    _close(want[4], [-2.0, -2.0])        # JAX compiled call: lax.cond
    for hybridize in (False, True):
        got = _cond_grads(mx, COND_VALUES, hybridize)
        for g, w in zip(got, want):
            assert onp.isfinite(g).all()
            _close(g, w)

    class Mismatch(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return mx.nd.contrib.cond(x.sum() > 0, lambda: x * 2,
                                      lambda: [x * 3])

    net = Mismatch()
    net.hybridize()
    with pytest.raises(ValueError, match="disagree on output structure"):
        net(mx.nd.ones((3,)))


def _sym_case(lib, kind):
    """(graph, eval arguments, executor arguments or None)."""
    S = lib.sym
    with lib.name.NameManager():
        if kind == "foreach":
            data, init, w = S.Variable("data"), S.Variable("init"), \
                S.Variable("w")
            outs, _ = S.contrib.foreach(
                lambda d, s: ((S.broadcast_mul(d, w) + s,) * 2), data, init)
            return outs
        if kind == "while_loop":
            v = S.Variable("v")
            outs, _ = S.contrib.while_loop(
                cond=lambda v: S.sum(v) < 3.0,
                func=lambda v: (v * 2.0, [v + 1.0]), loop_vars=[v],
                max_iterations=6)
            return outs
        p, a = S.Variable("p"), S.Variable("a")
        return S.contrib.cond(p, lambda: a * 2.0, lambda: a - 1.0)


def _sym_args(kind, rng):
    if kind == "foreach":
        return dict(data=rng.randn(4, 3).astype("float32"),
                    init=rng.randn(3).astype("float32"),
                    w=rng.randn(3).astype("float32"))
    if kind == "while_loop":
        return dict(v=onp.array([0.5], "float32"))
    return dict(p=onp.array([0.0], "float32"),
                a=rng.randn(2).astype("float32"))


def _eval(lib, sym, args):
    return [_np(o) for o in sym.eval(
        **{k: lib.nd.array(v) for k, v in args.items()})]


def _executor_grads(lib, args):
    S = lib.sym
    with lib.name.NameManager():
        data, init = S.Variable("data"), S.Variable("init")
        _, states = S.contrib.foreach(
            lambda d, s: (d * 2.0 + s, S.tanh(d * s + s)), data, init)
        loss = S.sum(states * states)
    grads = {k: lib.nd.zeros(v.shape) for k, v in args.items()}
    ex = loss.bind(lib.cpu(), {k: lib.nd.array(v) for k, v in args.items()},
                   args_grad=grads)
    ex.forward(is_train=True)
    ex.backward()
    return [_np(grads[k]) for k in sorted(grads)]


@functools.lru_cache(maxsize=None)
def _jax_sym(kind):
    rng = onp.random.RandomState(11)
    args = _sym_args(kind, rng)
    sym = _sym_case(jmx, kind)
    ex = None
    if kind == "foreach":
        ex_args = dict(data=rng.randn(3, 2).astype("float32"),
                       init=rng.randn(2).astype("float32"))
        ex = (ex_args, _executor_grads(jmx, ex_args))
    return sym.tojson(), args, _eval(jmx, sym, args), ex


@pytest.mark.parametrize("kind", ["foreach", "while_loop", "cond"])
def test_sym_control_flow_json_eval_both_ways(kind):
    j_json, args, want, ex = _jax_sym(kind)
    sym = _sym_case(mx, kind)
    assert sym.tojson() == j_json
    for got, w in zip(_eval(mx, sym, args), want):
        _close(got, w)
    # each package reads the other's JSON
    for got, w in zip(_eval(mx, mx.sym.load_json(j_json), args), want):
        _close(got, w)
    back = jmx.sym.load_json(sym.tojson())
    for got, w in zip(_eval(jmx, back, args), want):
        _close(got, w)
    if kind == "while_loop":
        _close(want[0].ravel(), [1.0, 3.0, 5.0, 0.0, 0.0, 0.0])
    if ex is not None:
        ex_args, j_grads = ex
        for got, w in zip(_executor_grads(mx, ex_args), j_grads):
            _close(got, w, 1e-5)


def _cell_run(lib, cell, x, B, H):
    nd = lib.nd

    def body(xt, h):
        out, new = cell(xt, [h])
        return out, new[0]

    outs, hN = nd.contrib.foreach(body, x, nd.zeros((B, H)))
    return outs, hN


def _jax_buckets(weights):
    cell = jmx.gluon.rnn.RNNCell(8, input_size=4)
    cell.initialize()
    for name, p in cell.collect_params().items():
        p.set_data(jmx.nd.array(weights[name.split("_", 1)[1]]))
    out = {}
    for T in (3, 5, 9):
        x = jmx.nd.array(onp.random.RandomState(T).randn(T, 2, 4)
                         .astype("float32"))
        out[T] = _np(_cell_run(jmx, cell, x, 2, 8)[1])
    return out


def test_bucketed_rnn_over_foreach_matches_jax_and_unroll():
    mx.random.seed(0)
    cell = mx.gluon.rnn.RNNCell(8, input_size=4)
    cell.initialize()
    params = cell.collect_params()
    want = _jax_buckets({name.split("_", 1)[1]: _np(p.data())
                         for name, p in params.items()})
    plist = [p for _, p in sorted(params.items())]
    for T in (3, 5, 9):
        x = mx.nd.array(onp.random.RandomState(T).randn(T, 2, 4)
                        .astype("float32"))
        grads = []
        for how in ("foreach", "unroll"):
            with mx.autograd.record():
                if how == "foreach":
                    outs, hN = _cell_run(mx, cell, x, 2, 8)
                    assert outs.shape == (T, 2, 8)
                else:
                    hN = mx.nd.zeros((2, 8))
                    for t in range(T):
                        _, hs = cell(x[t], [hN])
                        hN = hs[0]
                loss = hN.sum()
            loss.backward()
            grads.append([_np(p.grad()).copy() for p in plist])
            _close(hN, want[T], 2e-5)
        for ga, gb in zip(*grads):
            _close(ga, gb, 2e-5)
