"""PyTorch port: the ``RNN`` op, ``gluon.rnn`` and the word language model
loop, held against the JAX package on the CPU.

- The ``RNN`` op (``mx.nd.RNN``): four modes x {1, 2 layers} x {uni,
  bi}directional at T 7, with ``state_outputs``: outputs within 1e-5 and
  the gradients of every input (data, the flat parameters, the states)
  against ``jax.grad`` within 1e-4 of the largest (the port hoists the
  input projection out of the loop, so its sums round in another order).
- The ``LSTM``/``GRU``/``RNN`` layers (TNC and NTC, bidirectional, with
  and without states) and every cell's ``unroll`` (``valid_length``
  included), ``gluon.contrib.rnn``'s cells with them, the port's seeded
  weights moved to the JAX blocks by a ``.params`` file: outputs and
  states within 1e-5. Also the JAX test's cell-vs-fused-layer
  check (``tests/test_gluon.py:330``) on the port.
- ``lm_example`` against the JAX example's loop for 3 steps at dropout 0,
  both started from one ``.params`` file: the losses within 1e-4.
Blocks take explicit prefixes, so the name counters cannot shift names.
"""
import importlib.util
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon import rnn as jrnn
from incubator_mxnet_tpu.gluon.contrib import rnn as jcrnn
from incubator_mxnet_tpu.ops import nn as jnn
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.gluon import rnn
from incubator_mxnet_tpu_torch.gluon.contrib import rnn as crnn
from incubator_mxnet_tpu_torch.models import word_language_model as wlm
from incubator_mxnet_tpu_torch.ops import nn as pnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_TOL = 1e-4


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


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return onp.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{what}[{k}]")
        return
    assert g_shape(got) == g_shape(want), (what, got.shape, want.shape)
    err = float(onp.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, f"{what}: max error {err:.3e} > {tol}"


def g_shape(a):
    return tuple(onp.shape(a))


#: XLA:CPU's cheapest compile: each reference runs once, so compiling it
#: takes most of its time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _params(*blocks):
    """The JAX blocks' parameters, once each, in a fixed order."""
    seen, out = set(), []
    for b in blocks:
        for _, p in sorted(b.collect_params().items()):
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


def _traced(params, fn, train=False):
    """``run(pvals, *arrays)``: ``fn`` of JAX NDArrays with ``params``'
    values taken from ``pvals`` (trace proxies), a pure function of jax
    arrays. Eager JAX Gluon compiles each op on its first call; one jitted
    program over the proxies compiles once."""
    from incubator_mxnet_tpu.gluon import _trace
    from incubator_mxnet_tpu.gluon.block import _TRACING

    def run(pvals, *args):
        proxies = {id(p): jmx.nd.NDArray(v) for p, v in zip(params, pvals)}
        _TRACING.flag = True
        try:
            with jmx.autograd.pause(train_mode=train), \
                    _trace.TraceScope(proxies):
                out = fn(*[jmx.nd.NDArray(a) for a in args])
        finally:
            _TRACING.flag = False
        return jax.tree_util.tree_map(
            lambda v: v._data if isinstance(v, jmx.nd.NDArray) else v, out,
            is_leaf=lambda v: isinstance(v, jmx.nd.NDArray))
    return run


def _compiled(fn, *args):
    """``fn(*args)`` through one ``jax.jit`` at the cheapest compile."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _share(pblock, jblock):
    """Initialise ``pblock`` (seeded) and check that ``jblock`` names its
    parameters alike (both are built under the same prefixes); the JAX
    block is never initialised: its traced runs read the port's values
    (:func:`_values`), which spares the JAX initialisers and gradient
    buffers a compiled program per shape."""
    pblock.initialize()
    assert {k: p.shape for k, p in pblock.collect_params().items()} == \
        {k: p.shape for k, p in jblock.collect_params().items()}


def _values(params, *pblocks):
    """The port blocks' values of the JAX ``params``, by name."""
    vals = {k: p.data().asnumpy() for b in pblocks
            for k, p in b.collect_params().items()}
    return [vals[p.name] for p in params]


def _states(block, n):
    """Seeded initial states of ``block``'s shapes, as numpy arrays."""
    rng = onp.random.RandomState(n)
    return [rng.randn(*i["shape"]).astype("float32")
            for i in block.state_info(n)]


def test_rnn_op_matches_jax():
    """Every mode, depth and direction: outputs 1e-5, gradients 1e-4 of
    the largest (the JAX references of all 16 cases are one jitted
    program)."""
    rng = onp.random.RandomState(0)
    T, N, C, H = 7, 3, 5, 6
    cases = []
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for layers in (1, 2):
            for bi in (False, True):
                d = 2 if bi else 1
                size = jnn.rnn_param_size(mode, layers, C, H, bi)
                assert pnn.rnn_param_size(mode, layers, C, H, bi) == size
                args = [rng.randn(T, N, C).astype("float32"),
                        (0.3 * rng.randn(size)).astype("float32"),
                        rng.randn(layers * d, N, H).astype("float32"),
                        rng.randn(layers * d, N, H).astype("float32")]
                kw = dict(state_size=H, num_layers=layers, mode=mode,
                          bidirectional=bi, state_outputs=True)
                cases.append((f"{mode} layers={layers} bidirectional={bi}",
                              kw, args))

    def jloss(kw):
        def f(x, p, h, c):
            outs = jnn.rnn(x, p, h, c if kw["mode"] == "lstm" else None,
                           **kw)
            return sum(jnp.sum(jnp.sin(o)) for o in outs), outs
        return jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)

    refs = _compiled(lambda all_args: [jloss(kw)(*a) for (_, kw, _), a in
                                       zip(cases, all_args)],
                     [a for _, _, a in cases])
    for (case, kw, args), ((_, jouts), jgrads) in zip(cases, refs):
        lstm = kw["mode"] == "lstm"
        outs = nd.RNN(*[nd.array(a) for a in args[:3]],
                      *([nd.array(args[3])] if lstm else []), **kw)
        _close(list(outs), list(jouts), TOL, case)
        ts = [torch.tensor(a, requires_grad=True) for a in args]
        pouts = pnn.rnn(ts[0], ts[1], ts[2], ts[3] if lstm else None, **kw)
        sum(torch.sin(o).sum() for o in pouts).backward()
        for name, t, g in zip(("data", "params", "h0", "c0"), ts, jgrads):
            want = onp.asarray(g)
            got = t.grad.numpy() if t.grad is not None \
                else onp.zeros_like(want)
            scale = max(1.0, float(onp.abs(want).max()))
            _close(got / scale, want / scale, GRAD_TOL, f"{case} d{name}")


def test_rnn_layers_match_jax():
    """LSTM, GRU and RNN (relu, tanh) layers: TNC and NTC, one and two
    layers, bidirectional, without states and with ``begin_state``;
    parameter names and shapes as the JAX layers'."""
    rng = onp.random.RandomState(1)
    T, N, C, H = 6, 3, 4, 5
    cases = [("LSTM", dict(num_layers=2)),
             ("LSTM", dict(layout="NTC", bidirectional=True)),
             ("GRU", dict(num_layers=2, bidirectional=True)),
             ("GRU", dict(layout="NTC")),
             ("RNN", dict(activation="relu", num_layers=2)),
             ("RNN", dict(activation="tanh", bidirectional=True,
                          layout="NTC"))]
    jls, pls, inputs = [], [], []
    for k, (cls, kw) in enumerate(cases):
        jl = getattr(jrnn, cls)(H, input_size=C, prefix=f"layer{k}_", **kw)
        pl = getattr(rnn, cls)(H, input_size=C, prefix=f"layer{k}_", **kw)
        _share(pl, jl)
        assert [tuple(s.shape) for s in pl.begin_state(N)] == \
            [i["shape"] for i in jl.state_info(N)], cls
        shape = (N, T, C) if kw.get("layout") == "NTC" else (T, N, C)
        inputs.append([rng.randn(*shape).astype("float32")]
                      + _states(jl, N))
        jls.append(jl)
        pls.append(pl)

    def fn(*arrays):
        out, it = [], iter(arrays)
        for jl, args in zip(jls, inputs):
            a = [next(it) for _ in args]
            out.append([jl(a[0])] + list(jl(a[0], a[1:])))
        return out

    params = _params(*jls)
    refs = _compiled(_traced(params, fn), _values(params, *pls),
                     *[a for args in inputs for a in args])
    for (cls, kw), pl, args, want in zip(cases, pls, inputs, refs):
        x = nd.array(args[0])
        pout, pstates = pl(x, [nd.array(a) for a in args[1:]])
        _close([pl(x), pout] + pstates, [want[0], want[1]] + want[2],
               TOL, f"{cls} {kw}")


def _cells():
    """(name, JAX cell, port cell, has valid_length): every cell of
    ``gluon.rnn`` and ``gluon.contrib.rnn``, built alike."""
    def both(make):
        return make(jrnn, jcrnn), make(rnn, crnn)

    out = []
    for name, make in [
        ("RNNCell", lambda r, c: r.RNNCell(5, input_size=4,
                                           prefix="rnncell_")),
        ("RNNCell relu", lambda r, c: r.RNNCell(5, activation="relu",
                                                input_size=4,
                                                prefix="rnnrelu_")),
        ("LSTMCell", lambda r, c: r.LSTMCell(5, input_size=4,
                                             prefix="lstmcell_")),
        ("GRUCell", lambda r, c: r.GRUCell(5, input_size=4,
                                           prefix="grucell_")),
        ("ResidualCell", lambda r, c: r.ResidualCell(
            r.GRUCell(4, input_size=4, prefix="resbase_"))),
        ("ZoneoutCell", lambda r, c: r.ZoneoutCell(
            r.LSTMCell(5, input_size=4, prefix="zonebase_"), 0.5, 0.5)),
        ("DropoutCell", lambda r, c: r.DropoutCell(0.5, prefix="drop_")),
        ("LSTMPCell", lambda r, c: c.LSTMPCell(6, 3, input_size=4,
                                               prefix="lstmp_")),
        ("VariationalDropoutCell", lambda r, c: c.VariationalDropoutCell(
            r.LSTMCell(5, input_size=4, prefix="vdbase_"), 0.5, 0.5, 0.5)),
    ]:
        out.append((name,) + both(make))

    def seq(r, c):
        s = r.SequentialRNNCell(prefix="seq_")
        with s.name_scope():
            s.add(r.LSTMCell(5, input_size=4))
            s.add(r.DropoutCell(0.3))
            s.add(r.GRUCell(3, input_size=5))
        return s

    def bi(r, c):
        return r.BidirectionalCell(r.LSTMCell(5, input_size=4,
                                              prefix="bil_"),
                                   r.GRUCell(3, input_size=4,
                                             prefix="bir_"))
    out.append(("SequentialRNNCell",) + both(seq))
    out.append(("BidirectionalCell",) + both(bi))
    return out


def test_cells_unroll_match_jax():
    """Every cell unrolled over 4 steps (NTC without ``valid_length``, TNC
    with it, and a list of steps with given states, unmerged):
    outputs and states within 1e-5 (the dropout-type cells outside
    training, where they are exact); and the convolutional cells, 1-D to
    3-D, over 3 steps."""
    rng = onp.random.RandomState(2)
    N, T, C = 3, 4, 4
    x = rng.randn(N, T, C).astype("float32")
    vl = onp.array([4, 1, 3], "float32")
    variants = (("NTC", False), ("TNC", True))
    cells = _cells()
    conv = []
    for dims, spatial in ((1, (7,)), (2, (5, 6)), (3, (3, 4, 3))):
        for kind in ("RNN", "LSTM", "GRU"):
            name = f"Conv{dims}D{kind}Cell"
            kw = dict(input_shape=(2,) + spatial, hidden_channels=3,
                      i2h_kernel=3, h2h_kernel=3, prefix=f"c{dims}{kind}_")
            conv.append((name, getattr(jcrnn, name)(**kw),
                         getattr(crnn, name)(**kw),
                         rng.randn(2, 3, 2, *spatial).astype("float32")))
    for _, jc, pc, *_ in cells + conv:
        _share(pc, jc)
    states = [_states(jc, N) for _, jc, _ in cells]

    def fn(x, vl, *arrays):
        out, it = [], iter(arrays)
        for (_, jc, _), st in zip(cells, states):
            for layout, valid in variants:
                xin = x if layout == "NTC" else x.transpose((1, 0, 2))
                o, s = jc.unroll(T, xin, layout=layout, merge_outputs=True,
                                 valid_length=vl if valid else None)
                out.append([o] + list(s))
            given = [next(it) for _ in st]
            o, s = jc.unroll(T, [x[:, t] for t in range(T)],
                             begin_state=given, merge_outputs=False)
            out.append(list(o) + list(s))
        for _, jc, _, _ in conv:
            o, s = jc.unroll(3, next(it), merge_outputs=True)
            out.append([o] + list(s))
        return out

    params = _params(*[c[1] for c in cells + conv])
    refs = iter(_compiled(
        _traced(params, fn),
        _values(params, *[c[2] for c in cells + conv]), x, vl,
        *[a for st in states for a in st], *[c[3] for c in conv]))
    for (name, _, pc), st in zip(cells, states):
        for layout, valid in variants:
            xin = x if layout == "NTC" else x.transpose(1, 0, 2)
            o, s = pc.unroll(T, nd.array(xin), layout=layout,
                             merge_outputs=True,
                             valid_length=nd.array(vl) if valid else None)
            _close([o] + list(s), next(refs), TOL,
                   f"{name} {layout} valid_length={valid}")
        o, s = pc.unroll(T, [nd.array(x[:, t]) for t in range(T)],
                         begin_state=[nd.array(a) for a in st],
                         merge_outputs=False)
        _close(list(o) + list(s), next(refs), TOL, name + " list")
    for name, _, pc, xin in conv:
        o, s = pc.unroll(3, nd.array(xin), merge_outputs=True)
        _close([o] + list(s), next(refs), TOL, name)


def test_lstm_cell_matches_fused_layer():
    """The JAX test's check (``tests/test_gluon.py:330``) on the port: the
    cell unrolled equals the one-layer fused LSTM with its weights; and
    gradients flow to the layer's parameters."""
    hidden, T, N, C = 6, 4, 2, 3
    cell = rnn.LSTMCell(hidden, input_size=C, prefix="cellvs_")
    cell.initialize()
    layer = rnn.LSTM(hidden, num_layers=1, input_size=C, prefix="layervs_")
    layer.initialize()
    layer.l0_i2h_weight.set_data(cell.i2h_weight.data())
    layer.l0_h2h_weight.set_data(cell.h2h_weight.data())
    layer.l0_i2h_bias.set_data(nd.array(onp.linspace(-1, 1, 4 * hidden)
                                        .astype("float32")))
    cell.i2h_bias.set_data(layer.l0_i2h_bias.data())
    x = nd.array(onp.random.RandomState(4).randn(T, N, C)
                 .astype("float32"))
    outs, _ = cell.unroll(T, x, layout="TNC", merge_outputs=True)
    _close(layer(x), outs, TOL, "cell vs layer")
    with mx.autograd.record():
        loss = layer(x).sum()
    loss.backward()
    assert float(layer.l0_i2h_weight.grad().abs().sum().asscalar()) > 0


def _jax_example():
    path = os.path.join(REPO, "examples", "word_language_model.py")
    spec = importlib.util.spec_from_file_location("_jax_wlm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lm_example_matches_jax():
    """``lm_example`` against the JAX example's loop (its ``RNNModel`` with
    the tied decoder, corpus, ``SoftmaxCrossEntropyLoss``,
    ``clip_global_norm`` and SGD at rate 5), 3 steps at dropout 0 from one
    ``.params`` file: losses within 1e-4. The JAX model's loss and
    gradients are one jitted ``jax.value_and_grad`` over its traced
    parameters (what its autograd tape records); the clip is the JAX
    ``gluon.utils.clip_global_norm``; the update is the JAX SGD
    optimizer's ``update`` per parameter, which is what the JAX
    ``Trainer.step(1)`` runs on one context (``gluon/trainer.py:184``). The
    JAX block is never initialised (its traced runs read the port's
    values), so there is no JAX ``Trainer`` over its parameters."""
    ex = _jax_example()
    V, E, steps, bptt, B = 50, 16, 3, 8, 4
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "lm.params")
        mx.random.seed(0)
        pm = wlm.RNNModel(V, E, E, 2, dropout=0.0, prefix="rnnmodel_")
        pm.initialize()
        pm.save_parameters(f)
        # the tied decoder: one parameter, so one update a step
        assert pm.decoder.weight is pm.encoder.weight
        assert sum(p is pm.encoder.weight
                   for p in pm.collect_params().values()) == 1
        jm = ex.RNNModel(V, E, E, 2, dropout=0.0, prefix="rnnmodel_")
        got = wlm.lm_example(vocab=V, emsize=E, nhid=E, nlayers=2,
                             bptt=bptt, batch_size=B, steps=steps, epochs=1,
                             lr=5.0, clip=0.25, dropout=0.0, params=f,
                             seed=0, ctx=mx.cpu())
    params = _params(jm)
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(data, target, h, c):
        logits, states = jm(data, [h, c])
        return loss_fn(logits.reshape((-1, V)), target).mean(), states

    run = _traced(params, forward)
    rng = onp.random.RandomState(7)
    corpus = ex.batchify(ex.make_corpus((steps * bptt + 1) * B + 1, V, rng),
                         B)
    pvals = _values(params, pm)
    h, c = [onp.zeros(i["shape"], "float32")
            for i in jm.rnn.state_info(B)]
    grad_fn = jax.value_and_grad(
        lambda pv, *a: run(pv, *a), has_aux=True)
    # the JAX Trainer("sgd").step(1) on one context: this update per
    # parameter at rescale_grad 1
    sgd = jmx.optimizer.create("sgd", learning_rate=5.0, rescale_grad=1.0)
    compiled, want = None, []
    for step in range(steps):
        data = corpus[step * bptt:(step + 1) * bptt]
        target = corpus[step * bptt + 1:(step + 1) * bptt + 1] \
            .reshape(-1).astype("float32")
        args = (pvals, data, target, h, c)
        if compiled is None:
            compiled = jax.jit(grad_fn).lower(*args).compile(FAST_COMPILE)
        (loss, (h, c)), grads = compiled(*args)
        grads = [jmx.nd.array(onp.asarray(g)) for g in grads]
        jmx.gluon.utils.clip_global_norm(grads, 0.25)
        weights = [jmx.nd.array(w) for w in pvals]
        for i, (w, g) in enumerate(zip(weights, grads)):
            sgd.update(i, w, g, ())
        pvals = [w.asnumpy() for w in weights]
        want.append(float(loss))
    onp.testing.assert_allclose(got["losses"], want, rtol=0, atol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
