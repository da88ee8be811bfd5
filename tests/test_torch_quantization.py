"""PyTorch port: int8 quantization held against the JAX package on the CPU.

The same numpy inputs go through the JAX package's ``ops/quantization.py``
and ``quantization/`` and the port's: every op (integer outputs equal,
float outputs within 1e-6: the same float32 operations in the same
order), the calibration collectors and the Observer, ``quantize_net`` on a
conv + dense net and on the ``bert_encoder`` smoke model (the port's
weights moved across in a ``.params`` file): the same swapped layers,
bitwise-equal int8 weights, calibrated ranges within 16 float32 ulps
(a range is one activation's value, and the two float32 forwards agree to
a few ulps; ranges from one shared table are equal) and outputs within
one int8 step of the widest calibrated input range (an activation that
lands on the other side of a rounding edge moves one step); a JAX
Observer table quantizes the port's model to the same int8 weights. Then the port alone: ``quantize_model`` leaves the original
serving bitwise as before with no compile after warmup, the
``quantized_smoke`` accuracy gates of the JAX package's
``tests/test_quantization.py:298`` (lenet 0.08, bert_encoder 0.05), and
calibration on a hybridized net, which must run its blocks eagerly.

At most 8 tests, several cases each: a file of more tests than
``tests/test_examples.py`` would be handed to an xdist worker before it
under ``--dist loadfile`` and lengthen the suite.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import quantization as jquant
from incubator_mxnet_tpu.ops import quantization as jq

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, models, nd, quantization
from incubator_mxnet_tpu_torch.contrib import nd as contrib_nd
from incubator_mxnet_tpu_torch.ops import quantization as tq

FLOAT_TOL = 1e-6
#: a calibrated range is one activation's value, and the two packages'
#: float32 forwards agree to a few ulps through two layers (their GEMMs sum
#: in another order; up to 5 ulps seen): 16 ulps is 1e-6 relative
RANGE_ULPS = 16
#: the two forwards' magnitude histograms of one layer's input: a value
#: within a few ulps of a power of two may fall in the neighbouring bucket
#: on one side (seen: one of ~16,000); at most this share of the values
#: moves
HIST_MOVED = 1e-4
#: the quantized smoke twins' mean relative error bounds, the JAX
#: package's (``tests/test_quantization.py:298``)
GATES = {"lenet": 0.08, "bert_encoder": 0.05}


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
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return onp.asarray(x)


def _same(got, want, name):
    """Integer outputs equal, float outputs within :data:`FLOAT_TOL`."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    if want.dtype.kind in "iub":
        assert got.dtype == want.dtype, name
        onp.testing.assert_array_equal(got, want, err_msg=name)
    else:
        onp.testing.assert_allclose(got.astype("float64"),
                                    want.astype("float64"), rtol=0,
                                    atol=FLOAT_TOL, err_msg=name)


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype("int8")


def test_quantize_ops_match_jax():
    """quantize (int8, uint8; host and array ranges), quantize_v2 (online
    and calibrated), dequantize (int8, uint8, the int32 accumulator) and
    requantize (calibrated, online), with values on rounding edges."""
    rng = onp.random.RandomState(0)
    x = (rng.randn(6, 33) * 3).astype("float32")
    x[0, :8] = onp.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.5, 1e-3, 0.0]) \
        * (4.0 / 127)                               # half steps: to even
    for lo, hi in ((-4.0, 4.0), (x.min(), x.max()), (0.0, 0.0), (-1e-3, 2)):
        for out in ("int8", "uint8"):
            want = jq.quantize(x, lo, hi, out_type=out)
            got = tq.quantize(_t(x), lo, hi, out_type=out)
            for g, w, n in zip(got, want, ("q", "min", "max")):
                _same(g, w, f"quantize {out} [{lo}, {hi}] {n}")
            got = tq.quantize(_t(x), torch.tensor(lo), torch.tensor(hi),
                              out_type=out)
            _same(got[0], want[0], f"quantize {out}, tensor range")
            back = tq.dequantize(got[0], lo, hi)
            _same(back, jq.dequantize(want[0], lo, hi),
                  f"dequantize {out} [{lo}, {hi}]")
    for calib in ((None, None), (-2.0, 3.0)):
        want = jq.quantize_v2(x, *calib)
        got = tq.quantize_v2(_t(x), *calib)
        for g, w, n in zip(got, want, ("q", "min", "max")):
            _same(g, w, f"quantize_v2 {calib} {n}")
    acc = rng.randint(-2 ** 30, 2 ** 30, (5, 7)).astype("int32")
    for rng_ in ((-3e-5, 3e-5), (-1.0, 2.0)):
        _same(tq.dequantize(_t(acc), *rng_), jq.dequantize(acc, *rng_),
              f"dequantize int32 {rng_}")
        for calib in ((None, None), (-0.5, 0.25)):
            want = jq.requantize(acc, *rng_, *calib)
            got = tq.requantize(_t(acc), *rng_, *calib)
            for g, w, n in zip(got, want, ("q", "min", "max")):
                _same(g, w, f"requantize {rng_} {calib} {n}")
    # the mx.nd namespace and the _contrib_ aliases
    q, lo, hi = nd.quantize(nd.array(x), nd.array(x.min()), nd.array(x.max()))
    _same(q.asnumpy(), jq.quantize(x, x.min(), x.max())[0], "nd.quantize")
    for name in tq.OPS:
        assert getattr(nd, "_contrib_" + name) is getattr(nd, name)
        assert getattr(contrib_nd, name) is getattr(nd, name)


def test_quantized_compute_ops_match_jax():
    """quantized_fully_connected (bias, no bias, 3-D input flattened or
    not, an inner size that is not a multiple of 8), quantized_conv
    (bias, stride, padding, dilation), quantized_pooling (max and avg,
    padded, int8 and uint8), quantized_flatten and quantized_act."""
    rng = onp.random.RandomState(1)
    r = dict(min_data=-2.5, max_data=3.0, min_weight=-0.7, max_weight=0.6,
             min_bias=-0.2, max_bias=0.1)
    for shape, flatten in (((4, 13), True), ((2, 5, 16), False),
                           ((2, 3, 4), True)):
        k = shape[-1] if not flatten else int(onp.prod(shape[1:]))
        data, w, b = _int8(rng, *shape), _int8(rng, 6, k), _int8(rng, 6)
        for bias in (b, None):
            want = jq.quantized_fully_connected(
                data, w, bias, *r.values(), num_hidden=6,
                no_bias=bias is None, flatten=flatten)
            got = tq.quantized_fully_connected(
                _t(data), _t(w), None if bias is None else _t(bias),
                *r.values(), num_hidden=6, no_bias=bias is None,
                flatten=flatten)
            for g, wt, n in zip(got, want, ("acc", "min", "max")):
                _same(g, wt, f"fc {shape} flatten={flatten} bias="
                             f"{bias is not None} {n}")
            _same(tq.dequantize(got[0], got[1], got[2]),
                  jq.dequantize(*want), f"fc {shape} dequantized")
    data = _int8(rng, 2, 3, 9, 8)
    for kw in (dict(stride=(1, 1), pad=(0, 0), dilate=(1, 1)),
               dict(stride=(2, 1), pad=(1, 2), dilate=(1, 1)),
               dict(stride=(1, 2), pad=(2, 1), dilate=(2, 1))):
        w, b = _int8(rng, 5, 3, 3, 2), _int8(rng, 5)
        for bias in (b, None):
            want = jq.quantized_conv(data, w, bias, *r.values(),
                                     no_bias=bias is None, **kw)
            got = tq.quantized_conv(_t(data), _t(w),
                                    None if bias is None else _t(bias),
                                    *r.values(), no_bias=bias is None, **kw)
            for g, wt, n in zip(got, want, ("acc", "min", "max")):
                _same(g, wt, f"conv {kw} bias={bias is not None} {n}")
    for dt in ("int8", "uint8"):
        data = (_int8(rng, 2, 3, 7, 6) if dt == "int8"
                else rng.randint(0, 256, (2, 3, 7, 6)).astype("uint8"))
        data[0, 0] = -128 if dt == "int8" else 0
        for kw in (dict(kernel=(2, 2)), dict(kernel=(3, 3), stride=(2, 2),
                                             pad=(1, 1)),
                   dict(kernel=(3, 2), stride=(1, 2), pad=(1, 0))):
            for pool in ("max", "avg"):
                want = jq.quantized_pooling(data, -1.0, 1.0, pool_type=pool,
                                            **kw)
                got = tq.quantized_pooling(_t(data), -1.0, 1.0,
                                           pool_type=pool, **kw)
                _same(got[0], want[0], f"pooling {dt} {pool} {kw}")
    data = _int8(rng, 2, 3, 4, 5)
    _same(tq.quantized_flatten(_t(data), -1.0, 1.0)[0],
          jq.quantized_flatten(data, -1.0, 1.0)[0], "flatten")
    want = jq.quantized_act(data, -1.5, 2.0)
    got = tq.quantized_act(_t(data), -1.5, 2.0)
    for g, w, n in zip(got, want, ("out", "min", "max")):
        _same(g, w, f"act {n}")
    with pytest.raises(ValueError, match="relu"):
        tq.quantized_act(_t(data), -1.0, 1.0, act_type="tanh")
    with pytest.raises(TypeError, match="int8"):
        tq.int_matmul(_t(data.reshape(6, -1)).int(), _t(data.reshape(6, -1)))


def test_calibration_matches_jax(monkeypatch):
    """optimal_threshold, LayerRangeCollector (naive, entropy with a range
    that widens between batches), the Observer (merge, thresholds,
    ranges, table round trip, support mismatch) and the percentile knob."""
    rng = onp.random.RandomState(2)
    hist = rng.randint(0, 50, 1001).astype("float64")
    edges = onp.linspace(-3, 3, 1002)
    assert quantization.optimal_threshold(hist, edges) == \
        jquant.optimal_threshold(hist, edges)
    batches = [rng.randn(64, 8).astype("float32") * s for s in (1, 3, 0.5)]
    for mode in ("naive", "entropy"):
        cols = [quantization.LayerRangeCollector(mode, num_bins=401),
                jquant.LayerRangeCollector(mode, num_bins=401)]
        for b in batches:
            for c in cols:
                c.collect("l", b)
        assert cols[0].ranges() == cols[1].ranges(), mode
    with pytest.raises(mx.MXNetError, match="calib_mode"):
        quantization.LayerRangeCollector("kl")
    obs = [quantization.Observer(), jquant.Observer()]
    for i, b in enumerate(batches):
        counts = rng.randint(0, 100, 40).astype("float64")
        for o in obs:
            o.update("act:dense0", counts, -24, amin=float(b.min()),
                     amax=float(b.max()), samples=2)
            o.update(f"site{i}", counts[::-1].copy(), -20)
    table = obs[1].to_table()
    assert obs[0].to_table() == table
    assert quantization.Observer(table).to_table() == table
    for p in (99.0, 99.99, 100.0):
        assert obs[0].ranges(p) == obs[1].ranges(p)
    with pytest.raises(mx.MXNetError, match="incompatible"):
        obs[0].update("site0", onp.ones(10), -20)
    assert quantization._quant_percentile(None) == 99.99
    assert quantization._quant_percentile(99.5) == 99.5
    monkeypatch.setenv("MXTPU_QUANT_PERCENTILE", "99.9")
    assert quantization._quant_percentile(None) == \
        jquant._quant_percentile(None) == 99.9


def _conv_dense(g, classes=3):
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Conv2D(4, kernel_size=3, activation="relu",
                            in_channels=1),
                g.nn.MaxPool2D(2, 2), g.nn.Flatten(),
                g.nn.Dense(8, activation="tanh", in_units=64),
                g.nn.Dense(classes, in_units=8))
    return net


def _dense(g):
    """One Dense layer behind a Flatten: the entropy case (its 8001-bin
    threshold search costs ~0.6 s a layer in each package)."""
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Flatten(), g.nn.Dense(3, in_units=100))
    return net


def _swapped(net):
    """prefix-relative name -> (layer class, int8 constants, range) of each
    quantized layer, and the nets' other parameters."""
    n = len(net.prefix)
    out = {}
    for b in net.modules() if isinstance(net, torch.nn.Module) \
            else _jax_blocks(net):
        if hasattr(b, "_range"):
            consts = {k[len(b.prefix):]: p.data().asnumpy()
                      for k, p in b.collect_params().items()}
            out[b.name[n:]] = (type(b).__name__, consts, b._range)
    return out


def _jax_blocks(b):
    yield b
    for c in b._children.values():
        yield from _jax_blocks(c)


def _ulps(a, b) -> int:
    """Distance of two float32 values of one sign in units in the last
    place."""
    a, b = onp.float32(a), onp.float32(b)
    return abs(int(a.view("int32")) - int(b.view("int32")))


def _compare_quantized(jnet, pnet, args, what, max_ulps):
    """Swapped layers, int8 weights and ranges (within ``max_ulps``) of
    the two quantized nets, then their outputs on ``args`` within one
    int8 step."""
    js, ps = _swapped(jnet), _swapped(pnet)
    assert sorted(js) == sorted(ps) and js, what
    for name, (kind, consts, rng_) in js.items():
        pkind, pconsts, prng = ps[name]
        assert kind == pkind, (what, name)
        assert sorted(consts) == sorted(pconsts), (what, name)
        onp.testing.assert_array_equal(pconsts["qweight"], consts["qweight"],
                                       err_msg=f"{what} {name}")
        assert all(_ulps(a, b) <= max_ulps for a, b in zip(prng, rng_)), \
            (what, name, prng, rng_)
    want = jnet(*[jmx.nd.array(a) for a in args])
    got = pnet(*[nd.array(a) for a in args])
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    # an activation on the other side of a rounding edge moves one int8
    # step: the step of the widest calibrated input range
    step = max(max(abs(v) for v in r[2]) for r in ps.values()) / 127
    for i, (w, g) in enumerate(zip(want, got)):
        onp.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=0,
                                    atol=step, err_msg=f"{what} {i}")


def test_quantize_net_conv_dense_matches_jax(tmp_path):
    """A conv + dense net quantized by both packages from the same weights
    and calibration batches (naive, and with one layer excluded; entropy
    on a one-Dense net): outputs within one int8 step (observed: within
    2.4e-07). The int8 bias: the
    port's ``qbias`` holds the quantized bias; the JAX package's comes
    out zeros (its ``Constant`` initialiser fills ``*bias`` names with
    zeros; ROADMAP queue C), so outputs are compared on zero biases and
    the port's own bias is checked against ``_q8``."""
    rng = onp.random.RandomState(3)
    x = rng.randn(2, 1, 10, 10).astype("float32")
    calib = [rng.randn(2, 1, 10, 10).astype("float32") for _ in range(2)]
    for mode, exclude in (("naive", ()), ("naive", ("dense1",)),
                          ("entropy", ())):
        make = _conv_dense if mode == "naive" else _dense
        pnet = make(gluon)
        pnet.initialize()
        f = str(tmp_path / f"{mode}{len(exclude)}.params")
        pnet.save_parameters(f)
        jnet = make(jgluon)
        jnet.load_parameters(f)
        jquant.quantize_net(jnet, calib_data=[jmx.nd.array(c) for c in calib],
                            calib_mode=mode,
                            exclude_layers=[jnet.prefix + e for e in exclude])
        quantization.quantize_net(pnet, calib_data=[nd.array(c)
                                                    for c in calib],
                                  calib_mode=mode,
                                  exclude_layers=[pnet.prefix + e
                                                  for e in exclude])
        kinds = [type(c).__name__ for c in pnet._children.values()]
        if mode == "naive":
            assert kinds[0] == "QuantizedConv2D" and kinds[3] == \
                "QuantizedDense" and kinds[4] == (
                    "Dense" if exclude else "QuantizedDense"), kinds
        _compare_quantized(jnet, pnet, [x], f"conv+dense {mode}",
                           RANGE_ULPS)
    # a nonzero bias: the port's qbias is the bias's int8 encoding
    pnet = _conv_dense(gluon)
    pnet.initialize()
    bias = rng.randn(3).astype("float32")
    pnet[4].bias.set_data(nd.array(bias))
    quantization.quantize_net(pnet, calib_data=[nd.array(c) for c in calib])
    onp.testing.assert_array_equal(pnet[4].qbias.data().asnumpy(),
                                   quantization._q8(bias)[0])
    with pytest.raises(mx.MXNetError, match="calib_data"):
        quantization.quantize_net(pnet)
    with pytest.raises(mx.MXNetError, match="int8"):
        quantization.quantize_net(pnet, [x], quantized_dtype="uint8")


@pytest.fixture(scope="module")
def bert_pair(tmp_path_factory):
    """The ``bert_encoder`` smoke model (``bert_2_128_2``, vocabulary
    1000) in the JAX package, holding the port's seeded weights (a
    ``.params`` file), and the calibration and test batches."""
    f = str(tmp_path_factory.mktemp("bert") / "bert.params")
    _port_bert().save_parameters(f)
    jnet = jmodels.get_bert("bert_2_128_2", vocab_size=1000, max_length=32,
                            dropout=0.1, use_decoder=False,
                            use_classifier=False)
    jnet.load_parameters(f)
    rng = onp.random.RandomState(4)

    def batch(B=2, L=16):
        return [rng.randint(0, 32, (B, L)).astype("int32"),
                rng.randint(0, 2, (B, L)).astype("int32"),
                onp.array([L, L // 2 + 1][:B], "float32")]

    return {"jnet": jnet, "calib": batch(), "test": batch()}


def _port_bert():
    """The port's smoke model, its weights drawn from the seeded default
    generator (the same in every build)."""
    return models.get_bert("bert_2_128_2", vocab_size=1000, max_length=32,
                           dropout=0.1, use_decoder=False,
                           use_classifier=False, device="cpu")


def test_quantize_net_bert_encoder_matches_jax(bert_pair):
    """The bert_encoder smoke model calibrated by ``observe_net`` in both
    packages (Observer path, percentile 99.99): the same 9 QuantizedDense
    layers (qkv, proj, ffn1, ffn2 per layer, the pooler), the same
    magnitude histograms but for :data:`HIST_MOVED` of the values, int8
    weights equal, ranges within :data:`RANGE_ULPS`; outputs within one
    int8 step (~0.03 at these ranges; observed within 1.2e-06).
    Then the JAX Observer's table quantizes a fresh port model to the same
    int8 weights and the same ranges, bit for bit."""
    jnet, calib = bert_pair["jnet"], bert_pair["calib"]
    pnet = _port_bert()
    jobs = jquant.observe_net(jnet, [[jmx.nd.array(a) for a in calib]])
    pobs = quantization.observe_net(pnet, [[nd.array(a) for a in calib]])
    n, jn = len(pnet.prefix), len(jnet.prefix)
    jtable = {k[jn:]: v for k, v in jobs.to_table().items()}
    ptable = {k[n:]: v for k, v in pobs.to_table().items()}
    assert sorted(jtable) == sorted(ptable) and len(ptable) == 9
    for k in jtable:
        got, want = (onp.array(t[k]["counts"]) for t in (ptable, jtable))
        moved = onp.abs(got - want).sum()
        assert moved <= 2 * onp.ceil(HIST_MOVED * want.sum()), (k, moved)
    jquant.quantize_net(jnet, calib_data=jobs)
    quantization.quantize_net(pnet, calib_data=pobs)
    assert sum(isinstance(b, quantization.QuantizedDense)
               for b in pnet.modules()) == 9
    _compare_quantized(jnet, pnet, bert_pair["test"], "bert_encoder",
                       RANGE_ULPS)
    # the JAX table, renamed to the port model's prefix, on a fresh model
    fresh = _port_bert()
    table = {fresh.prefix + k: v for k, v in jtable.items()}
    quantization.quantize_net(fresh, calib_data=table)
    _compare_quantized(jnet, fresh, bert_pair["test"],
                       "bert_encoder from the JAX table", 0)


def test_quantize_model_leaves_original_serving():
    """``quantize_model``: a new CompiledModel over an int8 copy (same
    table, axes, pad values); the original's outputs bitwise as before;
    no compile after warmup on either; every Dense of the twin swapped;
    refusals of what it does not take."""
    sm = models.hlo_smoke("bert_encoder", device="cpu")
    cm = sm["compiled"]
    args = models.calib_args("bert_encoder", seed=3, device="cpu")
    cm.warmup()
    before = [o.asnumpy() for o in cm.predict(*args)]
    obs = quantization.observe_net(sm["block"], [args])
    qcm = quantization.quantize_model(cm, obs)
    assert qcm is not cm and qcm._block is not cm._block
    assert qcm._table is cm._table and qcm._input_axes == cm._input_axes \
        and qcm._output_axes == cm._output_axes \
        and qcm._pad_values == cm._pad_values
    qcm.warmup()
    got = qcm.predict(*args)
    after = cm.predict(*args)
    for a, b in zip(before, after):
        assert onp.array_equal(a, b.asnumpy())
    assert all(onp.isfinite(g.asnumpy()).all() for g in got)
    assert cm.cache_info()["post_warmup_compiles"] == 0
    assert qcm.cache_info()["post_warmup_compiles"] == 0
    assert not any(isinstance(b, quantization.QuantizedDense)
                   for b in cm._block.modules())
    dense = [b for b in qcm._block.modules() if isinstance(b, gluon.nn.Dense)]
    assert not dense and sum(isinstance(b, quantization.QuantizedDense)
                             for b in qcm._block.modules()) == 9
    with pytest.raises(mx.MXNetError, match="CompiledModel"):
        quantization.quantize_model(sm["block"], obs)
    with pytest.raises(mx.MXNetError, match="Observer"):
        quantization.quantize_model(cm, {})


def test_quantized_smoke_accuracy_gate():
    """The JAX package's gate (``tests/test_quantization.py:298``): each
    quantized serving twin within its tolerance (lenet 0.08, bert_encoder
    0.05) of mean relative error against its float twin on seeded inputs;
    every quantizable family's smoke model quantizes."""
    assert set(models.QUANT_FAMILIES) == set(jmodels.QUANT_FAMILIES)
    for family in models.QUANT_FAMILIES:
        qsm = models.quantized_smoke(family, device="cpu")
        assert any(isinstance(b, quantization._QuantizedLayerBase)
                   for b in qsm["block"].modules()), family
        if family not in GATES:
            continue
        args = models.calib_args(family, seed=5, device="cpu")
        want = qsm["f32"]["compiled"].predict(*args)
        got = qsm["compiled"].predict(*args)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for w, g in zip((w._data for w in want), (g._data for g in got)):
            rel = ((w - g).abs().mean() / (w.abs().mean() + 1e-6)).item()
            assert rel < GATES[family], (family, rel)


def test_calibration_runs_a_hybridized_net_eagerly():
    """The counterpart of the JAX package's
    ``tests/test_quantization.py:164``: calibration of a hybridized net
    runs every block eagerly (its cached op would replay CUDA graphs,
    which run no pre-hook), restores ``hybridize()`` after, sees the same
    ranges as the plain net, and the quantized net then runs."""
    rng = onp.random.RandomState(8)
    x = rng.randn(2, 1, 10, 10).astype("float32")
    calib = [nd.array(rng.randn(2, 1, 10, 10).astype("float32"))]
    nets = []
    for hybrid in (False, True):
        mx.random.seed(43)
        net = _conv_dense(gluon)
        net.initialize()
        if hybrid:
            net.hybridize()
        net(nd.array(x))
        nets.append(net)
    seen = []
    nets[1][3].register_forward_pre_hook(
        lambda blk, inputs: seen.append([b._active for b in nets[1].modules()
                                         if hasattr(b, "_active")]))
    ranges = [quantization.observe_net(n, calib).ranges() for n in nets]
    n0, n1 = len(nets[0].prefix), len(nets[1].prefix)
    assert {k[n0:]: v for k, v in ranges[0].items()} == \
        {k[n1:]: v for k, v in ranges[1].items()}
    assert seen and not any(any(s) for s in seen)
    assert all(b._active for b in nets[1].modules() if hasattr(b, "_active")
               and not isinstance(b, quantization.QuantizedDense))
    quantization.quantize_net(nets[1], calib_data=calib)
    assert isinstance(nets[1][0], quantization.QuantizedConv2D)
    assert nets[1]._cached_ops == {}
    want, got = nets[0](nd.array(x)).asnumpy(), nets[1](nd.array(x)).asnumpy()
    err = onp.abs(got - want).mean() / (onp.abs(want).mean() + 1e-6)
    assert err < 0.15, err              # the JAX test's bound
