"""PyTorch port: ``serve.ModelRegistry`` and the serving result types, held
against the JAX package on the CPU.

- ``CompiledModel.predict`` returns NDArrays and a batcher's futures numpy
  rows, as the JAX package's do (``serve/compiled.py:379``,
  ``serve/batcher.py:440``), so MXNet code such as
  ``reg.get(name).predict(x).asnumpy()`` runs unchanged.
- ``make_registry_batcher``, a version swap, a pinned version and an
  unload: the served rows equal the JAX registry's over the same
  ``bert_2_128_2`` weights (float32, atol 1e-5; the two packages sum in
  another order, observed ~1e-6).
- ``ckpt_root=`` from a checkpoint the JAX ``gluon.Trainer`` wrote (names
  under another instance prefix), and the JAX registry loading one the
  port's ``gluon.Trainer`` wrote.
- A chaos-failed load and a hung loader (``deadline_s``) each keep the
  active version serving; ``apply_weights`` keeps every parameter's
  ``data_ptr``; the ``MXTPU_HBM_BUDGET`` preflight rejects a load.
- A loader left stuck inside a capture past its deadline holds the card's
  capture stream: a later capture waits ``CAPTURE_WAIT_S`` and raises
  naming it, instead of blocking for good.
"""
import threading

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import serve as jserve

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, models, nd, serve
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.fault import inject
from incubator_mxnet_tpu_torch.fault.retry import RetryExhausted, RetryPolicy

ATOL = 1e-5
VOCAB, MAXLEN = 60, 32
TABLE = {"batch": (1, 2), "seq": (8, 8)}
SPEC = models.serve_spec("bert_encoder")
EXAMPLE = (onp.ones((1, 8), "int32"), onp.zeros((1, 8), "int32"),
           onp.full((1,), 8, "float32"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(n=3, seed=0):
    rng = onp.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        L = int(rng.randint(3, 9))
        reqs.append((rng.randint(1, VOCAB, L).astype("int32"),
                     (onp.arange(L) >= L // 2).astype("int32"),
                     onp.array(L, "float32")))
    return reqs


def _one(req):
    """A single request as a batch of one."""
    return [onp.asarray(a)[None] for a in req]


def _perturbed(arrays, seed):
    rng = onp.random.RandomState(seed)
    return {k: (v + 0.05 * rng.randn(*v.shape)).astype(v.dtype)
            for k, v in arrays.items()}


def _port_bert(arrays, prefix=None):
    kw = {} if prefix is None else {"prefix": prefix}
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                          max_length=MAXLEN, dropout=0.0, use_decoder=False,
                          use_classifier=False, device="cpu", **kw)
    return params_from_jax(net, arrays)


def _load_kw(kind=serve):
    return dict(table=kind.BucketTable(TABLE),
                input_axes=SPEC["input_axes"],
                output_axes=SPEC["output_axes"],
                pad_values=SPEC["pad_values"])


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    """One JAX ``bert_2_128_2`` (prefix ``bert_``) and its registry:
    v1 over weights A; v2 over weights B, which the JAX ``gluon.Trainer``
    also writes as a checkpoint; v3 over weights C from a checkpoint the
    port's ``gluon.Trainer`` wrote. The JAX outputs of every request under
    each version (one compile each: every request falls in bucket
    (1, 8))."""
    root = tmp_path_factory.mktemp("registry")
    jmx.random.seed(0)
    jnet = jmodels.get_bert("bert_2_128_2", vocab_size=VOCAB,
                            max_length=MAXLEN, dropout=0.0,
                            use_decoder=False, use_classifier=False,
                            prefix="bert_")
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    jnet(*(jnd.array(x) for x in EXAMPLE))
    params = jnet.collect_params()
    A = {k: p.data().asnumpy() for k, p in params.items()}
    B, C = _perturbed(A, 1), _perturbed(A, 2)
    reqs = _requests()
    jreg = jserve.ModelRegistry()
    kw = dict(_load_kw(jserve), factory=lambda: jnet, analyze=False,
              warmup=False)

    def outputs():
        return [tuple(o.asnumpy()[0] for o in jreg.get("bert").predict(
            *_one(r))) for r in reqs]

    jreg.load("bert", **kw)                       # v1: A
    want = {"A": outputs()}
    for k, p in params.items():
        p.set_data(jnd.array(B[k]))
    jax_root = str(root / "jax")
    jgluon.Trainer(params, "sgd").save_checkpoint(jax_root)
    jreg.load("bert", **kw)                       # v2: B
    want["B"] = outputs()
    port_root = str(root / "port")
    with mx.cpu():
        gluon.Trainer(_port_bert(C, prefix="bert_").collect_params(),
                      "sgd").save_checkpoint(port_root)
    jreg.load("bert", ckpt_root=port_root, **kw)  # v3: C
    want["C"] = outputs()
    return {"A": A, "B": B, "C": C, "reqs": reqs, "want": want,
            "jax_root": jax_root}


def _close(got, want):
    for g, w in zip(got, want):
        assert isinstance(g, onp.ndarray) and g.shape == w.shape
        onp.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def _dense(seed=0):
    with mx.cpu():
        mx.random.seed(seed)
        net = gluon.nn.Dense(4, in_units=8)
        net.initialize()
        net(nd.array(onp.zeros((2, 8), "float32")))
    return net


def test_result_types_are_the_jax_packages():
    """``predict`` gives NDArrays on the model's device; a future gives
    numpy rows; ``reg.get(name).predict(x).asnumpy()`` works."""
    net = _dense()
    x = onp.random.RandomState(0).randn(2, 8).astype("float32")
    cm = serve.CompiledModel(net, serve.BucketTable({"batch": (1, 2)}),
                             [{0: "batch"}])
    cm.warmup()
    out = cm.predict(x)
    assert isinstance(out, nd.NDArray) and out.context == mx.cpu()
    with torch.no_grad():
        want = net(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(out.asnumpy(), want, rtol=1e-6)
    b = serve.DynamicBatcher(cm, max_delay_ms=1).start()
    try:
        row = b.submit(x[0]).result(timeout=30)
    finally:
        b.stop()
    assert isinstance(row, onp.ndarray) and row.shape == (4,)
    onp.testing.assert_allclose(row, want[0], rtol=1e-6)
    reg = serve.ModelRegistry()
    reg.load("dense", table=serve.BucketTable({"batch": (1, 2)}),
             input_axes=[{0: "batch"}], factory=lambda: net)
    onp.testing.assert_allclose(reg.get("dense").predict(x).asnumpy(),
                                want, rtol=1e-6)
    assert reg.get("dense").cache_info()["post_warmup_compiles"] == 0


def test_registry_batcher_swap_pin_unload_match_jax(bert):
    reqs, want = bert["reqs"], bert["want"]
    reg = serve.ModelRegistry()
    kw = dict(_load_kw(), example_args=EXAMPLE)
    reg.load("bert", factory=lambda: _port_bert(bert["A"]), **kw)
    b = serve.make_registry_batcher(reg, "bert", max_delay_ms=1)
    try:
        def served():
            futures = [b.submit(*r) for r in reqs]
            return [f.result(timeout=60) for f in futures]

        for got, w in zip(served(), want["A"]):
            _close(got, w)
        reg.load("bert", factory=lambda: _port_bert(bert["B"]), **kw)
        assert reg.models() == {"bert": [1, 2]}
        assert reg.active_version("bert") == 2
        for got, w in zip(served(), want["B"]):      # the swap redirected
            _close(got, w)
        # pinned: v1 by version, beside the active v2
        pinned = reg.get("bert", 1).predict(*_one(reqs[0]))
        _close([o.asnumpy()[0] for o in pinned], want["A"][0])
        assert reg.get_version("bert", 1).source["factory"] == "<lambda>"
        reg.unload("bert", 2)
        assert reg.active_version("bert") == 1
        for got, w in zip(served(), want["A"]):
            _close(got, w)
    finally:
        b.stop()
    info = reg.get("bert").cache_info()
    assert info["post_warmup_compiles"] == 0 and info["warmup_compiles"] == 2
    reg.unload("bert")
    assert reg.models() == {}


def test_ckpt_root_across_packages(bert):
    """The port loads the JAX trainer's checkpoint over a model whose
    names carry another instance prefix; the JAX registry loaded the
    port trainer's (``bert`` fixture, v3)."""
    reqs, want = bert["reqs"], bert["want"]
    reg = serve.ModelRegistry()
    v = reg.load("bert", factory=lambda: _port_bert(bert["A"]),
                 ckpt_root=bert["jax_root"], example_args=EXAMPLE,
                 **_load_kw())
    assert v.source["ckpt_root"] == bert["jax_root"]
    for r, w in zip(reqs, want["B"]):
        got = reg.get("bert").predict(*_one(r))
        _close([o.asnumpy()[0] for o in got], w)
    # the reverse: the JAX registry's v3 (the port's checkpoint of C)
    cm = serve.CompiledModel(_port_bert(bert["C"]), serve.BucketTable(TABLE),
                             SPEC["input_axes"], EXAMPLE,
                             output_axes=SPEC["output_axes"],
                             pad_values=SPEC["pad_values"])
    for r, w in zip(reqs, want["C"]):
        _close([o.asnumpy()[0] for o in cm.predict(*_one(r))], w)


def test_failed_and_hung_loads_keep_the_active_version(tmp_path):
    net = _dense()
    x = onp.ones((1, 8), "float32")
    reg = serve.ModelRegistry(retry_policy=RetryPolicy(retries=0))
    kw = dict(table=serve.BucketTable({"batch": (1, 2)}),
              input_axes=[{0: "batch"}])
    reg.load("dense", factory=lambda: net, **kw)
    want = reg.get("dense").predict(x).asnumpy()
    from incubator_mxnet_tpu_torch.fault import checkpoint
    root = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(root, {"weight": onp.zeros((4, 8), "float32")},
                               {}, step=1)
    with inject.chaos(seed=0, crash_sites=["serve.registry.load"]):
        with pytest.raises(MXNetError, match="serve.registry.load"):
            reg.load("dense", factory=lambda: _dense(1), ckpt_root=root,
                     **kw)
    assert reg.models() == {"dense": [1]}
    onp.testing.assert_array_equal(reg.get("dense").predict(x).asnumpy(),
                                   want)
    release = threading.Event()

    def hung_factory():
        release.wait(30)        # never returns within the deadline
        return net

    try:
        with pytest.raises(MXNetError, match="deadline"):
            reg.load("dense", factory=hung_factory, deadline_s=0.3, **kw)
    finally:
        release.set()
    assert reg.models() == {"dense": [1]}
    onp.testing.assert_array_equal(reg.get("dense").predict(x).asnumpy(),
                                   want)


def test_a_wedged_capture_raises_naming_its_holder(monkeypatch):
    """A staged load stuck inside a capture holds the capture stream; a
    later capture (a replica's restart) raises once its wait ends, naming
    the stuck thread, and runs nothing; once the stream is let go the
    next one takes it."""
    from incubator_mxnet_tpu_torch.ops.cuda import graphs
    monkeypatch.setattr(graphs, "CAPTURE_WAIT_S", 0.2)
    inside, release = threading.Event(), threading.Event()

    def stuck():
        with graphs._holding("the capture of bucket [(1, 8)]"):
            inside.set()
            release.wait(30)

    t = threading.Thread(target=stuck, name="mx-serve-stage-bert-v2")
    t.start()
    ran = []
    try:
        assert inside.wait(30)
        with pytest.raises(MXNetError, match=r"mx-serve-stage-bert-v2.*"
                           r"the capture of bucket \[\(1, 8\)\]"):
            graphs.run_on_capture_stream(torch.device("cuda", 0),
                                         lambda: ran.append(1),
                                         what="r0's restart")
    finally:
        release.set()
        t.join(30)
    assert not ran and not t.is_alive()
    with graphs._holding("the next capture"):
        assert graphs._holder.endswith("(the next capture)")
    assert graphs._holder is None


def test_apply_weights_writes_in_place():
    """Every parameter keeps its storage; the compiled model serves the
    new weights without a compile."""
    net = _dense()
    cm = serve.CompiledModel(net, serve.BucketTable({"batch": (1, 2)}),
                             [{0: "batch"}])
    cm.warmup()
    ptrs = {k: p._tensor().data_ptr() for k, p in
            net.collect_params().items()}
    new = {p.name: onp.full(p.shape, 0.5, "float32")
           for p in net.collect_params().values()}
    assert serve.apply_weights(net, new) == len(new)
    cm.refresh_params()
    assert {k: p._tensor().data_ptr() for k, p in
            net.collect_params().items()} == ptrs
    out = cm.predict(onp.ones((1, 8), "float32")).asnumpy()
    onp.testing.assert_allclose(out, onp.full((1, 4), 0.5 * 8 + 0.5))
    info = cm.cache_info()
    assert info["compiles"] == info["warmup_compiles"] == 2
    with pytest.raises(MXNetError, match="shape"):
        serve.apply_weights(net, {next(iter(new)): onp.zeros((2, 2))})
    assert serve.map_checkpoint_arrays(
        {"param:0000": 1, "opt:0000:0": 2}, {"param_names": ["w"]}) \
        == {"w": 1}


def test_budget_preflight_rejects_a_load(monkeypatch):
    net = _dense()
    kw = dict(table=serve.BucketTable({"batch": (1, 2)}),
              input_axes=[{0: "batch"}])
    reg = serve.ModelRegistry()
    v1 = reg.load("dense", factory=lambda: net, **kw)
    # no budget, no measurement
    assert "resident_bytes" not in v1.source
    monkeypatch.setenv("MXTPU_HBM_BUDGET", "100")
    with pytest.raises(MXNetError, match="MXTPU_HBM_BUDGET"):
        reg.load("dense", factory=lambda: _dense(1), **kw)
    assert reg.models() == {"dense": [1]}
    monkeypatch.setenv("MXTPU_HBM_BUDGET", "1K")
    v2 = reg.load("dense", factory=lambda: _dense(1), **kw)
    # weights: a (4, 8) float32 weight and 4 biases
    assert v2.version == 2 and v2.source["resident_bytes"] == (32 + 4) * 4


def test_registry_errors():
    reg = serve.ModelRegistry()
    kw = dict(table=serve.BucketTable({"batch": (1, 2)}),
              input_axes=[{0: "batch"}])
    with pytest.raises(MXNetError, match="no model"):
        reg.get("ghost")
    with pytest.raises(MXNetError, match="exactly one"):
        reg.load("x", **kw)
    once = serve.ModelRegistry(retry_policy=RetryPolicy(retries=0))
    with pytest.raises(RetryExhausted, match="deploy/x-symbol.json"):
        once.load("x", artifacts="deploy/x", **kw)
    with pytest.raises(MXNetError, match="example_args"):
        reg.load("x", factory=lambda: models.get_bert(
            "bert_2_128_2", vocab_size=VOCAB, max_length=MAXLEN,
            device="cpu"), **kw)
    net = _dense()
    reg.load("x", factory=lambda: net, version=3, **kw)
    with pytest.raises(MXNetError, match="already loaded"):
        reg.load("x", factory=lambda: net, version=3, **kw)
    with pytest.raises(MXNetError, match="no version 1"):
        reg.get("x", 1)
    assert reg.load("x", factory=lambda: net, **kw).version == 4
