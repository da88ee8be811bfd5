"""PyTorch port: seven faults of the port against the JAX package, each
held to the JAX package on the CPU (both packages in one process).

1. Basic indexing with a negative step (``x[::-2]``, ``x[:, ::-1]`` and
   its gradient, ``x[::-1] = v``), which torch refuses.
2. ``mx.nd.contrib`` is ``mx.contrib.nd``, so ``F.contrib.box_nms`` in a
   ``hybrid_forward`` runs.
3. ``gluon.Trainer(compression_params=, update_on_kvstore=)`` in the JAX
   order; ``True`` or a compression raises naming the kvstore item.
4. ``gluon.nn.LayerNorm(axis=-1, epsilon=1e-5, ...)`` in the JAX order.
5. ``models.MultiHeadAttention(use_bias=)`` and
   ``models.TransformerEncoderCell(activation=)`` in the JAX positions.
6. ``mx.NDArray``, ``mx.cpu_pinned``, ``mx.cpu_shared``,
   ``mx.gpu_memory_info``, ``mx.context.memory_stats`` and
   ``Context.memory_stats``.
7. ``serve.CompiledModel(ctx=)``.

Float results within 1e-5 (the packages sum in other orders).
"""
import inspect
import os

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import serve as jserve

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, models, nd, serve
from incubator_mxnet_tpu_torch.base import MXNetError

ATOL = 1e-5


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


def _close(a, b, atol=ATOL):
    onp.testing.assert_allclose(onp.asarray(a), onp.asarray(b), rtol=0,
                                atol=atol)


def test_negative_step_indexing_matches_jax():
    """``nd.arange(5)[::-2]`` is ``[4, 2, 0]``; ``x[:, ::-1]`` (and mixed
    keys) give the JAX values and, under ``record()``, its gradient;
    ``x[::-1] = v`` and ``x[3:0:-2, ::-1] = v`` write where the JAX package
    writes."""
    assert nd.arange(5)[::-2].asnumpy().tolist() == [4.0, 2.0, 0.0]
    host = onp.random.RandomState(0).randn(4, 6).astype("float32")
    w = onp.arange(24, dtype="float32").reshape(4, 6)
    got = {}
    for name, lib, ag in (("jax", jnd, jautograd), ("port", nd, autograd)):
        x = lib.array(host)
        x.attach_grad()
        with ag.record():
            y = x[:, ::-1] * lib.array(w)
        y.backward()
        views = [x[::-2], x[1, ::-1], x[..., 5:1:-2], x[None, ::-1, 2],
                 x[2:0:-1, -1:-5:-3]]
        z1 = lib.zeros((4, 6))
        z1[::-1] = lib.array(host)
        z2 = lib.zeros((4, 6))
        z2[3:0:-2, ::-1] = lib.array(host[:2])
        got[name] = [y, x.grad, z1, z2] + views
    for a, b in zip(got["jax"], got["port"]):
        assert a.shape == b.shape
        _close(b.asnumpy(), a.asnumpy())


def test_nd_contrib_box_nms_in_hybrid_forward_matches_jax():
    """``F.contrib.box_nms(x, overlap_thresh=0.5)`` inside a
    ``hybrid_forward`` gives the JAX package's suppressed boxes."""
    assert nd.contrib is mx.contrib.nd
    rng = onp.random.RandomState(1)
    xy = rng.rand(1, 12, 2).astype("float32") * 8
    wh = 2 + rng.rand(1, 12, 2).astype("float32") * 4
    boxes = onp.concatenate(
        [rng.randint(0, 2, (1, 12, 1)).astype("float32"),
         rng.rand(1, 12, 1).astype("float32"), xy, xy + wh], axis=-1)
    outs = []
    for g, lib in ((jgluon, jnd), (gluon, nd)):
        class NMS(g.HybridBlock):
            def hybrid_forward(self, F, x):
                return F.contrib.box_nms(x, overlap_thresh=0.5)
        outs.append(NMS()(lib.array(boxes)).asnumpy())
    assert (outs[0] == -1).any()        # something was suppressed
    _close(outs[1], outs[0])


def test_trainer_takes_update_on_kvstore_and_compression():
    """The JAX ``Trainer`` signature (``gluon/trainer.py:26-28``), in its
    positional order; ``update_on_kvstore=False``/``None`` train as before
    and ``True`` or any compression raises naming ROADMAP item 6."""
    names = list(inspect.signature(gluon.Trainer).parameters)
    assert names == list(inspect.signature(jgluon.Trainer).parameters)
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize()
    for kw in ({"update_on_kvstore": False}, {"update_on_kvstore": None},
               {"compression_params": None}):
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, **kw)
        before = net.weight.data().asnumpy()
        with autograd.record():
            loss = net(nd.ones((4, 3))).sum()
        loss.backward()
        tr.step(4)
        assert not onp.array_equal(before, net.weight.data().asnumpy())
    tr = gluon.Trainer(net.collect_params(), "sgd", None, "device", None,
                       False)
    assert tr._update_on_kvstore is False
    for kw in ({"update_on_kvstore": True},
               {"compression_params": {"type": "2bit", "threshold": 0.5}}):
        with pytest.raises(MXNetError, match="item 6"):
            gluon.Trainer(net.collect_params(), "sgd", {}, **kw)


def test_layernorm_axis_matches_jax():
    """``LayerNorm(axis=1)`` normalises over axis 1 as the JAX layer does;
    ``LayerNorm(-1, 1e-12)`` sets ``epsilon=1e-12``."""
    host = onp.random.RandomState(2).randn(2, 5, 3).astype("float32")
    gamma = onp.linspace(0.5, 1.5, 5).astype("float32")
    beta = onp.linspace(-1, 1, 5).astype("float32")
    outs = []
    for g, lib in ((jgluon, jnd), (gluon, nd)):
        ln = g.nn.LayerNorm(axis=1, prefix="ln_")
        ln.initialize()
        ln(lib.array(host))
        ln.gamma.set_data(lib.array(gamma))
        ln.beta.set_data(lib.array(beta))
        outs.append(ln(lib.array(host)).asnumpy())
        assert ln.gamma.shape == (5,)
    _close(outs[1], outs[0])
    for g in (jgluon, gluon):
        ln = g.nn.LayerNorm(-1, 1e-12)
        assert ln._axis == -1 and ln._epsilon == 1e-12


def _params_to_port(jblock, pblock, tmp):
    f = os.path.join(tmp, "w.params")
    jblock.save_parameters(f)
    pblock.load_parameters(f)


def test_transformer_use_bias_and_activation_match_jax(tmp_path):
    """A no-bias ``MultiHeadAttention`` (``use_bias`` fifth, as JAX
    ``models/transformer.py:37-40``) and ``TransformerEncoderCell``s with
    ``activation`` "gelu" and "relu" (``:132-135``) give the JAX outputs on
    the JAX weights; the no-bias cell has no bias parameter."""
    x = onp.random.RandomState(3).randn(2, 5, 16).astype("float32")
    jmx.random.seed(0)
    jm = jmodels.MultiHeadAttention(16, 2, 0.0, False, False,
                                    prefix="mha_")
    pm = models.MultiHeadAttention(16, 2, 0.0, False, False, prefix="mha_")
    jm.initialize()
    jm(jnd.array(x))
    pm.initialize()
    assert not any(k.endswith("bias") for k in pm.collect_params().keys())
    _params_to_port(jm, pm, str(tmp_path))
    _close(pm(nd.array(x)).asnumpy(), jm(jnd.array(x)).asnumpy())
    for act in ("gelu", "relu"):
        jc = jmodels.TransformerEncoderCell(16, 32, 2, 0.0, 1e-12, act,
                                            prefix="cell_")
        pc = models.TransformerEncoderCell(16, 32, 2, 0.0, 1e-12, act,
                                           prefix="cell_")
        jc.initialize()
        jc(jnd.array(x))
        pc.initialize()
        _params_to_port(jc, pc, str(tmp_path))
        assert pc.ffn.ffn1.act._act_type == act
        _close(pc(nd.array(x)).asnumpy(), jc(jnd.array(x)).asnumpy())


def test_context_names_match_jax(monkeypatch):
    """The top-level and ``mx.context`` names of JAX ``__init__.py:17-26``
    and ``context.py:153-236``: ``mx.NDArray`` is the array class,
    ``cpu_pinned``/``cpu_shared`` host contexts (``as_in_context`` onto
    ``cpu_pinned`` gives a host copy), ``Context.memory_stats`` the JAX
    keys and types, ``gpu_memory_info`` a ``(free, total)`` pair of ints
    (``torch.cuda.mem_get_info``) that raises without a card."""
    for n in ("NDArray", "cpu_pinned", "cpu_shared", "gpu_memory_info",
              "memory_stats"):
        assert hasattr(mx, n) and hasattr(jmx, n), n
    assert hasattr(mx.context, "memory_stats")
    assert mx.NDArray is nd.NDArray
    for f in ("cpu_pinned", "cpu_shared"):
        p, j = getattr(mx, f)(), getattr(jmx, f)()
        assert (p.device_type, p.device_id, p.device_typeid) == \
            (j.device_type, j.device_id, j.device_typeid)
        assert str(p) == str(j)
    x = nd.array([1.0, 2.0]).as_in_context(mx.cpu_pinned())
    assert x._data.device.type == "cpu" and x.asnumpy().tolist() == [1, 2]
    ps, js = mx.cpu().memory_stats(), jmx.cpu().memory_stats()
    for k in ("bytes_in_use", "bytes_limit", "source"):
        assert type(ps[k]) is type(js[k]), k
    assert 0 < ps["bytes_in_use"] <= ps["bytes_limit"]
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.gpu_memory_info(0)
    import incubator_mxnet_tpu_torch.context as pctx
    monkeypatch.setattr(pctx, "resolve_device", lambda d: d)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (7, 11))
    got, ref = mx.gpu_memory_info(0), jmx.gpu_memory_info(0)
    assert got == (7, 11)
    assert type(got) is type(ref) and len(got) == len(ref) and \
        all(type(a) is type(b) for a, b in zip(got, ref))


def test_compiled_model_takes_ctx():
    """``serve.CompiledModel`` takes ``donate`` and ``ctx`` in the JAX
    positions (``serve/compiled.py:74,81``); the model is placed on
    ``ctx``'s device (a context out of range raises as it is placed) and
    serves the JAX CompiledModel's rows."""
    jnames = list(inspect.signature(jserve.CompiledModel).parameters)
    pnames = list(inspect.signature(serve.CompiledModel).parameters)
    assert pnames == jnames[:len(pnames)] and "ctx" in pnames
    x = onp.random.RandomState(4).randn(3, 6).astype("float32")
    table = {"batch": (1, 4)}
    jnet = jgluon.nn.Dense(5, in_units=6, prefix="d_")
    jnet.initialize()
    jnet.hybridize()
    jnet(jnd.array(x[:1]))
    pnet = gluon.nn.Dense(5, in_units=6, prefix="d_")
    pnet.initialize()
    for p, j in zip(pnet.collect_params().values(),
                    jnet.collect_params().values()):
        p.set_data(nd.array(j.data().asnumpy()))
    jcm = jserve.CompiledModel(jnet, jserve.BucketTable(table), [{0: "batch"}],
                               ctx=jmx.cpu())
    pcm = serve.CompiledModel(pnet, serve.BucketTable(table), [{0: "batch"}],
                              [x[:1]], None, 0, "auto", mx.cpu())
    assert pcm._device.type == "cpu"
    assert pnet.weight.list_ctx() == [mx.cpu()]
    _close(pcm.predict(x).asnumpy(), jcm.predict(x).asnumpy())
    with pytest.raises(MXNetError, match="out of range"):
        serve.CompiledModel(pnet, serve.BucketTable(table), [{0: "batch"}],
                            [x[:1]], ctx=mx.cpu(3))
