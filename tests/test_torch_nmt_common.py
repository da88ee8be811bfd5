"""Set-up shared by the PyTorch port's NMT tests (``tests/test_torch_nmt.py``)
and decode-serving tests (``tests/test_torch_decode.py``); it holds no test.

One model configuration in the shape of the JAX package's
machine-translation example (vocabulary 12, units 64, hidden 128, 2 + 2
layers, 4 heads), so that each JAX shape compiles once in a process: the
JAX reference model (built once per process), the port model from its
weights, and the warmed decode engines.
"""
import functools
import tempfile

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import serve as jax_serve
from incubator_mxnet_tpu.models import nmt as jax_nmt
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import models, serve
from incubator_mxnet_tpu_torch.convert import params_from_jax

VOCAB, UNITS, HIDDEN, LAYERS, HEADS, MAX_LEN = 12, 64, 128, 2, 4, 32
CFG = dict(units=UNITS, hidden_size=HIDDEN, num_layers=LAYERS,
           num_heads=HEADS, dropout=0.0, max_length=MAX_LEN)
ENGINE = dict(max_batch=2, block_size=4, max_target_len=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arrays_of(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def port_model(arrays, **kw):
    with mx.cpu():
        net = models.NMTModel(VOCAB, VOCAB, **dict(CFG, **kw))
        net.initialize()
    return params_from_jax(net, arrays)


def batch(seed=0, B=32, Ls=5, Lt=6):
    """``(src, target, src valid length, label)``: the example's shapes
    (batch 32, source 5, target 6), valid lengths ragged down to 1."""
    rng = onp.random.RandomState(seed)
    src = rng.randint(3, VOCAB, (B, Ls)).astype("int32")
    tgt = rng.randint(3, VOCAB, (B, Lt)).astype("int32")
    valid = rng.randint(1, Ls + 1, B).astype("float32")
    valid[0] = Ls
    label = rng.randint(0, VOCAB, (B, Lt)).astype("int32")
    return src, tgt, valid, label


@functools.lru_cache(maxsize=None)
def _reference():
    # the port's seeded Xavier weights through a .params file: loading
    # compiles far less than the JAX initialisers
    with mx.cpu():
        seed = models.NMTModel(VOCAB, VOCAB, **CFG)
        seed.initialize(mx.init.Xavier(
            generator=torch.Generator().manual_seed(0)))
    with tempfile.TemporaryDirectory() as d:
        seed.save_parameters(f"{d}/seed.params")
        net = jax_nmt.NMTModel(VOCAB, VOCAB, prefix="nmtref_", **CFG)
        net.load_parameters(f"{d}/seed.params")
    src, tgt, valid, _ = batch()
    logits = net(jnd.array(src), jnd.array(tgt), jnd.array(valid)).asnumpy()
    arrays = arrays_of(net)
    return {"net": net, "arrays": arrays, "logits": logits,
            "port": port_model(arrays)}


@pytest.fixture(scope="module")
def ref():
    """The JAX model (the port's seeded Xavier weights) and its forward on
    a ragged batch; the port model from the same weights. A test that
    changes the JAX model's weights puts them back."""
    return _reference()


def table(kind=serve):
    return kind.BucketTable({"batch": (1, 1), "src": (4, 8)})


def prompt(rng, lo=2, hi=8):
    return rng.randint(3, VOCAB, (int(rng.randint(lo, hi)),)).astype("int32")


@pytest.fixture(scope="module")
def engine():
    """A port model (seeded Xavier) and its warmed engine."""
    with mx.cpu():
        net = models.NMTModel(VOCAB, VOCAB, **CFG)
        net.initialize(mx.init.Xavier(
            generator=torch.Generator().manual_seed(0)))
    eng = serve.DecodeEngine(net, table(), **ENGINE, hbm_budget=None)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def engines(ref):
    """The JAX reference model's warmed engine, and the port model from
    the same weights with its warmed engine."""
    jengine = jax_serve.DecodeEngine(ref["net"], table(jax_serve), **ENGINE,
                                     hbm_budget=None)
    jengine.warmup()
    net = port_model(ref["arrays"])
    eng = serve.DecodeEngine(net, table(), **ENGINE, hbm_budget=None)
    eng.warmup()
    return {"jax": jengine, "net": net, "engine": eng}
