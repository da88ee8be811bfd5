"""Set-up shared by the PyTorch port's deploy-path tests
(``tests/test_torch_export.py``, ``tests/test_torch_serve_artifacts.py``);
it holds no test.

One ``bert_2_128_2`` encoder (vocabulary 60, 32 positions) with the port's
seeded weights, and the JAX reference built once per process from the same
weights (a ``.params`` file): the JAX model exported by the JAX
``serve.export_for_serving`` over a 2x2 bucket table, imported as the JAX
``SymbolBlock``, and its output at each bucket.
"""
import atexit
import functools
import shutil
import tempfile

import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import serve as jserve
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import models, nd

VOCAB, MAXLEN = 60, 32
TABLE = {"batch": (1, 2), "seq": (8, 16)}
BUCKETS = ((1, 8), (2, 16), (1, 16), (2, 8))
SPEC = models.serve_spec("bert_encoder")
#: float32 on the CPU: the packages sum in other orders (observed ~1e-6)
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scratch_dir() -> str:
    """A directory removed when the process ends."""
    d = tempfile.mkdtemp(prefix="mx-artifact-test-")
    atexit.register(shutil.rmtree, d, True)
    return d


def request(B: int, L: int, seed: int = 0):
    """Ids, token types and valid lengths (ragged) of one batch."""
    rng = onp.random.RandomState(seed + 100 * B + L)
    return (rng.randint(1, VOCAB, (B, L)).astype("int32"),
            (onp.arange(L)[None] >= L // 2).repeat(B, 0).astype("int32"),
            rng.randint(1, L + 1, B).astype("float32"))


def port_bert():
    """The port's encoder on the CPU (weights from generator seed 0, names
    under ``bert_``) with one recorded forward at (1, 8)."""
    with mx.cpu():
        net = models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                              max_length=MAXLEN, dropout=0.0,
                              use_decoder=False, use_classifier=False,
                              device="cpu", prefix="bert_")
        net(*(nd.array(a, dtype=a.dtype) for a in request(1, 8)))
    return net


@functools.lru_cache(maxsize=None)
def jax_reference() -> dict:
    """The JAX encoder over the port's weights, exported for the bucket
    table and imported: its files, its ``SymbolBlock`` and its output
    (numpy, one tuple per bucket of :data:`BUCKETS`)."""
    root = scratch_dir()
    net = port_bert()
    net.save_parameters(f"{root}/port.params")
    jnet = jmodels.get_bert("bert_2_128_2", vocab_size=VOCAB,
                            max_length=MAXLEN, dropout=0.0,
                            use_decoder=False, use_classifier=False,
                            prefix="bert_")
    jnet.load_parameters(f"{root}/port.params")
    jnet.hybridize()
    jnet(*(jnd.array(a) for a in request(1, 8)))
    sym_file, params_file = jserve.export_for_serving(
        jnet, f"{root}/jax", jserve.BucketTable(TABLE), SPEC["input_axes"])
    blk = jgluon.SymbolBlock.imports(sym_file, ["ids", "types", "valid"],
                                     params_file)
    outs = [tuple(o.asnumpy() for o in blk(*(jnd.array(a)
                                              for a in request(B, L))))
            for B, L in BUCKETS]
    return {"root": root, "sym_file": sym_file, "params_file": params_file,
            "block": blk, "outputs": outs}


def close(got, want, atol=ATOL):
    """Every output within ``atol`` of the reference's."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.asnumpy() if hasattr(g, "asnumpy") else onp.asarray(g)
        assert g.shape == w.shape
        onp.testing.assert_allclose(g, w, atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def port_artifact() -> dict:
    """:func:`port_bert` exported by the port's ``export_for_serving`` over
    the bucket table: its files and the model."""
    from incubator_mxnet_tpu_torch import serve
    root = scratch_dir()
    net = port_bert()
    sym_file, params_file = serve.export_for_serving(
        net, f"{root}/port", serve.BucketTable(TABLE), SPEC["input_axes"])
    return {"root": root, "prefix": f"{root}/port", "sym_file": sym_file,
            "params_file": params_file, "net": net}


@pytest.fixture(autouse=True)
def on_cpu():
    """Every test on the CPU context (the port's default is the card)."""
    with mx.cpu():
        yield
