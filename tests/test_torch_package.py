"""PyTorch port: package boundaries.

The port imports ``torch`` and never ``jax`` nor anything of the JAX
package (whose name is a prefix of the port's). The import guard runs in a
subprocess because this test process has already imported JAX.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "incubator_mxnet_tpu_torch"


_GUARD = r"""
import sys
import numpy as onp
import incubator_mxnet_tpu_torch as mt
m = mt.models.get_bert("bert_2_128_2", vocab_size=50, max_length=16,
                       use_decoder=False, use_classifier=False,
                       device="cpu")
spec = mt.models.serve_spec("bert_encoder")
ex = (onp.ones((1, 8), "int32"), onp.zeros((1, 8), "int32"),
      onp.full((1,), 8, "float32"))
cm = mt.serve.CompiledModel(m, mt.serve.BucketTable({"batch": (1, 2),
                                                     "seq": (8, 16)}),
                            spec["input_axes"], ex,
                            output_axes=spec["output_axes"],
                            pad_values=spec["pad_values"])
b = mt.serve.DynamicBatcher(cm, max_delay_ms=1).start()
seq, pooled = b.submit(onp.arange(1, 6, dtype="int32"),
                       onp.zeros(5, "int32"),
                       onp.array(5, "float32")).result(timeout=60)
b.stop()
assert tuple(seq.shape) == (5, 128) and tuple(pooled.shape) == (128,)
from incubator_mxnet_tpu_torch import bench
net = mt.models.get_bert("bert_2_128_2", vocab_size=50, max_length=16,
                         device="cpu")
tr = mt.parallel.ShardedTrainer(net, mt.models.bert_pretrain_loss, "adamw",
                                device="cpu", n_labels=3)
assert bool(tr.step(*bench.make_batch(2, 16, vocab=50)).isfinite())
assert tr.last_finite
assert dict(net.named_parameters())["word_embed.weight"].grad is not None
import os, tempfile
from incubator_mxnet_tpu_torch import autograd, gluon, nd
with mt.cpu():
    g = mt.models.get_bert("bert_2_128_2", vocab_size=50, max_length=16,
                           device="cpu")
    t = gluon.Trainer(g.collect_params(), "adam")
    b = [nd.array(a) for a in bench.make_batch(2, 16, vocab=50)]
    with autograd.record():
        loss = mt.models.bert_pretrain_loss(g(*b[:4]), *b[4:])
    loss.backward()
    t.step(1)
    with tempfile.TemporaryDirectory() as d:
        g.save_parameters(os.path.join(d, "g.params"))
        g.load_parameters(os.path.join(d, "g.params"))
    assert t.optimizer.num_update == 1 and bool(loss.asscalar() > 0)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "incubator_mxnet_tpu"
             or n.startswith("incubator_mxnet_tpu."))
assert not bad, bad
print("OK")
"""


def test_port_imports_no_jax_and_serves():
    """Serving, one training step and one Gluon step with a ``.params``
    round trip, on the CPU, import no JAX."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _GUARD], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK")


_JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_JAX_PKG = re.compile(r"incubator_mxnet_tpu(?!_torch)")
_JAX_PKG_IMPORT = re.compile(
    r"^\s*(import|from)\s+incubator_mxnet_tpu(?!_torch)\b", re.M)


def test_source_scan():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not _JAX_IMPORT.search(text), f"{f} imports jax"
        m = _JAX_PKG.search(text)
        assert m is None, f"{f} names the JAX package: {text[m.start():][:60]!r}"
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not _JAX_IMPORT.search(smoke)
    assert not _JAX_PKG_IMPORT.search(smoke)
    # the scan itself tells the two package names apart
    assert _JAX_PKG.search("import incubator_mxnet_tpu.ops")
    assert not _JAX_PKG.search("import incubator_mxnet_tpu_torch.ops")


def test_default_device_is_the_card(monkeypatch):
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.context import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        models.get_bert()
    with pytest.raises(MXNetError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    m = models.get_bert("bert_2_128_2", vocab_size=20, max_length=8,
                        device="cpu")
    assert next(m.parameters()).device.type == "cpu"
    # the same default generator seed gives the same weights
    m2 = models.get_bert("bert_2_128_2", vocab_size=20, max_length=8,
                         device="cpu")
    name = "encoder.layer1.attention.qkv.weight"
    assert torch.equal(dict(m.named_parameters())[name],
                       dict(m2.named_parameters())[name])
