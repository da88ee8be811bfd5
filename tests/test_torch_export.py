"""PyTorch port: ``HybridBlock.export`` and ``gluon.SymbolBlock``, held
against the JAX package on the CPU (JAX ``tests/test_export.py`` and the
deploy half of ``tests/test_serve.py``).

- The manifest keeps the JAX keys (``param_order``,
  ``param_prefix_names``, ``n_inputs``, ``in_avals``, ``out_fmt``,
  ``multi``, ``signatures``) with the JAX values; each entry names a
  ``torch.export`` program (``pt2``) where the JAX one names StableHLO.
- An imported artifact runs without the block's class, in a fresh process
  too, where ``torch.export.load`` finds the registered flash op.
- The exported ``bert_2_128_2`` holds one ``mxtpu::flash_attention_fwd``
  node per layer, one program for every bucket, and gives the JAX
  ``SymbolBlock``'s output at each bucket; ``.params`` files cross both
  ways into ``set_weights``/``load_parameters``.
- ``torch.library.opcheck`` of the op; the refusals (no recorded forward,
  a shape not exported, a JAX manifest) as the JAX package words them; a
  forward that does not trace over a bucket range gets a program per
  signature.

Tolerance: float32 outputs within 1e-5 of the JAX package's (the packages
sum in other orders, observed ~1e-6); the port's program equals its own
eager forward exactly.
"""
import json
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa
from test_torch_artifact_common import (  # noqa: F401  (fixtures)
    BUCKETS, close, jax_reference, on_cpu, one_torch_thread, port_artifact,
    request, scratch_dir,
)

#: the manifest keys that mean the same in both packages
SAME_KEYS = ("block", "params", "param_order", "param_prefix_names",
             "n_inputs", "in_avals", "out_fmt", "multi")


def _mlp(pkg, dropout=None):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=8))
        if dropout:
            net.add(pkg.gluon.nn.Dropout(dropout))
        net.add(pkg.gluon.nn.Dense(4, in_units=16))
    return net


def _two_head(pkg):
    class TwoHead(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.a = pkg.gluon.nn.Dense(2, in_units=4)
                self.b = pkg.gluon.nn.Dense(3, in_units=4)

        def hybrid_forward(self, F, x):
            return self.a(x), self.b(x)

    return TwoHead(prefix="two_")


def _pair(make, x, root, name):
    """The port block (initialised, one forward) and the JAX block with
    its weights (a ``.params`` file, hybridized, one forward), each
    exported; returns the blocks, the manifests and imported blocks."""
    with mx.cpu():
        net = make(mx)
        net.initialize()
        want = net(nd.array(x))
        files = net.export(f"{root}/{name}")
        blk = gluon.SymbolBlock.imports(files[0], ["data"], files[1])
    jnet = make(jmx)
    jnet.load_parameters(files[1])
    jnet.hybridize()
    jnet(jnd.array(x))
    jfiles = jnet.export(f"{root}/jax_{name}")
    jblk = jgluon.SymbolBlock.imports(jfiles[0], ["data"], jfiles[1])
    arch, jarch = (json.load(open(f[0])) for f in (files, jfiles))
    return {"net": net, "want": want, "blk": blk, "jblk": jblk,
            "arch": arch, "jarch": jarch, "files": files, "jfiles": jfiles}


def _same_manifest(arch, jarch):
    assert arch["framework"] == "incubator_mxnet_tpu_torch"
    for k in SAME_KEYS:
        assert arch[k] == jarch[k], k
    assert [{k: e[k] for k in ("in_avals", "out_fmt", "multi")}
            for e in arch["signatures"]] == \
        [{k: e[k] for k in ("in_avals", "out_fmt", "multi")}
         for e in jarch["signatures"]]


def test_round_trip_after_one_forward_matches_jax():
    """One forward records what export needs; the manifest is the JAX
    one's; the imported block gives the block's output exactly and the JAX
    ``SymbolBlock``'s within 1e-5."""
    x = onp.random.RandomState(0).randn(3, 8).astype("float32")
    p = _pair(_mlp, x, scratch_dir(), "mlp")
    _same_manifest(p["arch"], p["jarch"])
    assert os.path.exists(os.path.join(os.path.dirname(p["files"][0]),
                                       p["arch"]["pt2"]))
    got = p["blk"](nd.array(x))
    assert torch.equal(got._data, p["want"]._data)
    close([got], [p["jblk"](jnd.array(x)).asnumpy()])
    x2 = onp.random.RandomState(1).randn(3, 8).astype("float32")
    with mx.cpu():
        want2 = p["net"](nd.array(x2))
    assert torch.equal(p["blk"](nd.array(x2))._data, want2._data)


def test_import_in_a_fresh_process():
    """A process that never built the model imports the artifact
    (``torch.export.load`` resolves ``mxtpu::flash_attention_fwd``, which
    the port registers on import) and gives the same output on new data."""
    art = port_artifact()
    args = request(2, 16, seed=7)
    with mx.cpu():
        blk = gluon.SymbolBlock.imports(art["sym_file"], ["a", "b", "c"],
                                        art["params_file"])
        want = [o.asnumpy() for o in blk(*(nd.array(a, dtype=a.dtype)
                                           for a in args))]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = (
        "import sys, json; import numpy as onp; import torch;"
        "torch.set_num_threads(1);"
        f"sys.path.insert(0, {root!r});"
        "import incubator_mxnet_tpu_torch as mx;"
        "from incubator_mxnet_tpu_torch import gluon, nd;"
        f"args = [onp.asarray(a, d) for a, d in json.loads("
        f"{json.dumps([[a.tolist(), str(a.dtype)] for a in args])!r})];"
        "blk = gluon.SymbolBlock.imports("
        f"{art['sym_file']!r}, ['a', 'b', 'c'], {art['params_file']!r},"
        " ctx=mx.cpu());"
        "out = blk(*[nd.array(a, ctx=mx.cpu(), dtype=a.dtype) "
        "for a in args]);"
        "print('RESULT', json.dumps([o.asnumpy().tolist() for o in out]))")
    r = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-800:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    got = json.loads(line[0][len("RESULT "):])
    for g, w in zip(got, want):
        assert onp.array_equal(onp.asarray(g, "float32"), w)


def test_multi_output_and_dropout_match_jax():
    """Two outputs keep their format (``out_fmt`` [0, 0], ``multi``); the
    exported graph is the inference one (Dropout(0.9) is the identity:
    two calls agree, and agree with the block in predict mode)."""
    root = scratch_dir()
    x = onp.random.RandomState(2).randn(5, 4).astype("float32")
    p = _pair(_two_head, x, root, "two")
    _same_manifest(p["arch"], p["jarch"])
    assert p["arch"]["out_fmt"] == [0, 0] and p["arch"]["multi"] is True
    got = p["blk"](nd.array(x))
    assert len(got) == 2
    close(got, [o.asnumpy() for o in p["jblk"](jnd.array(x))])
    for g, w in zip(got, p["want"]):
        assert torch.equal(g._data, w._data)
    x = onp.ones((2, 8), "float32")
    p = _pair(lambda pkg: _mlp(pkg, dropout=0.9), x, root, "do")
    a, b = (p["blk"](nd.array(x)).asnumpy() for _ in range(2))
    onp.testing.assert_array_equal(a, b)
    with mx.cpu(), mx.autograd.predict_mode():
        onp.testing.assert_array_equal(a, p["net"](nd.array(x)).asnumpy())
    close([a], [p["jblk"](jnd.array(x)).asnumpy()])


def test_refusals_match_jax():
    """No recorded forward: both packages raise the same error; a shape
    the artifact was not exported for: the same message; a JAX manifest
    (StableHLO) is refused, naming its format and ``load_parameters``."""
    root = scratch_dir()
    with mx.cpu():
        net = _mlp(mx)
        net.initialize()
        with pytest.raises(MXNetError) as port_err:
            net.export(f"{root}/untraced")
    jnet = _mlp(jmx)
    jnet.initialize()
    with pytest.raises(jmx.MXNetError) as jax_err:
        jnet.export(f"{root}/untraced_jax")
    assert str(port_err.value) == str(jax_err.value)
    x = onp.random.RandomState(3).randn(3, 8).astype("float32")
    p = _pair(_mlp, x, root, "mlp")
    wrong = onp.zeros((5, 8), "float32")
    with pytest.raises(MXNetError) as port_err:
        p["blk"](nd.array(wrong))
    with pytest.raises(jmx.MXNetError) as jax_err:
        p["jblk"](jnd.array(wrong))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(MXNetError, match="StableHLO.*load_parameters"):
        gluon.SymbolBlock.imports(p["jfiles"][0], ["data"], p["jfiles"][1])


def test_flash_op_passes_opcheck():
    """``mxtpu::flash_attention_fwd``: schema, fake tensor, autograd
    registration and AOT dispatch checks over a key mask and over the
    causal band with a window; on the CPU its value is the plain
    version's, exactly."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 8, 16, generator=g)
    k, v = (torch.randn(2, 2, 12, 16, generator=g) for _ in range(2))
    mask = torch.ones(2, 12)
    mask[1, 7:] = 0
    op = torch.ops.mxtpu.flash_attention_fwd.default
    for args in ((q, k, v, mask, False, 0.25, None),
                 (q, k, v, None, True, 0.3, 4)):
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, res
        o, lse = op(*args)
        ro, rlse = fa.flash_attention_reference(*args)
        assert torch.equal(o, ro) and torch.equal(lse, rlse)


def test_bert_export_matches_jax_per_bucket():
    """``bert_2_128_2`` exported over the 2x2 bucket table: one program
    that all four manifest entries name, one flash node per layer, no
    weights inside the program; at every bucket the imported block equals
    the model's eager forward exactly and the JAX ``SymbolBlock`` within
    1e-5."""
    art, ref = port_artifact(), jax_reference()
    arch = json.load(open(art["sym_file"]))
    assert len({e["pt2"] for e in arch["signatures"]}) == 1
    assert len(arch["signatures"]) == 4
    with mx.cpu():
        blk = gluon.SymbolBlock.imports(art["sym_file"], ["a", "b", "c"],
                                        art["params_file"])
    (ep,) = blk._loaded.values()
    assert sum(str(n.target).startswith("mxtpu.flash_attention_fwd")
               for n in ep.graph.nodes) == 2
    assert not ep.state_dict and not ep.constants
    assert sorted(blk.signatures()) == sorted(
        ref["block"].signatures())
    for (B, L), want in zip(BUCKETS, ref["outputs"]):
        args = request(B, L)
        with mx.cpu():
            got = blk(*(nd.array(a, dtype=a.dtype) for a in args))
            eager = art["net"](*(nd.array(a, dtype=a.dtype) for a in args))
        close(got, want)
        for g, e in zip(got, eager):
            assert torch.equal(g._data, e._data)


def test_params_cross_both_ways_into_set_weights():
    """Weights written by ``set_weights`` under training-time prefix names
    (through ``param_prefix_names``), saved to a ``.params`` file, load
    into the JAX ``SymbolBlock``, and the JAX one's into the port's
    ``load_parameters``: both give the same output. An unknown name and a
    shape mismatch raise the JAX package's messages."""
    art, ref = port_artifact(), jax_reference()
    root = scratch_dir()
    with mx.cpu():
        blk = gluon.SymbolBlock.imports(art["sym_file"], ["a", "b", "c"],
                                        art["params_file"])
    jblk = jgluon.SymbolBlock.imports(ref["sym_file"], ["a", "b", "c"],
                                      ref["params_file"])
    arch = blk._arch
    rng = onp.random.RandomState(5)
    values = {n: blk.params[n].data().asnumpy() for n in arch["param_order"]}
    moved = {pre: (values[n] + 0.05 * rng.randn(*values[n].shape)
                   ).astype("float32")
             for pre, n in zip(arch["param_prefix_names"],
                               arch["param_order"])}
    assert blk.set_weights(moved) == len(moved)
    nd.save(f"{root}/moved.params",
            {n: blk.params[n].data() for n in arch["param_order"]})
    jblk.load_parameters(f"{root}/moved.params")
    args = request(2, 16, seed=3)
    with mx.cpu():
        got = blk(*(nd.array(a, dtype=a.dtype) for a in args))
    close(got, [o.asnumpy() for o in jblk(*(jnd.array(a) for a in args))])
    back = {n: (v * 0.5).astype("float32") for n, v in values.items()}
    jnd.save(f"{root}/back.params", {n: jnd.array(v)
                                     for n, v in back.items()})
    jblk.load_parameters(f"{root}/back.params")
    blk.load_parameters(f"{root}/back.params")
    with mx.cpu():
        got = blk(*(nd.array(a, dtype=a.dtype) for a in args))
    close(got, [o.asnumpy() for o in jblk(*(jnd.array(a) for a in args))])
    name = arch["param_order"][0]
    for bad in ({"nope": values[name]}, {name: onp.zeros((3, 3))}):
        with pytest.raises(MXNetError) as port_err:
            blk.set_weights(bad)
        with pytest.raises(jmx.MXNetError) as jax_err:
            jblk.set_weights(bad)
        assert str(port_err.value) == str(jax_err.value)


def test_export_falls_back_to_a_program_per_signature():
    """A forward that branches on a size cannot trace over the bucket
    range: each signature gets a program of its own, each right; a static
    argument of the recorded call (a float) is baked in, as the skeleton
    of ``_last_sig`` keeps it."""
    class Branchy(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = gluon.nn.Dense(4, in_units=8, flatten=False)

        def hybrid_forward(self, F, x, scale):
            y = self.dense(x)
            return y * scale if x.shape[1] > 4 else y

    root = scratch_dir()
    with mx.cpu():
        net = Branchy()
        net.initialize()
        net(nd.array(onp.zeros((1, 2, 8), "float32")), 3.0)
        assert net._last_sig[0][1] == 3.0 and net._last_sig[1] == 1
        sigs = [[((b, s, 8), "float32")] for b in (1, 2) for s in (2, 8)]
        files = net.export(f"{root}/branchy", signatures=sigs)
        arch = json.load(open(files[0]))
        assert len({e["pt2"] for e in arch["signatures"]}) == 4
        blk = gluon.SymbolBlock.imports(files[0], ["x"], files[1])
        rng = onp.random.RandomState(6)
        for (shape, _), in sigs:
            x = nd.array(rng.randn(*shape).astype("float32"))
            assert torch.equal(blk(x)._data, net(x, 3.0)._data)
