"""PyTorch port: the four ``interleaved_matmul_*`` ops and ``mx.runtime``
held against the JAX package on the CPU.

- Each op (``selfatt_qk``, ``selfatt_valatt``, ``encdec_qk``,
  ``encdec_valatt``; JAX ``ops/attention.py:172-234``) on seeded float32
  inputs: the output and, for one seeded cotangent, the gradient of every
  input against the JAX op's ``jax.vjp`` (within 1e-5 of the largest
  value: products of 16 terms summed in another order).
- The ops are in the registry under their names and ``_contrib_`` aliases,
  so ``mx.nd``, ``mx.contrib.nd``, ``mx.sym`` (JSON equal to the JAX
  package's) and the ``F`` of ``hybrid_forward`` see them, and
  ``amp.init("bfloat16")`` casts their inputs as the JAX package does.
- ``selfatt_qk`` -> masked softmax -> ``selfatt_valatt`` equals
  ``dot_product_attention`` on the same q, k and v (the flash path's
  plain version on the CPU; within 1e-5).
- ``mx.runtime``: ``Features()`` has the JAX package's keys; ``TPU``,
  ``PALLAS`` and ``XLA`` are off, ``CUDA``/``CUDNN``/``NCCL``/
  ``FLASH_ATTENTION`` follow the card (none here), ``CPU`` is on;
  ``feature_list`` and ``is_enabled`` read the same table.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import amp as jamp
from incubator_mxnet_tpu import runtime as jruntime
from incubator_mxnet_tpu.ops.registry import OPS as JOPS

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import amp
from incubator_mxnet_tpu_torch.ops.registry import OPS

TOL = 1e-5
L, LK, B, H, D = 6, 5, 2, 3, 4


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


def _close(got, want, tol=TOL):
    g, w = onp.asarray(got), onp.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(onp.abs(w).max()), 1.0)
    onp.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


def _inputs(name):
    rng = onp.random.RandomState(sum(map(ord, name)))
    if name == "interleaved_matmul_selfatt_qk":
        return [rng.randn(L, B, 3 * H * D)]
    if name == "interleaved_matmul_selfatt_valatt":
        return [rng.randn(L, B, 3 * H * D), rng.rand(B * H, L, L)]
    if name == "interleaved_matmul_encdec_qk":
        return [rng.randn(L, B, H * D), rng.randn(LK, B, 2 * H * D)]
    return [rng.randn(LK, B, 2 * H * D), rng.rand(B * H, L, LK)]


NAMES = ("interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
         "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt")


@functools.lru_cache(maxsize=None)
def _jax_ref(name):
    args = [a.astype("float32") for a in _inputs(name)]
    fn = JOPS[name].fn
    out, vjp = jax.vjp(lambda *a: fn(*a, heads=H),
                       *[jnp.asarray(a) for a in args])
    cot = onp.random.RandomState(9).randn(*out.shape).astype("float32")
    return args, cot, onp.asarray(out), [onp.asarray(g)
                                         for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("name", NAMES)
def test_interleaved_op_matches_jax(name):
    args, cot, want, want_grads = _jax_ref(name)
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = OPS[name].fn(*xs, heads=H)
    _close(out.detach(), want)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(cot))
    for g, w in zip(grads, want_grads):
        _close(g, w)
    # mx.nd and mx.contrib.nd reach the same function
    nd_out = getattr(mx.nd, name)(*[mx.nd.array(a) for a in args], heads=H)
    _close(nd_out.asnumpy(), want)
    short = name[len("interleaved_matmul_"):]
    c_out = getattr(mx.contrib.nd, "interleaved_matmul_" + short)(
        *[mx.nd.array(a) for a in args], heads=H)
    _close(c_out.asnumpy(), want)


def test_interleaved_registry_sym_amp_and_chain():
    for name in NAMES:
        assert OPS[name] is OPS["_contrib_" + name]
        assert JOPS[name] is JOPS["_contrib_" + name]
    with mx.name.NameManager(), jmx.name.NameManager():
        for lib in (mx, jmx):
            q = lib.sym.Variable("qkv")
            s = lib.sym.interleaved_matmul_selfatt_qk(q, heads=H, name="qk")
            v = lib.sym.contrib.interleaved_matmul_selfatt_valatt(
                q, s, heads=H, name="va")
            if lib is mx:
                p_json = v.tojson()
            else:
                assert p_json == v.tojson()
    # amp.init casts their float32 inputs as the JAX package does
    a = _inputs(NAMES[0])[0].astype("float32")
    amp.init("bfloat16")
    jamp.init("bfloat16")
    try:
        got = mx.nd.interleaved_matmul_selfatt_qk(mx.nd.array(a), heads=H)
        want = jmx.nd.interleaved_matmul_selfatt_qk(jmx.nd.array(a), heads=H)
        assert str(got.dtype) == str(want.dtype) == "bfloat16"
        _close(got.astype("float32").asnumpy(),
               want.astype("float32").asnumpy(), 2e-2)
    finally:
        amp.reset()
        jamp.reset()
    # qk -> masked softmax -> valatt is attention: the flash path's plain
    # version on the same q, k and v, inside a hybrid_forward's F

    class Chain(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, qkv, bias):
            s = F.interleaved_matmul_selfatt_qk(qkv, heads=H)
            p = F.softmax(F.reshape(s, (B, H, L, L)) + bias, axis=-1)
            return F.interleaved_matmul_selfatt_valatt(
                qkv, F.reshape(p, (B * H, L, L)), heads=H)

    rng = onp.random.RandomState(2)
    qkv = rng.randn(L, B, 3 * H * D).astype("float32")
    keep = onp.ones((B, L), "float32")
    keep[1, 4:] = 0.0
    bias = ((1.0 - keep) * -1e30)[:, None, None, :].astype("float32")
    got = Chain()(mx.nd.array(qkv), mx.nd.array(bias)).asnumpy()
    x = qkv.reshape(L, B, H, 3, D)
    q, k, v = (mx.nd.array(onp.ascontiguousarray(
        x[:, :, :, i, :].transpose(1, 2, 0, 3))) for i in range(3))
    ref = mx.nd.dot_product_attention(
        q, k, v, mask=mx.nd.array(keep[:, None, None, :])).asnumpy()
    _close(got, ref.transpose(2, 0, 1, 3).reshape(L, B, H * D))


def test_runtime_features_match_jax_keys():
    feats = mx.runtime.Features()
    jfeats = jruntime.Features()
    assert list(feats) == list(jfeats)
    card = torch.cuda.is_available()
    for key in ("TPU", "PALLAS", "XLA"):
        assert not feats.is_enabled(key)
    for key in ("CUDA", "CUDNN", "NCCL", "FLASH_ATTENTION"):
        assert feats.is_enabled(key) == card
    assert feats.is_enabled("cpu") and feats.is_enabled("PROFILER")
    assert [f.name for f in mx.runtime.feature_list()] == list(feats)
    assert repr(feats["CPU"]) == repr(jfeats["CPU"]) == "[✔ CPU]"
