"""PyTorch port: the flash-attention backward held against the JAX package
on the CPU.

The JAX side runs its Pallas backward kernels (``_bwd``) in interpret mode
with 64-row tiles (``MXTPU_FLASH_BQ/BK=64``), so that their multi-tile path
runs at L=128, as ``tests/test_torch_flash_attention.py`` does for the
forward; the port's side runs the kernels' plain version. Both get the same
q, k, v, dO and the same forward outputs (o, lse, from the JAX forward).

Tolerances: float32 atol 1e-5 (the two sides differ by summation order of
sums of up to 256 products; values up to ~5); bfloat16 atol 2e-2 and rtol
1.6e-2 (outputs rounded to bfloat16, whose ulp is 2**-8..2**-7 relative;
both sides round P and dS at the same places, but from fp32 sums taken in
another order, which can move a rounding by one ulp).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.ops.pallas import flash_attention as jax_fa
from incubator_mxnet_tpu_torch.ops import attention
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

TOL = {"float32": dict(atol=1e-5, rtol=0),
       "bfloat16": dict(atol=2e-2, rtol=1.6e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_tiles(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_BQ", "64")
    monkeypatch.setenv("MXTPU_FLASH_BK", "64")


def _inputs(seed, B, H, Lq, Lk, D):
    rng = onp.random.RandomState(seed)
    q, do = (rng.randn(B, H, Lq, D).astype("float32") for _ in range(2))
    k, v = (rng.randn(B, H, Lk, D).astype("float32") for _ in range(2))
    return q, k, v, do


def _key_mask(valid, L):
    return (onp.arange(L)[None, :] < onp.asarray(valid)[:, None]
            ).astype("float32")


def _to_torch(x, dtype):
    return torch.from_numpy(onp.array(x, "float32")).to(
        getattr(torch, dtype))


CASES = {
    # name: (seed, Lq, Lk, D, valid lengths or None, causal, window)
    "masked": (1, 128, 128, 64, [100, 37], False, None),
    "valid_length_0": (2, 128, 128, 32, [0, 77], False, None),
    "causal": (3, 128, 128, 64, None, True, None),
    "causal_window": (4, 128, 128, 32, [128, 90], True, 40),
    "cross_length": (5, 128, 256, 32, None, True, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_reference_matches_jax(jax_tiles, case, dtype):
    seed, Lq, Lk, D, valid, causal, window = CASES[case]
    q, k, v, do = _inputs(seed, 2, 2, Lq, Lk, D)
    km = None if valid is None else _key_mask(valid, Lk)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    jm = None if km is None else jnp.asarray(km)
    scale = D ** -0.5
    jo, jlse = jax_fa._fwd(jq, jk, jv, jm, causal, scale, window)
    want = jax_fa._bwd(jq, jk, jv, jm, causal, scale, jo, jlse, jdo,
                       window=window)
    tq, tk, tv, tdo, to = (_to_torch(x, dtype) for x in (q, k, v, do, jo))
    tlse = torch.from_numpy(onp.array(jlse))
    tm = None if km is None else torch.from_numpy(km)
    before = dict(fa.launches)
    got = fa.flash_attention_bwd_reference(tq, tk, tv, tm, causal, scale,
                                           window, to, tlse, tdo)
    assert fa.launches == before
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype), name
        onp.testing.assert_allclose(g.float().numpy(),
                                    onp.asarray(w.astype(jnp.float32)),
                                    err_msg=name, **TOL[dtype])
    if case == "valid_length_0":
        # a row that sees no key gets no gradient and gives none
        assert (got[0][0] == 0).all()


def test_bwd_wrapper_takes_delta(jax_tiles):
    """The plain backward on a given ``delta`` equals JAX ``_bwd`` with an
    lse cotangent folded in (``delta - dlse``, the ring-attention entry's
    path)."""
    q, k, v, do = _inputs(6, 1, 2, 64, 128, 32)
    dlse = onp.random.RandomState(7).randn(1, 2, 64).astype("float32")
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jlse = jax_fa._fwd(jq, jk, jv, None, False, 0.25)
    want = jax_fa._bwd(jq, jk, jv, None, False, 0.25, jo, jlse, jdo,
                       dlse=jnp.asarray(dlse))
    to = torch.from_numpy(onp.array(jo))
    tdo = torch.from_numpy(do)
    delta = fa._delta(to, tdo) - torch.from_numpy(dlse)
    got = fa.flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), None, False, 0.25, None,
        to, torch.from_numpy(onp.array(jlse)), tdo, delta)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w),
                                    **TOL["float32"])


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 40)])
def test_autograd_grads_match_jax_grad(jax_tiles, causal, window):
    """Grads through the port's ``flash_attention`` (its autograd Function)
    equal ``jax.grad`` through the JAX ``flash_attention`` (custom VJP in
    interpret mode) and torch autograd through the plain path. Every row
    sees a key here: the plain path gives a row that sees none a uniform
    softmax, and so a gradient, where the flash backward gives none."""
    q, k, v, do = _inputs(8, 2, 2, 128, 128, 64)
    km = _key_mask([128, 100], 128)

    def jloss(q, k, v):
        o = jax_fa.flash_attention(q, k, v, mask=jnp.asarray(km),
                                   causal=causal, window=window)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = fa.flash_attention(*leaves, mask=torch.from_numpy(km), causal=causal,
                           window=window)
    (o * torch.from_numpy(do)).sum().backward()
    plain = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    mask4 = torch.from_numpy(km)[:, None, None, :]
    o2 = attention.dot_product_attention(*plain, mask4, causal=causal,
                                         window=window, impl="xla")
    (o2 * torch.from_numpy(do)).sum().backward()
    for name, g, w, p in zip("qkv", leaves, want, plain):
        onp.testing.assert_allclose(g.grad.numpy(), onp.asarray(w),
                                    err_msg=name, **TOL["float32"])
        onp.testing.assert_allclose(g.grad.numpy(), p.grad.numpy(),
                                    err_msg=name, **TOL["float32"])


def test_no_grad_and_inference_keep_the_forward_path():
    """Under no_grad / inference_mode the forward alone runs (serving);
    with grad enabled the output carries the Function's backward."""
    q, k, v, _ = _inputs(9, 1, 2, 16, 16, 8)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert fa.flash_attention(*leaves).grad_fn is None
    with torch.inference_mode():
        assert fa.flash_attention(*leaves).grad_fn is None
    out = fa.flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    plain = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    torch.testing.assert_close(out.detach(), plain, atol=0, rtol=0)
