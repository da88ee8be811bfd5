"""PyTorch port: flash-attention forward and dot_product_attention held
against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode with 64-row tiles
(``MXTPU_FLASH_BQ/BK=64``) so that its multi-tile path runs at L=128, as
``tests/test_attention.py`` does; the port's side runs the kernel's plain
version (the wrapper takes it for CPU tensors). Tolerance: float32 atol
2e-5, the one ``tests/test_attention.py`` uses (the two sides differ only by
summation order). Every row is compared, rows that see no key too: both
packages give the mean of V there.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.ops import attention as jax_attention
from incubator_mxnet_tpu.ops.pallas import flash_attention as jax_fa
from incubator_mxnet_tpu_torch.ops import attention
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

ATOL = 2e-5


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


def _qkv(seed, B, H, Lq, Lk, D):
    rng = onp.random.RandomState(seed)
    q = rng.randn(B, H, Lq, D).astype("float32")
    k = rng.randn(B, H, Lk, D).astype("float32")
    v = rng.randn(B, H, Lk, D).astype("float32")
    return q, k, v


def _key_mask(valid, L):
    return (onp.arange(L)[None, :] < onp.asarray(valid)[:, None]
            ).astype("float32")


def _compare(q, k, v, key_mask, causal, window):
    """Port plain version and dot_product_attention(auto) vs JAX flash."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = D ** -0.5
    jm = None if key_mask is None else jnp.asarray(key_mask)
    jo, jlse = jax_fa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jm, causal, scale, window)
    tm = None if key_mask is None else torch.from_numpy(key_mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = dict(fa.launches)
    o, lse = fa.flash_attention_reference(tq, tk, tv, tm, causal, scale,
                                          window)
    mask4 = None if tm is None else tm[:, None, None, :]
    auto = attention.dot_product_attention(tq, tk, tv, mask4, causal=causal,
                                           window=window)
    assert fa.launches == before  # CPU tensors never reach the kernel
    onp.testing.assert_allclose(o.numpy(), onp.asarray(jo), atol=ATOL)
    onp.testing.assert_allclose(auto.numpy(), onp.asarray(jo), atol=ATOL)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(jlse), atol=ATOL,
                                rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_matches_jax(jax_tiles, masked, causal):
    q, k, v = _qkv(1, 2, 2, 128, 128, 64)
    key_mask = _key_mask([100, 37], 128) if masked else None
    _compare(q, k, v, key_mask, causal, None)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_window_matches_jax(jax_tiles, masked):
    q, k, v = _qkv(2, 2, 2, 128, 128, 64)
    key_mask = _key_mask([128, 90], 128) if masked else None
    _compare(q, k, v, key_mask, True, 40)


def test_flash_cross_length_causal_matches_jax(jax_tiles):
    """Bottom-right-aligned causal masking when Lq != Lk."""
    q, k, v = _qkv(5, 1, 2, 128, 256, 32)
    _compare(q, k, v, None, True, None)


# bfloat16: one output ulp (2**-8 relative) and P rounded at other places
FULLY_MASKED_TOL = {"float32": dict(atol=1e-5, rtol=0),
                    "bfloat16": dict(atol=2e-2, rtol=1.6e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_matches_jax(jax_tiles, dtype):
    """A row that sees no key gives the mean of V over all keys, with lse at
    most -1e29. Against the JAX flash forward (interpret mode) for a key
    mask with a valid length 0, and against the JAX XLA path for causal +
    window over a key mask, where rows also lose every key to the band;
    the port's own XLA path agrees too."""
    tol = FULLY_MASKED_TOL[dtype]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v = _qkv(3, 2, 2, 128, 128, 64)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, dtype=jdt) for x in (q, k, v))

    key_mask = _key_mask([0, 77], 128)
    jo, _ = jax_fa._fwd(jq, jk, jv, jnp.asarray(key_mask), False, 64 ** -0.5,
                        None)
    o, lse = fa.flash_attention_reference(tq, tk, tv,
                                          torch.from_numpy(key_mask))
    onp.testing.assert_allclose(o.float().numpy(),
                                onp.asarray(jo.astype(jnp.float32)), **tol)
    mean_v = tv[0].float().mean(dim=-2, keepdim=True).to(tdt)
    onp.testing.assert_allclose(o[0].float().numpy(),
                                mean_v.float().expand(2, 128, 64).numpy(),
                                **tol)
    assert (lse[0] <= -1e29).all()

    # causal + window 16 over valid lengths 0 and 20: batch 1's rows from
    # 35 on see no key either
    mask4 = _key_mask([0, 20], 128)[:, None, None, :]
    want = jax_attention.dot_product_attention(
        jq, jk, jv, jnp.asarray(mask4), causal=True, window=16, impl="xla")
    got, lse = fa.flash_attention_reference(
        tq, tk, tv, torch.from_numpy(mask4), causal=True, window=16)
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(want.astype(jnp.float32)), **tol)
    assert (lse[0] <= -1e29).all() and (lse[1, :, 35:] <= -1e29).all()
    assert (lse[1, :, :35] > -1e29).all()
    xla = attention.dot_product_attention(tq, tk, tv, torch.from_numpy(mask4),
                                          causal=True, window=16, impl="xla")
    onp.testing.assert_allclose(got.float().numpy(), xla.float().numpy(),
                                **tol)


@pytest.mark.parametrize("causal", [False, True])
def test_xla_path_matches_jax(causal):
    rng = onp.random.RandomState(0)
    B, H, L, D = 2, 3, 17, 8          # odd L, as tests/test_attention.py
    q, k, v = (rng.randn(B, H, L, D).astype("float32") for _ in range(3))
    mask = _key_mask(rng.randint(3, L, (B,)), L)[:, None, None, :]
    want = jax_attention.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v, mask)), causal=causal,
        impl="xla")
    got = attention.dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v, mask)), causal=causal,
        impl="xla")
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), atol=ATOL)
    want_w = jax_attention.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, window=5,
        impl="xla")
    got_w = attention.dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, window=5,
        impl="xla")
    onp.testing.assert_allclose(got_w.numpy(), onp.asarray(want_w),
                                atol=ATOL)


@pytest.mark.parametrize("kwargs", [
    {"window": 4},                                   # window needs causal
    {"window": 0, "causal": True},                   # window > 0
    {"mask": "dense"},                               # dense masks refused
])
def test_validation_errors_match_jax(kwargs):
    q, k, v = _qkv(4, 2, 2, 16, 16, 8)
    kw = dict(kwargs)
    if kw.get("mask") == "dense":
        kw["mask"] = onp.ones((2, 1, 16, 16), "float32")
    jkw = {n: (jnp.asarray(x) if n == "mask" else x) for n, x in kw.items()}
    tkw = {n: (torch.from_numpy(x) if n == "mask" else x)
           for n, x in kw.items()}
    with pytest.raises(ValueError) as want:
        jax_fa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), **jkw)
    with pytest.raises(ValueError) as got:
        fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **tkw)
    assert str(got.value) == str(want.value)


def test_routing_and_guards(monkeypatch):
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 2, 16, 16, 24))
    # head dim 24 is not a kernel instance: auto takes the plain path
    assert not fa.flash_supported(q, k, v)
    q64, k64, v64 = (torch.from_numpy(x) for x in _qkv(6, 1, 2, 16, 16, 64))
    assert fa.flash_supported(q64, k64, v64)
    assert not fa.flash_supported(q64.transpose(2, 3), k64, v64)
    assert not fa.flash_supported(q64.double(), k64.double(), v64.double())
    # env override of impl, as the JAX op
    monkeypatch.setenv("MXTPU_ATTN_IMPL", "xla")
    xla = attention.dot_product_attention(q64, k64, v64)
    monkeypatch.delenv("MXTPU_ATTN_IMPL")
    flash = attention.dot_product_attention(q64, k64, v64, impl="flash")
    torch.testing.assert_close(flash, xla, atol=ATOL, rtol=0)
    # grads flow through flash_attention (its plain backward on the CPU)
    # and equal torch autograd through the plain path
    before = dict(fa.launches)
    leaves = [x.clone().requires_grad_() for x in (q64, k64, v64)]
    fa.flash_attention(*leaves).square().sum().backward()
    want = [x.clone().requires_grad_() for x in (q64, k64, v64)]
    attention.dot_product_attention(*want, impl="xla").square().sum() \
        .backward()
    for got, ref in zip(leaves, want):
        assert got.grad is not None
        torch.testing.assert_close(got.grad, ref.grad, atol=ATOL, rtol=0)
    assert fa.launches == before  # CPU tensors never reach a kernel
    monkeypatch.setenv("MXTPU_FLASH_BQ", "65")
    with pytest.raises(ValueError, match="1..64"):
        fa._tile("MXTPU_FLASH_BQ")

