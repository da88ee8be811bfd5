"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These tests import neither JAX nor the JAX package, so they also run on a
machine that has only PyTorch and the CUDA toolkit. Without a card they skip
themselves. On the card, from the root of a checkout::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's ``conftest.py`` sets JAX up.)
``chip_smoke.py`` covers every sequence bucket; this file is the quick check.
Forward tolerances as ``chip_smoke.py``: float32 (1e-5, 1e-5) for summation
order; bfloat16 (1e-2, 1.6e-2) for the output's rounding (one ulp is 2**-8
relative). Backward: float32 (1e-4, 1e-4), the kernels' products run in
3xTF32 (about fp32 accuracy) and sum in another order; bfloat16 (1e-2,
1.6e-2), the output's rounding.
"""
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The flash-attention kernel against its plain version at BERT's
    shapes: key mask with an empty row (the mean of V), causal, causal +
    window."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-5),
                              (torch.bfloat16, 1e-2, 1.6e-2)):
        for L in (8, 77, 512):
            q, k, v = (torch.randn(4, 12, L, 64, device="cuda",
                                   generator=g).to(dtype) for _ in range(3))
            vl = torch.tensor([0, 1, L // 2, L], device="cuda")
            km = (torch.arange(L, device="cuda")[None] < vl[:, None]).int()
            for causal, window in ((False, None), (True, None), (True, 5)):
                before = fa.launches[fa.KERNEL]
                o, lse = fa._fwd(q, k, v, km, causal, 0.125, window)
                torch.cuda.synchronize()
                assert fa.launches[fa.KERNEL] == before + 1
                ro, _ = fa.flash_attention_reference(q, k, v, km, causal,
                                                     0.125, window)
                torch.testing.assert_close(o.float(), ro.float(), atol=atol,
                                           rtol=rtol)
                mean_v = v[0].float().mean(dim=-2, keepdim=True)
                torch.testing.assert_close(
                    o[0].float(), mean_v.to(dtype).float().expand(o[0].shape),
                    atol=atol, rtol=rtol)
    with pytest.raises(MXNetError, match="does not take"):
        fa._fwd(q.transpose(2, 3), k, v, None, False, 0.125)


@pytest.mark.cuda
def test_backward_kernels_match_plain_version_on_card():
    """The dK/dV and dQ kernels against the plain backward: key mask with
    an empty row and a ragged length, causal + window across lengths; and
    grads flow through ``flash_attention`` on the kernels."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = BWD_TOL[dtype]
        for Lq, Lk, causal, window in ((77, 77, False, None),
                                       (100, 160, True, 24)):
            q, do = (torch.randn(4, 12, Lq, 64, device="cuda",
                                 generator=g).to(dtype) for _ in range(2))
            k, v = (torch.randn(4, 12, Lk, 64, device="cuda",
                                generator=g).to(dtype) for _ in range(2))
            vl = torch.tensor([0, 1, Lk // 2, Lk], device="cuda")
            km = (torch.arange(Lk, device="cuda")[None] < vl[:, None]).int()
            o, lse = fa.flash_attention_reference(q, k, v, km, causal, 0.125,
                                                  window)
            delta = fa._delta(o, do)
            before = dict(fa.launches)
            dk, dv = fa._bwd_dkv_cuda(q, k, v, km, causal, 0.125, window, lse,
                                      do, delta)
            dq = fa._bwd_dq_cuda(q, k, v, km, causal, 0.125, window, lse, do,
                                 delta)
            torch.cuda.synchronize()
            assert fa.launches[fa.KERNEL_BWD_DKV] == \
                before[fa.KERNEL_BWD_DKV] + 1
            assert fa.launches[fa.KERNEL_BWD_DQ] == \
                before[fa.KERNEL_BWD_DQ] + 1
            want = fa.flash_attention_bwd_reference(q, k, v, km, causal,
                                                    0.125, window, o, lse, do,
                                                    delta)
            for got, ref in zip((dq, dk, dv), want):
                torch.testing.assert_close(got.float(), ref.float(),
                                           atol=atol, rtol=rtol)
            assert (dq[0] == 0).all()           # a row that sees no key
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    before = dict(fa.launches)
    fa.flash_attention(*leaves, causal=True).sum().backward()
    assert all(fa.launches[n] == before[n] + 1 for n in fa.KERNELS)
    with pytest.raises(MXNetError, match="dO must be"):
        fa._bwd_dq_cuda(q, k, v, km, False, 0.125, None, lse, do.float(),
                        delta)


def _bwd_case(g, dtype, B, Lq, Lk, D, causal, window, valid):
    """Both backward kernels against the plain backward on one case; the
    key mask holds the valid lengths ``valid`` (None: no mask)."""
    q, do = (torch.randn(B, 12, Lq, D, device="cuda", generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, 12, Lk, D, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    km = None
    if valid is not None:
        vl = torch.tensor(valid, device="cuda")
        km = (torch.arange(Lk, device="cuda")[None] < vl[:, None]).int()
    scale = D ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, km, causal, scale, window)
    delta = fa._delta(o, do)
    args = (q, k, v, km, causal, scale, window, lse, do, delta)
    dk, dv = fa._bwd_dkv_cuda(*args)
    dq = fa._bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, km, causal, scale,
                                            window, o, lse, do, delta)
    atol, rtol = BWD_TOL[dtype]
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    return dq


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 16, 32, 128])
def test_backward_kernels_head_dims_on_card(D):
    """Each head dim has its own fragment layout (bf16 D = 8 runs its k16
    products over zeroed padding; D = 128 streams 32-row query tiles): a key
    mask with an empty row and a ragged length, and causal + window across
    lengths, in both dtypes."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(D)
    for dtype in (torch.float32, torch.bfloat16):
        dq = _bwd_case(g, dtype, 4, 77, 77, D, False, None, [0, 1, 38, 77])
        assert (dq[0] == 0).all()
        _bwd_case(g, dtype, 2, 100, 160, D, True, 24, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_training_shape_on_card(dtype):
    """The training path's shape (8, 12, 512, 64), every key valid."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    _bwd_case(g, dtype, 8, 512, 512, 64, False, None, [512] * 8)


@pytest.mark.cuda
def test_backward_tile_override_on_card(monkeypatch):
    """``MXTPU_FLASH_BQ/BK`` below the kernels' tiles give the same result;
    a tile above a kernel's own raises."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(4)
    monkeypatch.setenv("MXTPU_FLASH_BQ", "16")
    monkeypatch.setenv("MXTPU_FLASH_BK", "48")
    for dtype in (torch.float32, torch.bfloat16):
        _bwd_case(g, dtype, 2, 200, 200, 64, True, 50, [0, 150])
    monkeypatch.setenv("MXTPU_FLASH_BQ", "64")
    with pytest.raises(MXNetError, match="launch failed"):
        _bwd_case(g, torch.float32, 1, 64, 64, 128, False, None, None)
