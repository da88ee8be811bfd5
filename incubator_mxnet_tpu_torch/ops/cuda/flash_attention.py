"""Blockwise (flash) attention, forward and backward: the Hopper kernels'
wrappers, their plain PyTorch versions and the autograd entry.

Counterpart: the JAX package's ``ops/pallas/flash_attention.py`` — the
Pallas forward kernel ``_fwd_kernel`` (``:181``) launched by ``_fwd``
(``:245``, ``pl.pallas_call`` at ``:273``), the backward kernels
``_bwd_dkv_kernel`` (``:299``) and ``_bwd_dq_kernel`` (``:359``) launched
by ``_bwd`` (``:410``, ``pl.pallas_call`` at ``:450`` and ``:487``), the
custom VJP ``_flash`` (``:507-525``) and the public ``flash_attention``
(``:556``), and the ring's block entry ``flash_block`` (``:533-553``).
The kernels are ``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd_dkv.cu`` and ``csrc/flash_attention_bwd_dq.cu``;
their sources note what bounds them and how they are laid out.

Routing: a tensor on the card goes to the kernels, which launch or raise; a
tensor on the CPU goes to the plain versions
(:func:`flash_attention_reference`, :func:`flash_attention_bwd_reference`). :func:`flash_attention` records the
backward (:class:`FlashAttentionFunction`) when grad is enabled and q, k or
v requires it; otherwise (``torch.no_grad()``, ``torch.inference_mode()``,
an export) it runs the forward alone, through the registered op
``mxtpu::flash_attention_fwd`` (:func:`flash_attention_fwd`), so an
exported program holds one node per attention call.

A row that sees no key at all (every key masked, or hidden by the causal
band) gives the mean of V over all ``Lk`` keys, cast to q's dtype, and
``lse = -1e30`` (at most ``-1e29``): the uniform softmax that the JAX
forward (``flash_attention.py:204-213``) and the XLA paths of both packages
give over scores that are all filled with ``-1e30``. Its probabilities are
0 in the backward (by the visibility predicate), so it gets ``dq = 0`` and
adds nothing to ``dk``/``dv``, as in the JAX backward (``:330``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ...base import MXNetError
from ...util import getenv
from . import _build, graphs

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_bwd_reference",
           "flash_attention_bwd_dkv_reference",
           "flash_attention_bwd_dq_reference", "flash_supported",
           "FlashAttentionFunction", "flash_attention_fwd", "KERNEL",
           "KERNEL_BWD_DKV", "KERNEL_BWD_DQ", "KERNELS",
           "SUPPORTED_HEAD_DIMS", "MAX_TILE", "launches", "flash_block",
           "FlashBlockFunction"]

_NEG = -1e30
KERNEL = "flash_attention_fwd"
KERNEL_BWD_DKV = "flash_attention_bwd_dkv"
KERNEL_BWD_DQ = "flash_attention_bwd_dq"
#: every kernel of this module, each built from ``csrc/<name>.cu``
KERNELS = (KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
#: head dims the kernels are instantiated for
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
#: largest tile (query rows or keys per tile) that ``MXTPU_FLASH_BQ/BK``
#: may ask for; a kernel refuses a tile above its own (the dK/dV kernel
#: streams 32 query rows in float32, and half its rows at head dim 128)
#: with :class:`MXNetError`
MAX_TILE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel name -> launches of that CUDA kernel since import (or since a
#: caller reset it), a captured graph's replays included
launches = {name: 0 for name in KERNELS}

#: kernel name -> (C entry point, number of tensor pointers it takes: q, k,
#: v, the key mask, then the fwd's o, lse or the bwd's dO, lse, delta and
#: its outputs); each entry then takes dtype, B, H, Lq, Lk, D, bq, bk,
#: scale, causal, window and the stream (see :func:`_launch`)
_ENTRY = {
    KERNEL: ("mxtpu_flash_attention_fwd", 6),
    KERNEL_BWD_DKV: ("mxtpu_flash_attention_bwd_dkv", 9),
    KERNEL_BWD_DQ: ("mxtpu_flash_attention_bwd_dq", 8),
}
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_TAIL = [_I32] * 8 + [ctypes.c_float, _I32, _I32, _PTR]


def _as_key_mask(mask, B, H, Lq, Lk):
    """Reduce a broadcastable mask to (B, Lk) key-padding form, else None
    (JAX counterpart: ``flash_attention.py:141``)."""
    if mask is None:
        return None
    if mask.ndim == 2 and tuple(mask.shape) == (B, Lk):
        return mask
    if mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1 \
            and mask.shape[0] in (1, B) and mask.shape[3] == Lk:
        return mask[:, 0, 0, :].expand(B, Lk)
    return None


def flash_supported(q, k, v, mask=None) -> bool:
    """Do the kernels take these inputs? Head dim in
    :data:`SUPPORTED_HEAD_DIMS`, one dtype of float32/bfloat16 for q, k and
    v, contiguous ``(B, H, L, D)`` layouts and a key-padding mask (JAX
    counterpart: ``flash_attention.py:73``). Any sequence length is taken:
    the kernels mask the ragged last tile themselves."""
    if not _kernel_takes(q, k, v):
        return False
    B, H, Lq, _ = q.shape
    return mask is None or _as_key_mask(mask, B, H, Lq, k.shape[2]) is not None


def _kernel_takes(q, k, v) -> bool:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        return False
    B, H, Lq, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        return False
    if D not in SUPPORTED_HEAD_DIMS or B * H > 65535 or Lq < 1 \
            or k.shape[2] < 1:
        return False
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return False
    return q.is_contiguous() and k.is_contiguous() and v.is_contiguous()


def _band(Lq, Lk, window, device):
    """(Lq, Lk) visibility of bottom-right-aligned causal attention, with an
    optional sliding window (JAX counterpart: ``flash_attention.py:169``)."""
    rows = torch.arange(Lq, device=device)[:, None]
    cols = torch.arange(Lk, device=device)[None, :]
    live = cols <= rows + (Lk - Lq)
    if window is not None:
        live = live & (cols > rows + (Lk - Lq) - window)
    return live


def _visible(q, Lk, mask, causal, window):
    """Broadcastable (B, 1, Lq, Lk) visibility of each (query, key) pair
    from a key-padding mask and the causal band, or None when every pair is
    visible."""
    B, H, Lq, _ = q.shape
    key_mask = _as_key_mask(mask, B, H, Lq, Lk)
    if mask is not None and key_mask is None:
        raise ValueError("flash_attention supports key-padding masks "
                         "(B, Lk) / (B,1,1,Lk); use the XLA path otherwise")
    visible = None
    if key_mask is not None:
        visible = key_mask.to(torch.bool)[:, None, None, :]
    if causal:
        band = _band(Lq, Lk, window, q.device)
        visible = band if visible is None else visible & band
    return visible


def flash_attention_reference(q, k, v, mask=None, causal: bool = False,
                              scale: Optional[float] = None,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: returns ``(o, lse)``.

    The same function as the kernel and as the JAX forward
    (``flash_attention.py:181-228``), written over whole rows instead of
    tiles: scores in fp32 from input-dtype operands, hidden entries filled
    with ``-1e30`` and given zero probability, ``p`` cast to ``v``'s dtype
    before the ``p @ v`` product with fp32 accumulation, ``o`` in ``q``'s
    dtype and ``lse`` in fp32. Rows that see no key give the mean of V over
    all keys."""
    D = q.shape[-1]
    scale = (D ** -0.5) if scale is None else float(scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    visible = _visible(q, k.shape[2], mask, causal, window)
    if visible is not None:
        s = s.masked_fill(~visible, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if visible is not None:
        p = p.masked_fill(~visible, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    o = torch.where(l == 0, v.float().mean(dim=-2, keepdim=True),
                    acc / l.clamp_min(1e-30)).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30))).squeeze(-1)
    return o, lse


def _bwd_probs(q, k, key_mask, causal, scale, window, lse):
    """fp32 ``p = exp(q k^T * scale - lse)`` on visible pairs, 0 on hidden
    ones (by the visibility predicate, not by the value of a filled
    score)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.float()[..., None])
    visible = _visible(q, k.shape[2], key_mask, causal, window)
    return p if visible is None else p.masked_fill(~visible, 0.0)


def _bwd_ds(p, v, do, delta, scale, dtype):
    """``dS = p * (dO v^T - delta) * scale`` rounded to ``dtype``."""
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return (p * (dp - delta.float()[..., None]) * scale).to(dtype)


def flash_attention_bwd_dkv_reference(q, k, v, key_mask, causal, scale,
                                      window, lse, do, delta
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel (JAX counterpart:
    ``_bwd_dkv_kernel``, ``flash_attention.py:299-350``): ``p`` rounded to
    dO's dtype before ``p^T dO``, ``dS`` to q's dtype before ``dS^T q``,
    fp32 accumulation, ``dk``/``dv`` in k's/v's dtype."""
    p = _bwd_probs(q, k, key_mask, causal, scale, window, lse)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    ds = _bwd_ds(p, v, do, delta, scale, q.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, key_mask, causal, scale, window,
                                     lse, do, delta) -> torch.Tensor:
    """Plain version of the dQ kernel (JAX counterpart: ``_bwd_dq_kernel``,
    ``flash_attention.py:359-401``): ``dS`` rounded to k's dtype before
    ``dS k``, fp32 accumulation, ``dq`` in q's dtype."""
    p = _bwd_probs(q, k, key_mask, causal, scale, window, lse)
    ds = _bwd_ds(p, v, do, delta, scale, k.dtype)
    return torch.matmul(ds.float(), k.float()).to(q.dtype)


def _delta(o, do):
    """``rowsum(dO * o)`` in fp32 (JAX counterpart:
    ``flash_attention.py:416``)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_reference(q, k, v, key_mask, causal, scale, window,
                                  o, lse, do, delta=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch version of the backward: ``(dq, dk, dv)``.

    The same function as the JAX ``_bwd`` (``flash_attention.py:410-500``)
    over whole rows: the two kernels' plain versions on ``delta``, which is
    ``rowsum(dO * o)`` when not given (a caller folding an lse cotangent in
    passes ``delta - dlse``, ``:417-422``)."""
    if delta is None:
        delta = _delta(o, do)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, key_mask, causal,
                                               scale, window, lse, do, delta)
    dq = flash_attention_bwd_dq_reference(q, k, v, key_mask, causal, scale,
                                          window, lse, do, delta)
    return dq, dk, dv


def _tile(name: str) -> int:
    """The tile that ``name`` asks for, or 0 (each kernel's own) when it is
    unset."""
    raw = getenv(name)
    if not raw:
        return 0
    t = int(raw)
    if not 1 <= t <= MAX_TILE:
        raise ValueError(f"{name}={raw}: the kernel's tiles hold 1..{MAX_TILE}"
                         " rows")
    return t


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    entry, n_ptrs = _ENTRY[name]
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * n_ptrs + _TAIL
        fn.restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(name, q, k, v, do=None, lse=None, delta=None):
    if not _kernel_takes(q, k, v):
        raise MXNetError(
            f"{name} does not take q{tuple(q.shape)}/{q.dtype}, "
            f"k{tuple(k.shape)}/{k.dtype}, v{tuple(v.shape)}/{v.dtype} "
            f"(contiguous: {q.is_contiguous()}, {k.is_contiguous()}, "
            f"{v.is_contiguous()}): head dim in {SUPPORTED_HEAD_DIMS}, one "
            "dtype of float32/bfloat16, contiguous (B,H,L,D) tensors")
    if not (k.device == q.device and v.device == q.device):
        raise MXNetError("q, k and v must be on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v, do) if t is not None):
        raise MXNetError(f"{name} loads q, k, v and dO in 16-byte copies: "
                         "their data must start on a 16-byte boundary")
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype
                           or not do.is_contiguous()
                           or do.device != q.device):
        raise MXNetError(f"{name}: dO must be a contiguous {q.dtype} tensor "
                         f"of q's shape {tuple(q.shape)} on {q.device}, got "
                         f"{tuple(do.shape)}/{do.dtype}")
    for label, t in (("lse", lse), ("delta", delta)):
        if t is not None and (tuple(t.shape) != tuple(q.shape[:3])
                              or t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != q.device):
            raise MXNetError(f"{name}: {label} must be a contiguous float32 "
                             f"tensor of shape {tuple(q.shape[:3])} on "
                             f"{q.device}")


def _launch(name, q, k, v, key_mask, causal, scale, window, tensors):
    """Launch kernel ``name`` on the current stream of q's device over q,
    k, v, the key mask (as int32, or null) and ``tensors`` (its further
    inputs and outputs in the C entry's order); raises on a refused launch,
    else counts it (inside a CUDA-graph capture, in the graph's tally:
    :mod:`.graphs`)."""
    B, H, Lq, D = q.shape
    mask = None if key_mask is None else key_mask.to(
        device=q.device, dtype=torch.int32).contiguous()
    lib = _library(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[name][0])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            *(t.data_ptr() for t in tensors), _DTYPE_CODES[q.dtype], B, H,
            Lq, k.shape[2], D, _tile("MXTPU_FLASH_BQ"),
            _tile("MXTPU_FLASH_BK"), float(scale), int(bool(causal)),
            int(window or 0), stream)
    if err != 0:
        msg = lib.mxtpu_cuda_error_string(err).decode()
        raise MXNetError(f"{name} launch failed: {msg} (cuda error {err})")
    graphs.count_launch(launches, name)


def _fwd_cuda(q, k, v, key_mask, causal, scale, window):
    _check_inputs(KERNEL, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch(KERNEL, q, k, v, key_mask, causal, scale, window, (o, lse))
    return o, lse


def _bwd_dkv_cuda(q, k, v, key_mask, causal, scale, window, lse, do, delta):
    """dK, dV on the card (kernel ``flash_attention_bwd_dkv``)."""
    _check_inputs(KERNEL_BWD_DKV, q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(KERNEL_BWD_DKV, q, k, v, key_mask, causal, scale, window,
            (do, lse, delta, dk, dv))
    return dk, dv


def _bwd_dq_cuda(q, k, v, key_mask, causal, scale, window, lse, do, delta):
    """dQ on the card (kernel ``flash_attention_bwd_dq``)."""
    _check_inputs(KERNEL_BWD_DQ, q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch(KERNEL_BWD_DQ, q, k, v, key_mask, causal, scale, window,
            (do, lse, delta, dq))
    return dq


def _fwd(q, k, v, key_mask, causal, scale, window=None):
    """``(o, lse)`` for a (B, Lk) key mask or None (JAX counterpart:
    ``flash_attention.py:245``): the kernel for a tensor on the card, the
    plain version for one on the CPU."""
    if q.is_cuda:
        return _fwd_cuda(q, k, v, key_mask, causal, scale, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_mask, causal, scale,
                                         window)
    raise MXNetError(f"flash_attention runs on cuda or cpu, not {q.device}")


def _bwd(q, k, v, key_mask, causal, scale, window, lse, do, delta):
    """``(dq, dk, dv)`` from the forward's ``lse`` and the caller's
    ``delta`` (JAX counterpart: ``flash_attention.py:410``): the two
    kernels for tensors on the card, the plain version on the CPU."""
    if q.is_cuda:
        dk, dv = _bwd_dkv_cuda(q, k, v, key_mask, causal, scale, window, lse,
                               do, delta)
        dq = _bwd_dq_cuda(q, k, v, key_mask, causal, scale, window, lse, do,
                          delta)
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, key_mask, causal, scale,
                                             window, None, lse, do, delta)
    raise MXNetError(f"flash_attention runs on cuda or cpu, not {q.device}")


@torch.library.custom_op("mxtpu::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor], causal: bool,
                        scale: float, window: Optional[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as the registered op ``mxtpu::flash_attention_fwd``:
    ``(o, lse)`` for a (B, Lk) key mask or None. On the card it is the
    kernel (:func:`_fwd_cuda`: it launches or raises), on the CPU the plain
    version; ``register_fake`` gives the shapes, so ``torch.export`` records
    one node per call that a saved program names, and a loaded one runs on
    whichever device its tensors are on. The name is part of every saved
    artifact: it stays."""
    raise MXNetError(f"flash_attention runs on cuda or cpu, not {q.device}")


@flash_attention_fwd.register_kernel("cuda")
def _fwd_op_cuda(q, k, v, key_mask, causal, scale, window):
    return _fwd_cuda(q, k, v, key_mask, causal, scale, window)


@flash_attention_fwd.register_kernel("cpu")
def _fwd_op_cpu(q, k, v, key_mask, causal, scale, window):
    return flash_attention_reference(q, k, v, key_mask, causal, scale,
                                     window)


@flash_attention_fwd.register_fake
def _fwd_op_fake(q, k, v, key_mask, causal, scale, window):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3],
                                             dtype=torch.float32)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward on the dK/dV and dQ kernels (JAX
    counterpart: the custom VJP ``_flash``, ``flash_attention.py:507-525``).
    ``apply(q, k, v, key_mask, causal, scale, window)``; the forward saves
    ``q, k, v, key_mask, o, lse``; the key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale, window):
        o, lse = _fwd(q, k, v, key_mask, causal, scale, window)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = _bwd(q, k, v, key_mask, ctx.causal, ctx.scale,
                          ctx.window, lse, do, _delta(o, do))
        return dq, dk, dv, None, None, None, None


class FlashBlockFunction(torch.autograd.Function):
    """One K/V block's attention as ``(o, lse)``, differentiable in both
    (JAX counterpart: the custom VJP ``flash_block``,
    ``flash_attention.py:533-553``): the lse cotangent enters the score
    gradient as ``dS += p * dlse``, a shift of ``delta``, so the backward
    passes ``rowsum(dO * o) - dlse`` to the same two kernels (``_bwd``,
    ``:417-422``)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale):
        o, lse = _fwd(q, k, v, key_mask, causal, scale)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(q.dtype)
        do = do.contiguous()
        delta = _delta(o, do)
        if dlse is not None:
            delta = (delta - dlse.float()).contiguous()
        dq, dk, dv = _bwd(q, k, v, key_mask, ctx.causal, ctx.scale, None,
                          lse, do, delta)
        return dq, dk, dv, None, None, None


def flash_block(q, k, v, key_mask, causal: bool, scale: float):
    """``(o, lse)`` of ``q`` over one K/V block, ``key_mask`` (B, Lk) or
    None: the unit ring attention merges per hop (same contract as
    :func:`flash_attention`; no window). On the card the kernels launch or
    raise; on the CPU the plain versions run."""
    return FlashBlockFunction.apply(q, k, v, key_mask, bool(causal),
                                    float(scale))


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention over ``q (B, H, Lq, D)``, ``k/v (B, H, Lk, D)``
    with an optional key-padding ``mask`` of shape (B, Lk) or (B,1,1,Lk)
    (1 = attend), bottom-right-aligned ``causal`` masking and a causal
    sliding ``window`` (JAX counterpart: ``flash_attention.py:556``; same
    validation errors). Differentiable in q, k and v."""
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if window is not None:
        window = int(window)
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        if not causal:
            raise ValueError("window= requires causal=True (the sliding "
                             "window is defined over the causal band)")
    key_mask = _as_key_mask(mask, B, H, Lq, Lk)
    if mask is not None and key_mask is None:
        raise ValueError("flash_attention supports key-padding masks "
                         "(B, Lk) / (B,1,1,Lk); use the XLA path otherwise")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, key_mask, causal, scale,
                                            window)
    o, _ = flash_attention_fwd(q, k, v, key_mask, bool(causal), scale,
                               window)
    return o
