"""Spatial ops: the spatial transformer family, Correlation, Crop,
batch_take and MakeLoss, registered under MXNet's names.

Counterpart: the JAX package's ``ops/vision.py``. ``BilinearSampler`` is
``F.grid_sample`` with ``align_corners=True`` and zero padding: the
reference's 4-tap sampler at ``x = (g + 1) (W - 1) / 2`` with taps outside
the image reading 0. ``Correlation`` walks the displacement grid in a loop
of shifted products, as the reference's ``vmap`` over its offset table
does. ``MakeLoss`` is a ``torch.autograd.Function`` whose backward seeds
``grad_scale`` (over the batch or the count of valid elements), as the
reference's ``custom_vjp``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = ["grid_generator", "bilinear_sampler", "spatial_transformer",
           "correlation", "crop", "batch_take", "make_loss"]


def _grid(H, W, device):
    ys = torch.linspace(-1.0, 1.0, H, device=device)
    xs = torch.linspace(-1.0, 1.0, W, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


@register_op("GridGenerator", aliases=("grid_generator",))
def grid_generator(data, transform_type="affine", target_shape=(0, 0), **_):
    """The sampling grid (N, 2, H, W) of (x, y) in [-1, 1]: from a
    row-major 2x3 affine ``data`` (N, 6) over the target raster
    (``affine``), or the identity grid plus a flow in pixels (N, 2, H, W)
    (``warp``) (JAX counterpart: ``ops/vision.py:29``)."""
    if transform_type == "affine":
        N = data.shape[0]
        H, W = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(N, 2, 3).float()
        gy, gx = _grid(H, W, data.device)
        src = torch.stack([gx.reshape(-1), gy.reshape(-1),
                           torch.ones_like(gx).reshape(-1)], 0)
        out = torch.einsum("nij,jk->nik", theta, src)
        return out.reshape(N, 2, H, W).to(data.dtype)
    if transform_type == "warp":
        N, _, H, W = data.shape
        flow = data.float()
        gy, gx = _grid(H, W, data.device)
        nx = gx[None] + flow[:, 0] * (2.0 / max(W - 1, 1))
        ny = gy[None] + flow[:, 1] * (2.0 / max(H - 1, 1))
        return torch.stack([nx, ny], 1).to(data.dtype)
    raise ValueError(
        f"GridGenerator: unknown transform_type {transform_type!r}")


@register_op("BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid, **_):
    """``data`` (N, C, H, W) sampled bilinearly at ``grid`` (N, 2, Ho, Wo)
    of normalised (x, y), zeros outside (JAX counterpart:
    ``ops/vision.py:59``)."""
    out = F.grid_sample(data.float(), grid.float().permute(0, 2, 3, 1),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.to(data.dtype)


@register_op("SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        **_):
    """The grid from ``loc``, then bilinear sampling of ``data``."""
    if sampler_type != "bilinear":
        raise ValueError("SpatialTransformer supports sampler_type='bilinear'")
    grid = grid_generator(loc, transform_type=transform_type,
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)


@register_op("Correlation", aliases=("correlation",))
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True, **_):
    """FlowNet's correlation (JAX counterpart: ``ops/vision.py:103``):
    output channel ``d`` is the channel mean of ``data1 *
    shift(data2, d)`` (or ``-|data1 - shift|``) over a
    ``(2 * (max_displacement // stride2) + 1)^2`` displacement grid,
    averaged over a ``kernel_size`` window, on the border-trimmed raster
    strided by ``stride1``."""
    pads = (pad_size,) * 4
    x1 = F.pad(data1.float(), pads)
    x2 = F.pad(data2.float(), pads)
    d_max = max_displacement // stride2 * stride2
    offs = range(-d_max, d_max + 1, stride2)
    Hp, Wp = x1.shape[2], x1.shape[3]
    ys = torch.arange(Hp, device=x1.device)
    xs = torch.arange(Wp, device=x1.device)
    outs = []
    for dy in offs:
        for dx in offs:
            shifted = torch.roll(x2, shifts=(-dy, -dx), dims=(2, 3))
            valid = (((ys + dy >= 0) & (ys + dy < Hp))[:, None]
                     & ((xs + dx >= 0) & (xs + dx < Wp))[None, :])
            prod = x1 * shifted if is_multiply else -torch.abs(x1 - shifted)
            outs.append(prod.mean(dim=1) * valid)
    out = torch.stack(outs, 1)
    k = kernel_size
    if k > 1:
        lo = (k - 1) // 2
        out = F.avg_pool2d(F.pad(out, (lo, k - 1 - lo, lo, k - 1 - lo)), k,
                           stride=1)
    border = max_displacement + (kernel_size - 1) // 2
    out = out[:, :, border:Hp - border:stride1, border:Wp - border:stride1]
    return out.to(data1.dtype)


@register_op("Crop", aliases=("crop_like",))
def crop(data, shape_like=None, offset=(0, 0), h_w=(0, 0),
         center_crop=False, **_):
    """``data``'s last two axes cropped to ``h_w``, or to ``shape_like``'s
    (JAX counterpart: ``ops/vision.py:164``)."""
    H, W = data.shape[-2], data.shape[-1]
    if shape_like is not None:
        th, tw = shape_like.shape[-2], shape_like.shape[-1]
    else:
        th, tw = h_w
        if th == 0 or tw == 0:
            raise ValueError("Crop needs h_w or a shape_like input")
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = offset
    return data[..., oy:oy + th, ox:ox + tw]


@register_op("batch_take")
def batch_take(a, indices, **_):
    """``out[i] = a[i, indices[i]]``: a negative index counts from the
    end, one past the end gives NaN (float) as the reference's gather
    fills it."""
    n = a.shape[1]
    idx = indices.to(torch.int32).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    bad = (idx < 0) | (idx >= n)
    out = torch.gather(a, 1, idx.clamp(0, n - 1)[:, None])[:, 0]
    if a.is_floating_point():
        out = out.masked_fill(bad, float("nan"))
    return out


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward is ``grad_scale`` everywhere (over
    the batch or the valid count), ignoring the incoming gradient."""

    @staticmethod
    def forward(ctx, data, valid_count, scale, normalization):
        ctx.shape, ctx.dtype = data.shape, data.dtype
        ctx.scale, ctx.normalization = scale, normalization
        ctx.save_for_backward(valid_count)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        (valid_count,) = ctx.saved_tensors
        scale = torch.tensor(ctx.scale, dtype=torch.float32,
                             device=valid_count.device)
        if ctx.normalization == "batch":
            scale = scale / ctx.shape[0]
        elif ctx.normalization == "valid":
            scale = scale / valid_count.clamp_min(1.0)
        return scale.expand(ctx.shape).to(ctx.dtype), None, None, None


@register_op("MakeLoss", aliases=("make_loss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null",
              **_):
    """A loss head (JAX counterpart: ``ops/vision.py:187``): forward is the
    identity; backward seeds ``grad_scale``, divided by the batch size
    (``batch``) or by the count of elements above ``valid_thresh``
    (``valid``)."""
    if normalization not in ("null", "batch", "valid"):
        raise ValueError(f"MakeLoss: unknown normalization {normalization!r}")
    if normalization == "valid":
        valid = (data > valid_thresh).float().sum()
    else:
        valid = torch.ones((), device=data.device)
    return _MakeLoss.apply(data, valid.detach(), float(grad_scale),
                           normalization)
