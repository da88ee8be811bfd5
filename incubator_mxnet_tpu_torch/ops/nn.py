"""The neural-network ops the BERT serving path calls.

Counterpart: the JAX package's ``ops/nn.py`` and ``ops/tensor.py``. JAX
promotes mixed dtypes where PyTorch's matmul refuses them, so the casts JAX
makes implicitly are written out here. In a "bfloat16" BERT the LayerNorm
parameters stay float32, the normalised value times ``gamma`` promotes to
float32, and every later Dense computes float32 x bfloat16 -> float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "layer_norm", "gelu", "tanh", "activation",
           "embedding", "ACTIVATIONS"]


def fully_connected(data, weight, bias=None, flatten=True):
    """``y = x @ W.T + b`` with ``weight (units, in_units)``; both operands
    promote to the wider dtype as in JAX (JAX counterpart:
    ``ops/nn.py:48``)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = F.linear(x.to(dt), weight.to(dt))
    if bias is not None:
        out = out + bias
    return out


def layer_norm(data, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis with float32 statistics; the normalised
    value is cast back to the input dtype *before* the affine, so float32
    ``gamma``/``beta`` promote a bfloat16 input to float32 (JAX
    counterpart: ``ops/nn.py:331``)."""
    x32 = data.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = x32.var(dim=-1, unbiased=False, keepdim=True)
    out = ((x32 - m) * torch.rsqrt(v + eps)).to(data.dtype)
    return out * gamma + beta


def gelu(x):
    """Exact (erf) GELU (JAX counterpart: ``ops/nn.py:404``,
    ``jax.nn.gelu(approximate=False)``)."""
    return F.gelu(x, approximate="none")


def tanh(x):
    """Hyperbolic tangent (JAX counterpart: ``ops/nn.py:399``)."""
    return torch.tanh(x)


ACTIVATIONS = {"gelu": gelu, "tanh": tanh, "relu": torch.relu,
               "sigmoid": torch.sigmoid, "softrelu": F.softplus}


def activation(data, act_type):
    """Apply a named activation (JAX counterpart: ``ops/nn.py:417``; the
    port carries ``gelu``, ``tanh``, ``relu``, ``sigmoid`` and
    ``softrelu``)."""
    try:
        fn = ACTIVATIONS[act_type]
    except KeyError:
        raise ValueError(f"activation {act_type!r} is not ported yet; "
                         f"known: {sorted(ACTIVATIONS)}") from None
    return fn(data)


def embedding(data, weight):
    """Row lookup with indices clipped to ``[0, rows)`` (JAX counterpart:
    ``ops/tensor.py:854``)."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)
