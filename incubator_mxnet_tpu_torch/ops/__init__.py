"""Operators of the port: plain PyTorch, plus hand-written CUDA kernels
under :mod:`.cuda` where the JAX package had a Pallas kernel."""
from . import attention, cuda, nn, optimizer_ops  # noqa: F401
from .attention import dot_product_attention  # noqa: F401
