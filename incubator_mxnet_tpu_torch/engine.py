"""The execution-engine facade.

Counterpart: the JAX package's ``engine.py``. CUDA streams order the
card's work and overlap it with host code, as the reference's dependency
engine did, so what remains of the engine API is ``waitall()`` (block
until all queued device work is done) and the accepted, inert knobs.
"""
from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["waitall", "naive_engine", "engine_type", "bulk", "set_bulk_size"]

_BULK_SIZE = 15


def engine_type() -> str:
    return os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")


def waitall() -> None:
    """Block until the work queued on every CUDA device this process has
    used is done (``mx.nd.waitall``; JAX counterpart: ``engine.py:36``).
    Without CUDA work there is nothing to wait for."""
    if not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def naive_engine():
    """Serialised execution for debugging: PyTorch already runs each op
    as it is called, so this only waits for the card on exit."""
    try:
        yield
    finally:
        waitall()


def set_bulk_size(size: int) -> int:
    """Accepted for parity (Engine::SetBulkSize); returns the previous
    size."""
    global _BULK_SIZE
    prev, _BULK_SIZE = _BULK_SIZE, size
    return prev


@contextlib.contextmanager
def bulk(size: int):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
