"""Device contexts and device resolution.

Counterpart: the JAX package's ``context.py`` (``Context`` at ``:79``,
``cpu``/``gpu`` at ``:176-191``, ``current_context`` at ``:198``,
``num_gpus`` at ``:216``). ``gpu(i)`` is ``torch.device("cuda", i)``. The
CPU is one torch device; ``cpu(0)`` names it, and so does ``cpu(i)`` for
``i < MXTPU_CPU_DEVICES`` (default 1), the contexts of a parameter's
replicas in host memory (:func:`cpu_devices`). As in the JAX package
(``context.py:121-127``, ``Context.jax_device``), any context may be
constructed, and one whose
``device_id`` is out of range raises "device_id out of range" when it is
first used (``torch_device``: arrays, parameters, generators). The
default context is ``gpu(0)``, and the default device of the entry points
that take ``device=`` is the card: asking for it on a machine without one
raises instead of falling back to the CPU, so a run never measures the CPU
while claiming the card.

``cpu_pinned``/``cpu_shared`` (JAX ``context.py:171-177``; MXNet's
kCPUPinned and kCPUShared) are host contexts: an array moved to
``cpu_pinned()`` with ``as_in_context``/``copyto`` (or made there by
``nd.array``) is in page-locked memory when a card is present, the staging
buffer of an asynchronous H2D copy; without a card, page-locking is not
available and it is ordinary host memory. ``gpu_memory_info`` is
``torch.cuda.mem_get_info``; ``memory_stats`` reads the caching allocator
on the card and the process's resident set on the host (JAX
``context.py:153-236``).
"""
from __future__ import annotations

import os
import threading
from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["DEFAULT_DEVICE", "resolve_device", "Context", "cpu", "gpu",
           "cpu_pinned", "cpu_shared", "current_context", "num_gpus",
           "as_context", "gpu_memory_info", "memory_stats"]

DEFAULT_DEVICE = "cuda"


def cpu_devices() -> int:
    """The CPU contexts one may name, ``cpu(0)`` to ``cpu(n - 1)``
    (``MXTPU_CPU_DEVICES``, default 1): torch has one CPU device, and
    contexts past ``cpu(0)`` hold replicas in host memory (the JAX
    package counts the host platform's devices, which
    ``--xla_force_host_platform_device_count`` sets)."""
    try:
        return max(1, int(os.environ.get("MXTPU_CPU_DEVICES", "1")))
    except ValueError:
        return 1


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises :class:`MXNetError` when a CUDA device
    is asked for and none is present (JAX counterpart:
    ``context.py:198``, which resolves the default context)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "present; pass device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise MXNetError(
                f"device {str(dev)!r} out of range: "
                f"{torch.cuda.device_count()} CUDA device(s) present")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         "'cpu'")
    return dev


class Context:
    """A device context ``(device_type, device_id)``, ``cpu`` or ``gpu``
    (JAX counterpart: ``context.py:79``). ``with ctx:`` makes it the default
    of the array factories and ``Block.initialize`` in this thread."""

    devtype2id = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}
    devid2type = {v: k for k, v in devtype2id.items()}
    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in self.devtype2id:
            raise MXNetError(f"Unknown device type {device_type!r}; the port "
                             f"has {sorted(self.devtype2id)}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @classmethod
    def from_device(cls, device: torch.device) -> "Context":
        """The context of a ``torch.device`` (``cuda:i`` is ``gpu(i)``)."""
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        return cls("cpu", 0)

    @property
    def device_typeid(self) -> int:
        return self.devtype2id[self.device_type]

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device``; raises for ``gpu`` without a card and for
        a ``device_id`` out of range (JAX counterpart: ``context.py:121``).
        """
        if self.device_type != "gpu":
            n = cpu_devices()
            if not 0 <= self.device_id < n:
                raise MXNetError(
                    f"{self}: device_id out of range, only {n} "
                    "device(s) of this type are visible")
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

    def place(self, t: torch.Tensor, dtype=None) -> torch.Tensor:
        """One copy of ``t`` on this context, in ``dtype`` (default: its
        own): on its device, and page-locked for ``cpu_pinned`` when a card
        is present."""
        dtype = dtype or t.dtype
        if self.device_type == "cpu_pinned" and torch.cuda.is_available():
            return torch.empty(t.shape, dtype=dtype, pin_memory=True).copy_(t)
        return t.to(self.torch_device, dtype, copy=True)

    def memory_stats(self) -> dict:
        """Memory of this context's device (JAX counterpart:
        ``context.py:153``): on the card the caching allocator's bytes in
        use, reserved and at peak, and the device's total as
        ``bytes_limit`` (``source="torch"``); on the host the process's
        resident bytes and the physical memory (``source="host"``)."""
        dev = self.torch_device
        if dev.type == "cuda":
            _, total = torch.cuda.mem_get_info(dev)
            return {"bytes_in_use": int(torch.cuda.memory_allocated(dev)),
                    "bytes_reserved": int(torch.cuda.memory_reserved(dev)),
                    "peak_bytes_in_use":
                        int(torch.cuda.max_memory_allocated(dev)),
                    "bytes_limit": int(total), "source": "torch"}
        page = os.sysconf("SC_PAGE_SIZE")
        with open("/proc/self/statm") as f:
            resident = int(f.read().split()[1]) * page
        return {"bytes_in_use": resident,
                "bytes_limit": int(os.sysconf("SC_PHYS_PAGES") * page),
                "source": "host"}

    def __eq__(self, other) -> bool:
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(Context._default, "stack"):
            Context._default.stack = []
        Context._default.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Page-locked host memory (module docstring)."""
    return Context("cpu_pinned", device_id)


def cpu_shared(device_id: int = 0) -> Context:
    """Host memory, MXNet's shared-memory context (the port's multi-worker
    ``DataLoader`` shares its batches through ``/dev/shm`` itself)."""
    return Context("cpu_shared", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA device ``device_id`` (``torch.device("cuda", device_id)``)."""
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` of this thread, else ``gpu(0)``."""
    stack = getattr(Context._default, "stack", None)
    return stack[-1] if stack else gpu(0)


def num_gpus() -> int:
    """Number of CUDA devices visible."""
    return torch.cuda.device_count()


def as_context(ctx) -> Context:
    """A :class:`Context` from a context, a ``torch.device``, a device
    string (``"cuda:0"``, ``"cpu"``) or ``None`` (the current context)."""
    if ctx is None:
        return current_context()
    if isinstance(ctx, Context):
        return ctx
    return Context.from_device(torch.device(ctx))


def gpu_memory_info(device_id: int = 0) -> tuple:
    """``(free, total)`` bytes of CUDA device ``device_id``
    (``torch.cuda.mem_get_info``; JAX counterpart: ``context.py:215``).
    Raises without a card."""
    free, total = torch.cuda.mem_get_info(
        resolve_device(torch.device("cuda", device_id)))
    return int(free), int(total)


def memory_stats(device_id: int = 0) -> dict:
    """:meth:`Context.memory_stats` of ``gpu(device_id)`` (JAX counterpart:
    ``context.py:230``)."""
    return gpu(device_id).memory_stats()
