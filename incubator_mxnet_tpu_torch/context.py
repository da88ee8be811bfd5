"""Device contexts and device resolution.

Counterpart: the JAX package's ``context.py`` (``Context`` at ``:79``,
``cpu``/``gpu`` at ``:176-191``, ``current_context`` at ``:198``,
``num_gpus`` at ``:216``). ``gpu(i)`` is ``torch.device("cuda", i)``. The
CPU is one device, ``cpu(0)``: as in the JAX package (``context.py:121-127``,
``Context.jax_device``), any context may be constructed, and one whose
``device_id`` is out of range raises "device_id out of range" when it is
first used (``torch_device``: arrays, parameters, generators). The
default context is ``gpu(0)``, and the default device of the entry points
that take ``device=`` is the card: asking for it on a machine without one
raises instead of falling back to the CPU, so a run never measures the CPU
while claiming the card.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["DEFAULT_DEVICE", "resolve_device", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "as_context"]

DEFAULT_DEVICE = "cuda"
#: CPU devices a context may name: torch has one
CPU_DEVICES = 1


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

    devtype2id = {"cpu": 1, "gpu": 2}
    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in self.devtype2id:
            raise MXNetError(f"Unknown device type {device_type!r}; the port "
                             "has 'cpu' and 'gpu'")
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
        if self.device_type == "cpu":
            if not 0 <= self.device_id < CPU_DEVICES:
                raise MXNetError(
                    f"{self}: device_id out of range, only {CPU_DEVICES} "
                    "device(s) of this type are visible")
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

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
