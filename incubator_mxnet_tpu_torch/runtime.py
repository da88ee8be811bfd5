"""Runtime feature discovery (``mx.runtime``).

Counterpart: the JAX package's ``runtime.py`` (``:1-72``): ``Feature``,
``Features`` (a dict by name, ``is_enabled``) and ``feature_list``, with
the JAX keys (``:30-46``) and values true to this build: ``CUDA``,
``CUDNN``, ``NCCL`` and ``FLASH_ATTENTION`` (the hand-written kernels of
``ops/cuda``) when a card is present; ``TPU``, ``PALLAS`` and ``XLA``
false. Nothing is built or launched to answer: the kernels build at their
first launch.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name: str, enabled: bool):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _has(mod: str) -> bool:
    try:
        __import__(mod)
        return True
    except Exception:  # noqa: BLE001  (any import failure: absent)
        return False


def _detect() -> Dict[str, bool]:
    card = torch.cuda.is_available()
    dist = torch.distributed.is_available()
    return {
        "TPU": False,
        "CUDA": card,
        "CUDNN": card and torch.backends.cudnn.is_available(),
        "NCCL": card and dist and torch.distributed.is_nccl_available(),
        "TENSORRT": False,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "CPU": True,
        "XLA": False,
        "PALLAS": False,
        "BF16": True,
        "INT64_TENSOR_SIZE": True,
        "DIST_KVSTORE": dist,
        "SIGNAL_HANDLER": True,
        "OPENCV": _has("cv2"),
        "F16C": False,
        "FLASH_ATTENTION": card,
        "MESH_SPMD": dist,
        "PROFILER": True,
    }


class Features(dict):
    """dict-like: ``fts = mx.runtime.Features(); fts.is_enabled('CUDA')``."""

    def __init__(self):
        super().__init__({k: Feature(k, v) for k, v in _detect().items()})

    def is_enabled(self, name: str) -> bool:
        f = self.get(name.upper())
        return bool(f and f.enabled)

    def __repr__(self):
        return "[" + ", ".join(repr(v) for v in self.values()) + "]"


def feature_list() -> List[Feature]:
    return list(Features().values())
