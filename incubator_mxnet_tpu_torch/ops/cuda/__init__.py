"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each kernel has one source ``csrc/<name>.cu``, a wrapper module here with a
plain PyTorch version of the same function beside it, and a launch count
in that module's ``launches`` dict, which counts the launches of a
captured CUDA graph on each replay (:mod:`.graphs`). :data:`KERNELS` lists
them for callers that drive every kernel (``chip_smoke.py``). Importing
this package registers the flash forward as the op
``mxtpu::flash_attention_fwd``, which every exported program names, so
``torch.export.load`` finds it in any process that imported the port.
"""
from typing import Dict

from . import flash_attention  # noqa: F401

#: kernel name -> wrapper module (whose ``launches[name]`` counts it)
KERNELS = {name: flash_attention for name in flash_attention.KERNELS}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name, mod in KERNELS.items():
        mod.launches[name] = 0


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last :func:`reset_launches`."""
    return {name: mod.launches[name] for name, mod in KERNELS.items()}
