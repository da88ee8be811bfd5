"""Multi-process runtime: one process per rank under ``torch.distributed``.

Counterpart: the JAX package's ``parallel/dist.py``. There, every host runs
the same program and ``jax.distributed.initialize`` makes one runtime over
all devices. Here every rank is a process of its own, and
:func:`initialize` joins it to one ``torch.distributed`` process group:

- on the card the backend is NCCL, one rank per card (the rank's card is
  ``cuda:<rank % device_count>``, made current);
- on the CPU it is gloo, one rank per process, and only when the caller
  asks for the CPU (``device="cpu"`` or ``backend="gloo"``): a machine
  with a card never falls back to gloo.

The rendezvous reads the variables of the repo's ``tools/launch.py`` (and
of the port's :mod:`~..tools.launch`), as the JAX package does
(``dist.py:58-68``):

- ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT`` -> ``coordinator_address``
  (a TCP store, ``tcp://<uri>:<port>``)
- ``DMLC_NUM_WORKER`` -> ``num_processes``
- ``DMLC_WORKER_ID`` -> ``process_id``

One process with no coordinator is a no-op, as in the JAX package; with
an explicit ``backend`` it makes a one-rank group (an in-process store),
so that NCCL runs on one card. As the JAX ``initialize`` does
(``:83-91``), :func:`initialize` ends by starting the elastic lease
daemon (:func:`.elastic.start`: a no-op unless ``MXTPU_ELASTIC=1`` and
the pod has more than one member), and :func:`finalize` begins by
stopping it.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as tdist

from ..base import MXNetError

__all__ = ["initialize", "finalize", "process_count", "process_index",
           "world", "is_primary", "process_namespace", "initialized",
           "store_address"]

#: seconds a collective or the rendezvous waits before it raises
TIMEOUT_S = 300

#: ``(host, port)`` of the process group's TCP store, once initialised
_STORE_ADDR: list = [None]


def initialized() -> bool:
    """Is this process in a ``torch.distributed`` process group?"""
    return tdist.is_available() and tdist.is_initialized()


def _backend(backend: Optional[str], device) -> str:
    if backend is not None:
        if backend == "gloo" and device is not None \
                and torch.device(device).type == "cuda":
            raise MXNetError("backend='gloo' has no send/recv of CUDA "
                             "tensors: use nccl on the card")
        return backend
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise MXNetError("parallel.dist.initialize: no CUDA device for "
                         "NCCL; pass device='cpu' (or backend='gloo') to "
                         "run the ranks on the CPU")
    return "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Join this process to the process group (module docstring). A no-op
    when already initialised, and for one process with no coordinator and
    no explicit ``backend``."""
    if initialized():
        return
    from . import elastic
    if coordinator_address is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9000")
        if uri:
            coordinator_address = f"{uri}:{port}"
    if num_processes is None and "DMLC_NUM_WORKER" in os.environ:
        num_processes = int(os.environ["DMLC_NUM_WORKER"])
    if process_id is None and "DMLC_WORKER_ID" in os.environ:
        process_id = int(os.environ["DMLC_WORKER_ID"])
    n = 1 if num_processes is None else int(num_processes)
    if n == 1 and coordinator_address is None and backend is None:
        return                      # single process: nothing to do
    be = _backend(backend, device)
    rank = int(process_id or 0)
    if be == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    timeout = timedelta(seconds=TIMEOUT_S)
    if coordinator_address is None:
        # one rank, no peer to meet: an in-process store
        tdist.init_process_group(be, store=tdist.HashStore(), rank=0,
                                 world_size=1, timeout=timeout)
    else:
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        tdist.init_process_group(be, init_method=addr, rank=rank,
                                 world_size=n, timeout=timeout)
        if addr.startswith("tcp://"):
            host, _, port = addr[len("tcp://"):].rpartition(":")
            _STORE_ADDR[0] = (host, int(port))
    # membership is explicit from here on: a rank that dies later is a
    # detected loss (HostLossError at the next step), not a peer blocked
    # in a collective (one environment read when elastic is off)
    elastic.start()


def finalize() -> None:
    """Leave the process group (a no-op outside one). Meshes built on it
    are dead afterwards."""
    from . import elastic, mesh
    elastic.stop()
    mesh.set_default_mesh(None)
    _STORE_ADDR[0] = None
    if initialized():
        tdist.destroy_process_group()


def store_address() -> Optional[Tuple[str, int]]:
    """``(host, port)`` of the process group's TCP store, or None (no
    group, or a one-rank group's in-process store)."""
    return _STORE_ADDR[0] if initialized() else None


def world() -> Tuple[int, int]:
    """``(process_index, process_count)``: the group's rank and size once
    initialised, else the launcher's ``DMLC_WORKER_ID`` and
    ``DMLC_NUM_WORKER``, else ``(0, 1)`` (JAX counterpart: ``dist.py:108``).
    """
    if initialized():
        return tdist.get_rank(), tdist.get_world_size()
    try:
        idx = int(os.environ.get("DMLC_WORKER_ID", "0") or 0)
        n = int(os.environ.get("DMLC_NUM_WORKER", "1") or 1)
    except ValueError:
        return 0, 1
    return idx, max(n, 1)


def process_count() -> int:
    return world()[1]


def process_index() -> int:
    return world()[0]


def is_primary() -> bool:
    """True on rank 0, the rank every file written once (checkpoint
    manifests, optimizer-state files) is left to; a lone process is
    always primary."""
    return world()[0] == 0


def process_namespace() -> str:
    """``""`` for one process, ``"p<index>"`` for a rank of several: the
    token that keeps each rank's files apart."""
    idx, n = world()
    return f"p{idx}" if n > 1 else ""
