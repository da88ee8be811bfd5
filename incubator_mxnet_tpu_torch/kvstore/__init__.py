"""KVStore: the gradient-exchange and parameter-synchronisation API
(``mx.kv``).

Counterpart: the JAX package's ``kvstore/__init__.py`` (reference:
``include/mxnet/kvstore.h``). The same names over one mechanism, the
collectives of ``torch.distributed`` (:mod:`..parallel.dist`):

========================  =================================================
``create('local')``       in-process aggregating store
``create('device')``      the same (the store lives where the values do)
``create('nccl')``        pushes summed over every rank of the process
                          group (NCCL on the card, gloo on the CPU);
                          ``dist_sync``, ``dist_device_sync``, ``dist``,
                          ``mesh``, ``horovod`` and ``byteps`` too. One
                          process without a group: local semantics.
``create('dist_async')``  raises: the asynchronous parameter server
                          (the JAX package's ``async_ps.py``) is ROADMAP
                          queue A item 7c.
========================  =================================================

A push of a key batch sums every key's replica list locally, then all
ranks' sums in **one** flat ``all_reduce`` per dtype for the whole batch
(KVStoreNCCL's grouped all-reduce), never one per key. ``set_optimizer``
updates on the store, as the reference's server-side optimizer does;
``set_gradient_compression`` is 2-bit with error feedback.
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional, Union

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.serialization import from_host, to_host

__all__ = ["KVStore", "KVStoreBase", "GradientCompressionMixin", "create",
           "register"]


def _tensor(v) -> torch.Tensor:
    return v._data if isinstance(v, NDArray) else torch.as_tensor(v)


def _select_rows(w: torch.Tensor, ids) -> torch.Tensor:
    """Zeros but the rows named by ``ids``, which carry ``w``'s values: the
    dense reading of a row_sparse pull (JAX counterpart: ``:57``)."""
    idx = _tensor(ids).to(device=w.device, dtype=torch.long).reshape(-1)
    out = torch.zeros_like(w)
    out[idx] = w[idx]
    return out


def _world_allreduce(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's tensors summed: one flat ``all_reduce`` per (device,
    dtype) for the whole list; the tensors as they are without a group."""
    from ..parallel import dist
    if not dist.initialized():
        return tensors
    import torch.distributed as tdist
    out = list(tensors)
    groups: Dict[tuple, List[int]] = {}
    for k, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(k)
    for ks in groups.values():
        flat = torch.cat([tensors[k].reshape(-1) for k in ks])
        tdist.all_reduce(flat)
        off = 0
        for k in ks:
            n = tensors[k].numel()
            out[k] = flat[off:off + n].view_as(tensors[k])
            off += n
    return out


_REGISTRY: Dict[str, type] = {}


def register(name_or_cls=None):
    """Backend plugin registry (reference: the ``KVStoreBase`` plugin
    seam); ``@register`` or ``@register("name")``."""
    def _do(cls, name=None):
        _REGISTRY[(name or cls.__name__).lower()] = cls
        return cls
    if isinstance(name_or_cls, str):
        return lambda cls: _do(cls, name_or_cls)
    if name_or_cls is not None:
        return _do(name_or_cls)
    return _do


def create(name: str = "local", **kwargs) -> "KVStoreBase":
    """KVStore factory (reference: ``mx.kv.create``)."""
    if not isinstance(name, str):
        raise MXNetError(f"KVStore name must be a string, got {type(name)}")
    key = name.lower()
    if key == "dist_async":
        raise MXNetError(
            "kvstore 'dist_async' is the asynchronous parameter server "
            "(the JAX package's kvstore/async_ps.py), ROADMAP queue A item "
            "7c: not ported yet; 'dist_sync' sums pushes across ranks")
    if key in ("local", "device", "local_allreduce_cpu",
               "local_allreduce_device"):
        return KVStore(comm="local", **kwargs)
    if key in ("nccl", "mesh", "dist", "dist_sync", "dist_device_sync",
               "horovod", "byteps"):
        return KVStore(comm="mesh", **kwargs)
    if key in _REGISTRY:
        return _REGISTRY[key](**kwargs)
    raise MXNetError(
        f"Unknown KVStore type '{name}'. Built-ins: local, device, nccl, "
        f"dist_sync, dist_async; plugins: {sorted(_REGISTRY)}")


class GradientCompressionMixin:
    """2-bit gradient compression with error feedback (reference:
    ``src/kvstore/gradient_compression.cc`` TwoBitCompressor; JAX
    counterpart: ``:182-236``). Hosts set ``self._compression = {}`` and
    ``self._residuals = {}`` and call ``self._compress(key, replica,
    grad)`` per replica before aggregation."""

    def set_gradient_compression(self, compression_params: dict):
        """Each replica's push is quantised per key to {-threshold, 0,
        +threshold} before aggregation, the quantisation residual carried
        into the next push (error feedback): the reference's numbers; the
        values still travel as full-width floats."""
        params = dict(compression_params or {})
        ctype = params.get("type", params.get("compression"))
        if not params or ctype in ("none",):
            self._compression = {}
            self._residuals = {}
            return
        if ctype is None:
            raise MXNetError("gradient compression params need a 'type' "
                             "key (supported: '2bit')")
        if ctype != "2bit":
            raise MXNetError(f"unsupported gradient compression {ctype!r}; "
                             "supported: '2bit'")
        self._compression = params
        self._residuals = {}

    def _compress(self, k, rep_idx, g: torch.Tensor) -> torch.Tensor:
        if not self._compression:
            return g
        threshold = float(self._compression.get("threshold", 0.5))
        rkey = (k, rep_idx)
        res = self._residuals.get(rkey)
        if res is None or res.shape != g.shape:
            res = torch.zeros_like(g)
        acc = g + res
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        q = torch.where(acc >= threshold, zero + threshold,
                        torch.where(acc <= -threshold, zero - threshold,
                                    zero))
        self._residuals[rkey] = acc - q
        return q


class KVStoreBase:
    """Minimal backend interface (reference: ``kvstore/base.py``)."""

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority: int = 0):
        raise NotImplementedError

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority: int = 0):
        self.push(key, value, priority)
        return self.pull(key, out=out, priority=priority)

    def broadcast(self, key, value, out=None, priority: int = 0):
        self.init(key, value)
        return self.pull(key, out=out, priority=priority)

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1


def _write(out: NDArray, src: torch.Tensor) -> None:
    """``src`` into ``out``'s tensor, in place, in ``out``'s dtype and
    device."""
    with torch.no_grad():
        out._data.copy_(src)


class KVStore(GradientCompressionMixin, KVStoreBase):
    """The aggregating store (JAX counterpart: ``:263``): ``init`` seeds a
    key; ``push`` accumulates (a list value pushes the sum of the list);
    ``pull`` returns the merged value, or the weight after the update when
    an optimizer or updater is set. ``comm='mesh'`` sums the pushes across
    the ranks of the process group too."""

    def __init__(self, comm: str = "local"):
        self._comm = comm
        self._store: Dict[Union[int, str], NDArray] = {}
        self._merged: Dict[Union[int, str], NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._opt_states: Dict[Union[int, str], tuple] = {}
        self._compression: Dict[str, float] = {}
        self._residuals: Dict = {}

    @property
    def type(self) -> str:
        return "device" if self._comm == "local" else "dist_sync"

    @property
    def rank(self) -> int:
        from ..parallel import dist
        return dist.process_index() if self._comm == "mesh" else 0

    @property
    def num_workers(self) -> int:
        from ..parallel import dist
        return dist.process_count() if self._comm == "mesh" else 1

    @staticmethod
    def _keys(key):
        return list(key) if isinstance(key, (list, tuple)) else [key]

    def _vals(self, key, value):
        if isinstance(key, (list, tuple)):
            if len(key) != len(value):
                raise MXNetError("key list and value list length mismatch")
            return list(value)
        return [value]

    def init(self, key, value):
        for k, v in zip(self._keys(key), self._vals(key, value)):
            if isinstance(v, (list, tuple)):
                v = v[0]
            if k in self._store:
                continue
            self._store[k] = NDArray(_tensor(v).detach().clone())

    def push(self, key, value, priority: int = 0):
        """Accumulate: each key's replica list summed, then (``mesh``)
        every rank's sums in one flat all-reduce for the key batch."""
        keys, sums = [], []
        for k, v in zip(self._keys(key), self._vals(key, value)):
            vlist = v if isinstance(v, (list, tuple)) else [v]
            parts = [self._compress(k, i, _tensor(x).detach())
                     for i, x in enumerate(vlist)]
            total = parts[0].clone()
            for a in parts[1:]:
                total = total + a.to(total.dtype)
            keys.append(k)
            sums.append(total)
        if self._comm == "mesh":
            sums = _world_allreduce(sums)
        for k, merged in zip(keys, sums):
            if self._updater is not None or self._optimizer is not None:
                if k not in self._store:
                    raise MXNetError(f"please init key {k!r} before push")
                self._apply_update(k, merged)
            else:
                self._merged[k] = NDArray(merged)

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True):
        results = []
        for k in self._keys(key):
            if self._updater is not None or self._optimizer is not None:
                src = self._store.get(k)
            else:
                src = self._merged.get(k, self._store.get(k))
            if src is None:
                raise MXNetError(f"key {k!r} was never initialized or pushed")
            results.append(src)
        if out is not None:
            if isinstance(key, (list, tuple)):
                outs = out
                if len(outs) != len(results):
                    raise MXNetError(
                        "pull: out list length != key list length")
            else:
                outs = [out]
            for o, r in zip(outs, results):
                for oo in (o if isinstance(o, (list, tuple)) else [o]):
                    _write(oo, r._data)
            return out
        return results if isinstance(key, (list, tuple)) else results[0]

    def row_sparse_pull(self, key, out=None, priority: int = 0,
                        row_ids=None):
        """Pull only the rows named by ``row_ids`` into ``out``: a dense
        array with those rows and zeros elsewhere (JAX counterpart:
        ``:383``)."""
        if row_ids is None:
            return self.pull(key, out=out, priority=priority)
        keys = self._keys(key)
        if out is None:
            raise MXNetError("row_sparse_pull needs out= when row_ids given")
        if isinstance(key, (list, tuple)):
            outs = list(out)
            ids_list = list(row_ids) if isinstance(row_ids, (list, tuple)) \
                else [row_ids] * len(keys)
        else:
            # one key: row_ids pair with the out slots
            keys = keys * (len(out) if isinstance(out, (list, tuple)) else 1)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            ids_list = list(row_ids) if isinstance(row_ids, (list, tuple)) \
                else [row_ids] * len(outs)
        if not len(keys) == len(outs) == len(ids_list):
            raise MXNetError(
                f"row_sparse_pull: mismatched lengths — {len(keys)} keys, "
                f"{len(outs)} outs, {len(ids_list)} row_ids")
        for k, o, ids in zip(keys, outs, ids_list):
            src = self._store.get(k)
            if src is None:
                raise MXNetError(f"key {k!r} was never initialized")
            rows = _select_rows(src._data, ids)
            for oo in (o if isinstance(o, (list, tuple)) else [o]):
                _write(oo, rows)
        return out

    # -- update on the store ----------------------------------------------
    def set_updater(self, updater: Callable):
        """``updater(key, grad, weight)`` runs at each push (reference:
        ``KVStore.set_updater``)."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        from .. import optimizer as opt_mod
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer)
        self._optimizer = optimizer

    def _apply_update(self, k, grad: torch.Tensor):
        weight = self._store[k]
        if self._updater is not None:
            self._updater(k, NDArray(grad), weight)
            return
        idx = k if isinstance(k, int) else abs(hash(k)) % (2 ** 31)
        if k not in self._opt_states:
            self._opt_states[k] = \
                self._optimizer.create_state_multi_precision(
                    idx, weight._data)
        self._opt_states[k] = self._optimizer.update(
            idx, weight, NDArray(grad), self._opt_states[k])

    # -- persistence -------------------------------------------------------
    def save_optimizer_states(self, fname: str, dump_optimizer: bool = False):
        """The update-on-store states as the JAX package writes them (a
        pickle of numpy arrays); only the primary writes (the states are
        the same on every rank)."""
        from ..parallel.dist import is_primary
        if not is_primary():
            return
        blob = {"states": {k: tuple(to_host(getattr(s, "_data", s))
                                    for s in st)
                           for k, st in self._opt_states.items()}}
        with open(fname, "wb") as f:
            pickle.dump(blob, f)

    def load_optimizer_states(self, fname: str):
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        dev = {k: v._data.device for k, v in self._store.items()}
        self._opt_states = {
            k: tuple(from_host(s, dev.get(k, "cpu")) for s in st)
            for k, st in blob["states"].items()}

    def barrier(self):
        """Every rank waits for the others (``mesh`` with a group)."""
        from ..parallel import dist
        if self._comm == "mesh" and dist.initialized():
            import torch.distributed as tdist
            tdist.barrier()

    def __repr__(self):
        return f"KVStore(type={self.type!r}, keys={len(self._store)})"
