"""ModelRegistry: versioned multi-model load and unload for the server.

Counterpart: the JAX package's ``serve/registry.py`` (``ModelVersion``
``:46``, ``map_checkpoint_arrays`` ``:60-76``, ``apply_weights``
``:79-97``, ``ModelRegistry`` ``:113-413``). Weight loads go through
:func:`~..fault.checkpoint.load_latest` (the newest checkpoint that
verifies) under :func:`~..fault.retry.call_with_retry`, and a failed load,
a chaos-injected one included (site ``"serve.registry.load"``), never
disturbs the version being served: the new :class:`~.compiled.
CompiledModel` is built and warmed (its bucket graphs captured) on a
staging copy before the version table is touched, and a hung loader is cut
by a :class:`~..fault.watchdog.Watchdog` deadline (``deadline_s``).

A version comes from ``factory=``, a zero-argument callable returning the
block, or from ``artifacts=``, the prefix of an :func:`~.compiled.
export_for_serving` bundle imported as a :class:`~..gluon.SymbolBlock`
with retry (no Python model); the checkpoint under ``ckpt_root=``, if
given, overrides its weights (``apply_weights``, or the artifact's
``set_weights``). The same architecture and bucket table make a version
swap :meth:`CompiledModel.refresh_params`: :func:`apply_weights` writes in
place through ``Parameter.set_data``, so a swap captures nothing.

With ``MXTPU_HBM_BUDGET`` set, a staged version whose measured residency
(:meth:`CompiledModel.resident_bytes`: weights plus, on the card, the
graphs' memory pool after warmup) is over budget is rejected while the
active version keeps serving: the counterpart of the JAX ladder preflight
(``:291-324``), priced from measured bytes as the decode engine prices
its pool. The ``analysis.hlo`` MX7xx passes and the telemetry events wait
for the ``telemetry``/``analysis`` port (ROADMAP queue A, item 8).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as onp
import torch

from ..base import MXNetError
from ..convert import _instance_prefix
from ..fault import checkpoint as fault_checkpoint
from ..fault import inject
from ..fault.retry import RetryPolicy, call_with_retry
from ..lockcheck import make_rlock
from ..util import hbm_budget_bytes
from .buckets import BucketTable
from .compiled import CompiledModel

__all__ = ["ModelRegistry", "ModelVersion", "map_checkpoint_arrays",
           "apply_weights"]

class ModelVersion:
    """One immutable (name, version) entry: the compiled model and its
    source (JAX counterpart: ``serve/registry.py:46``)."""

    def __init__(self, name: str, version: int, compiled: CompiledModel,
                 source: Dict[str, Any]):
        self.name = name
        self.version = version
        self.compiled = compiled
        self.source = source

    def __repr__(self):
        return f"ModelVersion({self.name!r}, v{self.version})"


def map_checkpoint_arrays(arrays: Dict[str, onp.ndarray],
                          meta: dict) -> Dict[str, onp.ndarray]:
    """Checkpoint arrays -> ``{param_name: array}``: the trainers' layout
    (``param:<i>`` arrays and ``meta["param_names"]``) or plain name-keyed
    arrays; optimizer states are dropped either way (JAX counterpart:
    ``serve/registry.py:60``)."""
    names = meta.get("param_names")
    if names:
        out = {}
        for i, name in enumerate(names):
            key = f"param:{i:04d}"
            if key in arrays:
                out[name] = arrays[key]
        if out:
            return out
    return {k: v for k, v in arrays.items()
            if not k.startswith(("opt:", "rng:"))}


def apply_weights(block, weights: Dict[str, onp.ndarray]) -> int:
    """Write ``{param_name: array}`` into ``block``'s parameters in place
    (``Parameter.set_data``: the tensors keep their storage, so a compiled
    model's graphs read the new values without a capture); returns how
    many parameters were written. A name matches a parameter's structural
    name, its full name, or its name without the model's instance prefix
    (``bertmodel0_encoder_...`` from another process or package). The
    caller decides whether 0 is an error and calls ``refresh_params()`` on
    the compiled model (JAX counterpart: ``serve/registry.py:79``)."""
    params = block._collect_params_with_prefix()
    by_name = {p.name: p for p in params.values()}
    n = len(getattr(block, "prefix", ""))
    by_suffix = {p.name[n:]: p for p in params.values()}
    try:
        strip = len(_instance_prefix(list(weights), list(by_suffix)))
    except MXNetError:
        strip = None
    applied = 0
    for wname, val in weights.items():
        p = params.get(wname) or by_name.get(wname)
        if p is None and strip is not None:
            p = by_suffix.get(wname[strip:])
        if p is not None:
            val = onp.asarray(val)
            if tuple(val.shape) != tuple(p.shape):
                raise MXNetError(
                    f"weight {wname!r} has shape {tuple(val.shape)}; the "
                    f"parameter {p.name!r} has {tuple(p.shape)}")
            p.set_data(_to_param(val, p))
            applied += 1
    return applied


def _to_param(val: onp.ndarray, p):
    """``val`` as a tensor of ``p``'s dtype on its device."""
    t = p._tensor()
    return torch.from_numpy(onp.ascontiguousarray(val)).to(
        device=t.device, dtype=t.dtype)


def _weights_from_checkpoint(root: str, policy: Optional[RetryPolicy]
                             ) -> Dict[str, onp.ndarray]:
    """The newest verified checkpoint under ``root`` as ``{param_name:
    array}``, retried under ``policy``."""
    def load():
        inject.crash("serve.registry.load")
        return fault_checkpoint.load_latest(root)

    arrays, meta, _step = call_with_retry(
        load, policy=policy, describe=f"checkpoint load from {root!r}")
    return map_checkpoint_arrays(arrays, meta)


class ModelRegistry:
    """Thread-safe, versioned model table; ``get(name)`` is the active
    (newest unless pinned) version's :class:`CompiledModel` (JAX
    counterpart: ``serve/registry.py:113``)."""

    def __init__(self, retry_policy: Optional[RetryPolicy] = None):
        self._lock = make_rlock("ModelRegistry._lock")
        self._models: Dict[str, Dict[int, ModelVersion]] = {}
        self._active: Dict[str, int] = {}
        self._policy = retry_policy

    # -- loading --------------------------------------------------------
    def load(self, name: str, *, table: BucketTable,
             input_axes: Sequence[Dict[int, str]],
             artifacts: Optional[str] = None,
             factory: Optional[Callable[[], Any]] = None,
             example_args: Optional[Sequence] = None,
             ckpt_root: Optional[str] = None,
             version: Optional[int] = None,
             input_names: Optional[Sequence[str]] = None,
             epoch: int = 0, warmup: bool = True,
             output_axes: Optional[Sequence[Dict[int, str]]] = None,
             pad_values: Any = 0, analyze: bool = True,
             deadline_s: Optional[float] = None) -> ModelVersion:
        """Build, check, warm (capture) and install one model version.
        Everything that can fail (the artifact's import, the checkpoint's
        load, each under the registry's retry policy, and the captures)
        happens on a staging copy; the table is touched only on success,
        so the active version keeps serving through a failed load (module
        docstring). ``artifacts=`` is the prefix of an exported bundle
        (``<prefix>-symbol.json``, ``<prefix>-<epoch>.params``), loaded on
        the current context. ``analyze=True`` runs the budget preflight
        (the MX7xx passes wait for the ``analysis`` port). ``deadline_s``
        bounds the staging build: a hung loader aborts with the active
        version serving, its thread left detached (a capture or a factory
        cannot be interrupted safely)."""
        if (artifacts is None) == (factory is None):
            raise MXNetError("pass exactly one of artifacts= (cold start "
                             "from an exported prefix) or factory= (live "
                             "Block constructor)")
        auto_version = version is None
        with self._lock:
            if auto_version:
                have = self._models.get(name, {})
                version = max(have) + 1 if have else 1
            elif version in self._models.get(name, {}):
                raise MXNetError(f"{name!r} v{version} is already loaded; "
                                 "unload it first or omit version=")

        def stage():
            return self._stage(
                name, version, table=table, input_axes=input_axes,
                artifacts=artifacts, factory=factory,
                example_args=example_args, ckpt_root=ckpt_root,
                input_names=input_names, epoch=epoch, warmup=warmup,
                output_axes=output_axes, pad_values=pad_values,
                analyze=analyze)

        if deadline_s is None:
            compiled, source = stage()
        else:
            compiled, source = self._stage_with_deadline(
                stage, name, version, deadline_s)

        entry = ModelVersion(name, version, compiled, source)
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version in versions:
                if not auto_version:
                    raise MXNetError(
                        f"{name!r} v{version} was loaded concurrently; "
                        "unload it first or omit version=")
                # a concurrent auto-versioned load took this slot during
                # staging: bump past it instead of overwriting
                version = max(versions) + 1
                entry.version = version
            versions[version] = entry
            pinned = self._active.get(name)
            if pinned is None or version > pinned:
                self._active[name] = version
        return entry

    def _stage(self, name: str, version: int, *, table, input_axes,
               artifacts, factory, example_args, ckpt_root, input_names,
               epoch, warmup, output_axes, pad_values, analyze):
        """The failable half of :meth:`load`: builds, checks and warms one
        :class:`CompiledModel` without touching the registry (JAX
        counterpart: ``serve/registry.py:222``)."""
        if artifacts is not None:
            from ..gluon.block import SymbolBlock
            sym_file = f"{artifacts}-symbol.json"
            params_file = f"{artifacts}-{epoch:04d}.params"
            block = call_with_retry(
                lambda: SymbolBlock.imports(
                    sym_file, list(input_names or ["data"]), params_file),
                policy=self._policy,
                describe=f"artifact import from {artifacts!r}")
            if ckpt_root is not None:
                weights = _weights_from_checkpoint(ckpt_root, self._policy)
                applied = block.set_weights(weights, allow_missing=True,
                                            ignore_extra=True)
                if not applied:
                    # every name fell through the mapping: the version
                    # would serve the artifact's weights while claiming
                    # the checkpoint's
                    raise MXNetError(
                        f"checkpoint under {ckpt_root!r} matched 0 of the "
                        f"artifact's parameters (checkpoint names: "
                        f"{sorted(weights)[:4]}...; artifact names: "
                        f"{sorted(block._arch.get('param_order', []))[:4]}"
                        "...) — was it written by a trainer over a "
                        "different model or name scope?")
            source: Dict[str, Any] = {"artifacts": artifacts,
                                      "ckpt_root": ckpt_root}
        else:
            block = factory()
            if ckpt_root is not None:
                weights = _weights_from_checkpoint(ckpt_root, self._policy)
                if not apply_weights(block, weights):
                    raise MXNetError(
                        f"checkpoint under {ckpt_root!r} matched 0 of the "
                        f"factory model's parameters (checkpoint names: "
                        f"{sorted(weights)[:4]}...) — name-scope mismatch?")
            source = {"factory": getattr(factory, "__name__", "factory"),
                      "ckpt_root": ckpt_root}
        compiled = CompiledModel(block, table, input_axes,
                                 example_args=example_args,
                                 output_axes=output_axes,
                                 pad_values=pad_values)
        if warmup:
            compiled.warmup()
        budget = hbm_budget_bytes() if analyze else 0
        if budget:
            resident = compiled.resident_bytes()
            source["resident_bytes"] = resident
            if resident > budget:
                raise MXNetError(
                    f"{name!r} v{version} holds {resident / 2**20:.1f} MiB "
                    f"resident (weights and bucket graphs), over the "
                    f"{budget / 2**20:.1f} MiB MXTPU_HBM_BUDGET — load "
                    "rejected at staging (the active version keeps "
                    "serving); trim the bucket table or raise the budget")
        return compiled, source

    @staticmethod
    def _stage_with_deadline(stage: Callable, name: str, version: int,
                             deadline_s: float):
        """Run ``stage`` on a named daemon thread under a watchdog
        deadline; a stuck loader aborts the load and leaves the registry,
        and so the active version, untouched (JAX counterpart:
        ``serve/registry.py:330``)."""
        from ..fault.watchdog import Watchdog
        box: Dict[str, Any] = {}

        def run():
            try:
                box["result"] = stage()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["exc"] = e

        t = threading.Thread(target=run,
                             name=f"mx-serve-stage-{name}-v{version}",
                             daemon=True)
        wd = Watchdog(deadline=deadline_s)
        with wd.watch(step=version):
            t.start()
            t.join(deadline_s)
        if t.is_alive():
            raise MXNetError(
                f"staged load of {name!r} v{version} exceeded its "
                f"{deadline_s:.1f}s deadline; the active version keeps "
                f"serving (stuck loader thread {t.name!r} left detached; "
                "if it is stuck inside a capture, it holds the card's "
                "capture stream and every later capture raises after "
                "waiting ops.cuda.graphs.CAPTURE_WAIT_S)")
        if "exc" in box:
            raise box["exc"]
        return box["result"]

    # -- lookup ---------------------------------------------------------
    def get(self, name: str, version: Optional[int] = None) -> CompiledModel:
        return self.get_version(name, version).compiled

    def get_version(self, name: str,
                    version: Optional[int] = None) -> ModelVersion:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise MXNetError(f"no model {name!r} in the registry "
                                 f"(loaded: {sorted(self._models)})")
            v = self._active[name] if version is None else version
            if v not in versions:
                raise MXNetError(f"{name!r} has no version {v} "
                                 f"(loaded: {sorted(versions)})")
            return versions[v]

    def models(self) -> Dict[str, List[int]]:
        with self._lock:
            return {n: sorted(vs) for n, vs in self._models.items()}

    def active_version(self, name: str) -> int:
        with self._lock:
            if name not in self._active:
                raise MXNetError(f"no model {name!r} in the registry")
            return self._active[name]

    # -- unloading ------------------------------------------------------
    def unload(self, name: str, version: Optional[int] = None) -> None:
        """Drop one version (or the whole model); unloading the active
        version activates the newest one left."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise MXNetError(f"no model {name!r} in the registry")
            if version is None:
                del self._models[name]
                self._active.pop(name, None)
                return
            if version not in versions:
                raise MXNetError(f"{name!r} has no version {version}")
            del versions[version]
            if not versions:
                del self._models[name]
                self._active.pop(name, None)
            elif self._active.get(name) == version:
                self._active[name] = max(versions)
