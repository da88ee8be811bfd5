"""DecodeEngine: the prefill/decode split over a paged KV cache.

Counterpart: the JAX package's ``serve/decode/engine.py`` (``PrefillEntry``
and ``DecodeEngine``, ``:50-392``). Generation has two kinds of work:

- **prefill**: encode the prompt and compute every decoder layer's
  cross-attention K/V. Prompt lengths are ragged, so this is a
  :class:`~..compiled.CompiledModel` bucketed over ``(batch, src)``; the
  encoder runs on the flash-attention forward kernel.
- **decode**: one fixed-shape single-token step
  (:func:`~...models.nmt.nmt_paged_step`) over preallocated pages, cache
  written in place. On the card :meth:`DecodeEngine.warmup` runs it once on
  the capture stream and captures it as ONE CUDA graph
  (:mod:`...ops.cuda.graphs`), the counterpart of the JAX engine's AOT
  executable (``:282-309``); :meth:`DecodeEngine.run_step` copies the
  batch's tables, positions and tokens into the graph's buffers and
  replays it. Generation length appears in no shape, so after ``warmup()``
  no capture and no first run of a prefill bucket happens, whatever the
  prompt and generation lengths; ``stats()`` counts both under the JAX
  keys (``compiles``, ``warmup_compiles``, ``post_warmup_compiles``). On
  the CPU the step runs eagerly: the same function.

Capacity is priced, not tuned (:func:`~.blocks.price_capacity`). With no
``MXTPU_HBM_BUDGET`` it equals the reference's exactly: ``max_sequences =
max_batch``, ``num_blocks = max_sequences * blocks_per_seq + 1``. With a
budget the JAX engine reads fixed and per-page bytes off its HLO liveness
model; the port has none, so the per-page cost is the analytic
:func:`~.blocks.block_bytes` (the floor the JAX code also applies) and the
fixed cost is measured: on the card, ``torch.cuda`` peak allocated bytes of
the step at pool sizes 2 and 3 plus the parameters it reads; on the CPU an
analytic count of those parameters, the cross-K/V, the inputs and one
layer's activations. The pool is sized from the same report, so
``capacity["max_sequences"] == pool.admission_limit()``.

``trace()``/``check_budget()`` (the ``analysis.hlo`` gates) come with the
``analysis/`` port.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as onp
import torch

from ...base import MXNetError
from ...gluon.block import HybridBlock
from ...models.nmt import (incremental_decode_params, nmt_paged_step,
                           source_mask)
from ...ops.cuda import graphs
from ...util import getenv, hbm_budget_bytes
from ..buckets import BucketTable
from ..compiled import CompiledModel
from .blocks import (BlockPool, block_bytes, blocks_per_sequence,
                     price_capacity)

__all__ = ["DecodeEngine", "PrefillEntry"]


class PrefillEntry(HybridBlock):
    """The block the prefill ``CompiledModel`` wraps (JAX counterpart:
    ``engine.py:50``): encoder forward plus every decoder layer's
    cross-attention K/V projection, packed into one ``(B, Ls, num_layers *
    2 * units)`` tensor, so the bucket padding slices off one output."""

    def __init__(self, model, prefix="prefill_", **kw):
        super().__init__(prefix=prefix, **kw)
        self._m = model

    def hybrid_forward(self, F, src, src_valid_length):
        m = self._m
        B, L = src.shape[0], src.shape[1]
        mem = m.encoder(m.src_embed(src), source_mask(src_valid_length, B, L))
        kvs = [layer.cross_attn.kv_proj(mem) for layer in m.decoder.layers]
        return torch.cat(kvs, dim=2) if len(kvs) > 1 else kvs[0]


def _tensors(params: dict):
    """The distinct tensors of an incremental-decode parameter dict."""
    seen = {}
    for v in list(params.values()) + [t for layer in params["layers"]
                                      for t in layer.values()]:
        if isinstance(v, torch.Tensor):
            seen[v.data_ptr()] = v
    return list(seen.values())


class DecodeEngine:
    """Paged-KV-cache generation engine for one :class:`~...models.nmt.
    NMTModel` (JAX counterpart: ``engine.py:76``).

    ``prompt_table`` declares ``batch`` and ``src`` axes; the decode shapes
    are fixed by ``max_batch`` (concurrent rows), ``block_size`` (tokens
    per cache page) and ``max_target_len`` (the generation cap = pages per
    sequence x block size). The engine runs where the model's parameters
    are. ``warmup()`` runs every prefill bucket and builds the decode step
    (module docstring).
    """

    def __init__(self, model, prompt_table: BucketTable, *,
                 max_batch: Optional[int] = None,
                 block_size: Optional[int] = None,
                 max_target_len: Optional[int] = None,
                 hbm_budget: Optional[int] = None,
                 bos_id: int = 1, eos_id: int = 2):
        if not {"batch", "src"} <= set(prompt_table.axes):
            raise MXNetError("DecodeEngine prompt_table needs 'batch' and "
                             f"'src' axes, got {sorted(prompt_table.axes)}")
        self._model = model
        self._table = prompt_table
        self.max_batch = int(max_batch or getenv("MXTPU_DECODE_MAX_BATCH"))
        self.block_size = int(block_size
                              or getenv("MXTPU_DECODE_BLOCK_SIZE"))
        self.max_target_len = int(max_target_len
                                  or getenv("MXTPU_DECODE_MAX_TOKENS"))
        self.bos_id, self.eos_id = int(bos_id), int(eos_id)
        if self.max_target_len > model.decoder._max_length:
            raise MXNetError(
                f"max_target_len {self.max_target_len} exceeds the "
                f"model's position table ({model.decoder._max_length})")
        self._budget = hbm_budget if hbm_budget is not None \
            else hbm_budget_bytes()
        self._lock = threading.RLock()

        self._params = incremental_decode_params(model)
        self.num_layers = len(self._params["layers"])
        self.units = int(self._params["embed"].shape[1])
        self.vocab = int(self._params["proj_w"].shape[0])
        self.num_heads = int(self._params["num_heads"])
        self.max_src = int(prompt_table.axes["src"][1])
        self._dtype = self._params["embed"].dtype
        self.device = self._params["embed"].device

        # -- prefill: bucketed CompiledModel over (batch, src) -------------
        lo_b = prompt_table.axes["batch"][0]
        lo_s = prompt_table.axes["src"][0]
        self.prefill = CompiledModel(
            PrefillEntry(model), prompt_table,
            input_axes=[{0: "batch", 1: "src"}, {0: "batch"}],
            example_args=(onp.zeros((lo_b, lo_s), "int32"),
                          onp.full((lo_b,), float(lo_s), "float32")))

        # -- capacity, and the pool sized from it --------------------------
        self.capacity = self.capacity_report()
        nb = self.capacity["num_blocks"]
        bps = self.capacity["blocks_per_seq"]
        self.pool = BlockPool(nb, self.block_size, bps,
                              max_sequences=self.capacity["max_sequences"])

        # -- the decode step's static buffers -------------------------------
        self._bufs = self._step_buffers(nb)
        self._host_tables = onp.zeros((self.max_batch, bps), "int32")
        self._host_valid = onp.zeros((self.max_batch,), "float32")
        self._graph: Optional[graphs.Graph] = None
        self._logits: Optional[torch.Tensor] = None
        self._param_ptrs: tuple = ()
        self._built = False
        self._warmed = False
        self.steps = 0
        #: the decode step's "compiles" (its capture on the card, its first
        #: run on the CPU) under the JAX compile-log keys
        self.decode_stats: Dict[str, int] = {
            "compiles": 0, "warmup_compiles": 0, "post_warmup_compiles": 0}

    # -- the step -----------------------------------------------------------
    def _step_buffers(self, num_blocks: int) -> Dict[str, torch.Tensor]:
        B, NL, U = self.max_batch, self.num_layers, self.units
        bps = blocks_per_sequence(self.max_target_len, self.block_size)
        dev, dt = self.device, self._dtype
        pool = (num_blocks, NL, self.block_size, U)
        return {
            "pool_k": torch.zeros(pool, dtype=dt, device=dev),
            "pool_v": torch.zeros(pool, dtype=dt, device=dev),
            "cross": torch.zeros((NL, B, self.max_src, 2 * U), dtype=dt,
                                 device=dev),
            "tables": torch.zeros((B, bps), dtype=torch.int32, device=dev),
            "positions": torch.zeros((B,), dtype=torch.int32, device=dev),
            "tokens": torch.zeros((B,), dtype=torch.int32, device=dev),
            "valid": torch.zeros((B,), dtype=torch.float32, device=dev),
            "src_steps": torch.arange(self.max_src, dtype=torch.float32,
                                      device=dev),
        }

    def _step(self, bufs: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
        """The decode step over ``bufs`` (default: the engine's): logits
        ``(max_batch, vocab)``, pages written in place."""
        b = self._bufs if bufs is None else bufs
        with torch.no_grad():
            mem_mask = b["src_steps"][None, :] < b["valid"][:, None]
            logits, _, _ = nmt_paged_step(
                self._params, self.block_size, b["pool_k"], b["pool_v"],
                b["tables"], b["positions"], b["tokens"], b["cross"],
                mem_mask)
        return logits

    def _build_step(self) -> None:
        """The step's "compile": on the card one run on the capture stream
        and one capture; on the CPU one eager run. Counted in
        :attr:`decode_stats`."""
        if self.device.type == "cuda":
            self._graph = graphs.Graph(self.device)
            self._logits = self._graph.capture(
                self._step, warm=self._step, what="the decode step's capture")
        else:
            self._step()
        self._param_ptrs = tuple(t.data_ptr()
                                 for t in _tensors(self._params))
        self._built = True
        self.decode_stats["compiles"] += 1
        key = "post_warmup_compiles" if self._warmed else "warmup_compiles"
        self.decode_stats[key] += 1

    # -- capacity ------------------------------------------------------------
    def _param_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in _tensors(self._params))

    def _fixed_bytes(self) -> int:
        """The step's pool-independent bytes (module docstring)."""
        B, NL, U = self.max_batch, self.num_layers, self.units
        e = torch.empty((), dtype=self._dtype).element_size()
        if self.device.type == "cuda":
            p2, p3 = (self._measured_peak(n) for n in (2, 3))
            per_block = max(p3 - p2, block_bytes(NL, U, self.block_size, e))
            return max(0, p2 - 2 * per_block)
        bps = blocks_per_sequence(self.max_target_len, self.block_size)
        T = bps * self.block_size
        hidden = int(self._params["layers"][0]["ffn1_w"].shape[0]) \
            if self._params["layers"] else 0
        cross = NL * B * self.max_src * 2 * U * e
        inputs = B * bps * 4 + 3 * B * 4 + self.max_src * 4
        acts = 4 * (2 * B * T * U + B * self.num_heads * max(T, self.max_src)
                    + B * (4 * U + hidden) + B * self.vocab)
        return self._param_bytes() + cross + inputs + acts

    def _measured_peak(self, num_blocks: int) -> int:
        """Peak device bytes of one eager step over a pool of
        ``num_blocks`` pages (its buffers and activations, from
        ``torch.cuda`` memory statistics) plus the parameters it reads."""
        dev = self.device
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        bufs = self._step_buffers(num_blocks)
        self._step(bufs)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del bufs
        return peak + self._param_bytes()

    def capacity_report(self) -> Dict[str, int]:
        """Price the static capacity (module docstring); deterministic. A
        budget too small for one sequence raises (JAX counterpart:
        ``engine.py:228``)."""
        kw = dict(max_target_len=self.max_target_len,
                  block_size=self.block_size, max_batch=self.max_batch)
        if self._budget is None:
            rep = price_capacity(hbm_budget=None, fixed_bytes=0,
                                 per_block_bytes=1, **kw)
        else:
            e = torch.empty((), dtype=self._dtype).element_size()
            per_block = block_bytes(self.num_layers, self.units,
                                    self.block_size, e)
            fixed = self._fixed_bytes()
            rep = price_capacity(hbm_budget=self._budget, fixed_bytes=fixed,
                                 per_block_bytes=per_block, **kw)
            rep["fixed_bytes"] = fixed
            rep["per_block_bytes"] = per_block
            rep["hbm_budget"] = int(self._budget)
        if rep["max_sequences"] < 1:
            raise MXNetError(
                "MXTPU_HBM_BUDGET too small for even one decode sequence: "
                f"{rep} — shrink the model, block_size, or max_target_len")
        return rep

    # -- lifecycle -------------------------------------------------------------
    def warmup(self) -> dict:
        """Run every prefill bucket and build the decode step; afterwards
        neither happens again (JAX counterpart: ``engine.py:282``)."""
        t0 = time.monotonic()
        pre = self.prefill.warmup()
        # holding the lock across the build is the contract: run_step
        # callers wait until the step exists instead of racing it
        with self._lock:
            if not self._built:
                self._build_step()
            self._warmed = True
        return {"prefill": pre, "decode_compiled": 1,
                "capacity": dict(self.capacity),
                "seconds": time.monotonic() - t0}

    def refresh_params(self) -> None:
        """Re-read the decoder's parameters after a weight sync. Weights
        updated in place (an optimizer step, ``load_parameters``) need
        nothing: the step reads the parameters' own tensors. A parameter
        given new storage (``cast``, a re-initialisation) makes the card's
        graph capture again, counted as a compile."""
        with self._lock:
            self._params = incremental_decode_params(self._model)
            ptrs = tuple(t.data_ptr() for t in _tensors(self._params))
            if self._graph is not None and ptrs != self._param_ptrs:
                self._graph = None
                self._build_step()

    # -- serving operations (DecodeBatcher, at token boundaries) -------------
    def prefill_request(self, src_tokens, valid_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, int]:
        """The bucketed prefill of ONE prompt: its cross-K/V row ``(NL,
        max_src, 2U)`` on the engine's device (zero past the bucket) and
        the prompt's valid length (JAX counterpart: ``engine.py:322``)."""
        src = onp.asarray(src_tokens, "int32").reshape(1, -1)
        lp = int(valid_len if valid_len is not None else src.shape[1])
        packed = self.prefill.predict(src, onp.asarray([float(lp)],
                                                       "float32"))._data[0]
        NL, U = self.num_layers, self.units
        ls = min(packed.shape[0], self.max_src)
        row = torch.zeros((NL, self.max_src, 2 * U), dtype=packed.dtype,
                          device=packed.device)
        row[:, :ls] = packed[:ls].reshape(ls, NL, 2 * U).transpose(0, 1)
        return row, lp

    def bind_row(self, row: int, cross_row, valid_len: int) -> None:
        """Install an admitted sequence's cross-K/V into batch row ``row``,
        in place."""
        with self._lock:
            src = cross_row if isinstance(cross_row, torch.Tensor) \
                else torch.from_numpy(onp.asarray(cross_row))
            self._bufs["cross"][:, row].copy_(src)
            self._host_valid[row] = float(valid_len)

    def clear_row(self, row: int) -> None:
        with self._lock:
            self._host_tables[row] = 0
            self._host_valid[row] = 0.0

    def set_row_table(self, row: int, table: Sequence[int]) -> None:
        with self._lock:
            self._host_tables[row] = 0
            self._host_tables[row, :len(table)] = onp.asarray(table, "int32")

    def run_step(self, positions: onp.ndarray, tokens: onp.ndarray
                 ) -> onp.ndarray:
        """One fixed-shape decode step over the whole batch; returns the
        logits ``(max_batch, vocab)`` as float32 on the host. Rows bound to
        no sequence point at the scratch page (table row 0); their logits
        are garbage and ignored (JAX counterpart: ``engine.py:357``)."""
        b = self._bufs
        with self._lock:
            if not self._built:
                self.warmup()
            b["tables"].copy_(torch.from_numpy(self._host_tables))
            b["valid"].copy_(torch.from_numpy(self._host_valid))
            b["positions"].copy_(torch.from_numpy(
                onp.asarray(positions, "int32")))
            b["tokens"].copy_(torch.from_numpy(onp.asarray(tokens, "int32")))
            if self._graph is not None:
                self._graph.replay()
                logits = self._logits
            else:
                logits = self._step()
            out = logits.float().cpu().numpy()
            self.steps += 1
        return out

    def reset_cache(self) -> None:
        """Drop every page's contents and every row's binding (JAX
        counterpart: ``engine.py:377``); nothing is captured again."""
        with self._lock:
            self._bufs["pool_k"].zero_()
            self._bufs["pool_v"].zero_()
            self._host_tables[:] = 0
            self._host_valid[:] = 0.0

    def stats(self) -> dict:
        return {"prefill": dict(self.prefill.stats),
                "decode": dict(self.decode_stats),
                "decode_steps": self.steps,
                "capacity": dict(self.capacity),
                "pool": self.pool.snapshot(),
                "warmed": self._warmed}
