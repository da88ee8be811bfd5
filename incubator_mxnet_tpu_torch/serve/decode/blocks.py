"""Paged KV-cache block pool: fixed-size cache pages per engine.

Counterpart: the JAX package's ``serve/decode/blocks.py``, whole but for
its telemetry gauges and its ``fault.inject`` hook (both wait for those
subsystems). The decode step's self-attention cache is one preallocated
pool of pages (``(num_blocks, layers, block_size, units)`` K and V
tensors owned by :class:`~.engine.DecodeEngine`); this module is the
allocator over it. A sequence owns a block table (a row of page ids), so
a request joins the running batch whenever free pages exist anywhere in
the pool: uniform pages cannot fragment.

A sequence takes its first page at admission and one more each time it
crosses a ``block_size`` boundary; retiring it returns every page.
Admission is seat-based: :meth:`BlockPool.admission_limit` is the number
:func:`price_capacity` priced, so an admitted sequence never runs out of
pages mid-generation and :class:`CacheExhausted` is loud by construction.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

from ...base import MXNetError

__all__ = ["BlockPool", "CacheExhausted", "blocks_per_sequence",
           "block_bytes", "price_capacity"]


class CacheExhausted(MXNetError):
    """The block pool cannot satisfy an allocation: the request must be
    shed or requeued, never silently truncated."""


def blocks_per_sequence(max_target_len: int, block_size: int) -> int:
    """Pages a worst-case (``max_target_len``) sequence needs."""
    return max(1, math.ceil(int(max_target_len) / int(block_size)))


def block_bytes(num_layers: int, units: int, block_size: int,
                dtype_bytes: int = 4) -> int:
    """Device bytes of ONE cache page across all layers, K and V."""
    return 2 * int(num_layers) * int(block_size) * int(units) * dtype_bytes


def price_capacity(*, hbm_budget: Optional[int], fixed_bytes: int,
                   per_block_bytes: int, max_target_len: int,
                   block_size: int, max_batch: int) -> Dict[str, int]:
    """How many concurrent sequences fit (JAX counterpart:
    ``blocks.py:54-79``): ``(hbm_budget - fixed_bytes) // (per_block_bytes
    * blocks_per_seq)``, at most ``max_batch``; no budget prices no
    constraint (``max_batch``). Returns ``{"max_sequences", "num_blocks",
    "blocks_per_seq"}``; ``num_blocks`` counts the scratch page 0.
    Deterministic: the same inputs give the same numbers."""
    bps = blocks_per_sequence(max_target_len, block_size)
    if hbm_budget is None:
        seqs = int(max_batch)
    else:
        free = int(hbm_budget) - int(fixed_bytes)
        seqs = max(0, free // max(1, int(per_block_bytes) * bps))
        seqs = min(seqs, int(max_batch))
    # +1: page id 0 is the engine's scratch page (inactive batch rows
    # park their writes there)
    return {"max_sequences": seqs, "num_blocks": seqs * bps + 1,
            "blocks_per_seq": bps}


class BlockPool:
    """Allocator over ``num_blocks`` uniform cache pages (JAX counterpart:
    ``blocks.py:82``).

    Page 0 is the scratch page and never handed out. ``alloc_sequence``
    admits a sequence (seat + first page), ``append_token`` advances it one
    token (a page at each ``block_size`` boundary) and returns the
    ``(page, slot)`` write coordinates, ``free_sequence`` returns
    everything. Thread-safe; O(1) per token.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 blocks_per_seq: int, max_sequences: Optional[int] = None):
        if num_blocks < 2:
            raise MXNetError(f"BlockPool needs >= 2 blocks (one is the "
                             f"scratch page), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.blocks_per_seq = int(blocks_per_seq)
        self._max_seqs = ((self.num_blocks - 1) // self.blocks_per_seq
                          if max_sequences is None else int(max_sequences))
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._tables: Dict[str, List[int]] = {}
        self._lengths: Dict[str, int] = {}
        self.peak_in_use = 0

    # -- admission -------------------------------------------------------
    def admission_limit(self) -> int:
        """The concurrent-sequence limit: the ``price_capacity`` number the
        pool was sized from."""
        return self._max_seqs

    def can_admit(self) -> bool:
        with self._lock:
            return len(self._tables) < self._max_seqs and bool(self._free)

    def alloc_sequence(self, seq_id: str) -> List[int]:
        """Admit ``seq_id``: its seat and first page; returns its (one-page)
        block table."""
        with self._lock:
            if seq_id in self._tables:
                raise MXNetError(f"sequence {seq_id!r} already admitted")
            if len(self._tables) >= self._max_seqs or not self._free:
                raise CacheExhausted(
                    f"block pool full: {len(self._tables)}/{self._max_seqs} "
                    f"sequences, {len(self._free)} free pages — shed or "
                    "requeue the request")
            table = [self._free.pop()]
            self._tables[seq_id] = table
            self._lengths[seq_id] = 0
            self._note_locked()
            return list(table)

    def append_token(self, seq_id: str):
        """Advance ``seq_id`` one token, taking a fresh page at a block
        boundary; returns ``(page_id, slot, table)``."""
        with self._lock:
            if seq_id not in self._tables:
                raise MXNetError(f"sequence {seq_id!r} not admitted")
            pos = self._lengths[seq_id]
            table = self._tables[seq_id]
            need = pos // self.block_size
            if need >= len(table):
                if need >= self.blocks_per_seq:
                    raise CacheExhausted(
                        f"sequence {seq_id!r} exceeded its reserved "
                        f"{self.blocks_per_seq} pages (pos {pos})")
                if not self._free:
                    # unreachable for seat-admitted sequences; loud anyway
                    raise CacheExhausted(
                        f"no free page for {seq_id!r} at pos {pos} — "
                        "admission accounting violated")
                table.append(self._free.pop())
            self._lengths[seq_id] = pos + 1
            self._note_locked()
            return table[need], pos % self.block_size, list(table)

    def free_sequence(self, seq_id: str) -> None:
        """Retire ``seq_id``: every page back to the free list."""
        with self._lock:
            table = self._tables.pop(seq_id, None)
            self._lengths.pop(seq_id, None)
            if table:
                self._free.extend(table)

    # -- introspection ---------------------------------------------------
    def sequence_table(self, seq_id: str) -> List[int]:
        with self._lock:
            return list(self._tables[seq_id])

    def sequence_length(self, seq_id: str) -> int:
        with self._lock:
            return self._lengths[seq_id]

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def active_sequences(self) -> int:
        with self._lock:
            return len(self._tables)

    def snapshot(self) -> dict:
        with self._lock:
            in_use = (self.num_blocks - 1) - len(self._free)
            return {"num_blocks": self.num_blocks,
                    "block_size": self.block_size,
                    "blocks_per_seq": self.blocks_per_seq,
                    "admission_limit": self._max_seqs,
                    "active_sequences": len(self._tables),
                    "blocks_in_use": in_use,
                    "blocks_free": len(self._free),
                    "peak_blocks_in_use": self.peak_in_use}

    def _note_locked(self) -> None:
        in_use = (self.num_blocks - 1) - len(self._free)
        if in_use > self.peak_in_use:
            self.peak_in_use = in_use
