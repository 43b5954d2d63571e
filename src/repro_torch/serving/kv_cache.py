"""Paged KV cache: free-list block allocator, per-slot block tables, and
the prefill import (port of ``repro/serving/kv_cache.py``).

Every attention layer's K/V lives in one pool of ``num_blocks`` blocks of
``block_size`` tokens.  A sequence owns an ordered list of blocks; logical
position ``p`` maps to flat physical row ``table[p // block_size] *
block_size + p % block_size``.  Growing a sequence is a host-side table
edit, never a reallocation.  **Block 0 is the null block**: free slots'
tables point at it, so their ignored decode writes land somewhere harmless,
and the allocator hands out blocks ``1..num_blocks-1``.

Storage is the compute dtype (bf16 or f32).  The int8 pools and the
capacity helpers come with quantization (ROADMAP.md Queue 1 "Quantization");
the allocator's fault-injection points come with the reliability layer
(Queue 1 "Reliability").
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import attention
from repro_torch.models import transformer as tf_model

__all__ = ["BlockAllocator", "PagedKVCache", "make_import_fn"]


class BlockAllocator:
    """Free-list allocator over blocks ``1..num_blocks-1`` (0 = null block).

    ``alloc`` is all-or-nothing; double-free and foreign-free raise."""

    NULL_BLOCK = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._allocated: set = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        got = self._free[-n:][::-1] if n else []
        del self._free[len(self._free) - n:]
        self._allocated.update(got)
        return got

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"freeing block {b} not currently allocated")
        for b in blocks:
            self._allocated.discard(b)
            self._free.append(b)


class PagedKVCache:
    """Device pools + host-side block tables for a fixed slot pool.

    ``block_tables`` is host numpy (slots, blocks_per_seq) int32 — rows of
    free slots are all null-block.  ``ensure(slot, length)`` grows a slot's
    table to cover ``length`` tokens (False if the allocator is exhausted —
    the engine's preemption trigger); ``release(slot)`` returns everything.
    """

    def __init__(self, cfg, *, num_blocks: int, block_size: int, slots: int, max_seq: int,
                 kv_quant: str = "none", device):
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.kv_quant = kv_quant
        self.blocks_per_seq = -(-max_seq // block_size)
        self.pools = tf_model.init_paged_cache(cfg, num_blocks, block_size, kv_quant=kv_quant,
                                               device=device)
        self.allocator = BlockAllocator(num_blocks)
        self.block_tables = np.zeros((slots, self.blocks_per_seq), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(slots)]

    def blocks_needed(self, length: int) -> int:
        return -(-length // self.block_size)

    def can_allocate(self, length: int) -> bool:
        return self.blocks_needed(length) <= self.allocator.num_free

    def ensure(self, slot: int, length: int) -> bool:
        """Grow ``slot``'s table to cover ``length`` tokens; all-or-nothing."""
        need = self.blocks_needed(length)
        if need > self.blocks_per_seq:
            raise ValueError(
                f"sequence of {length} tokens needs {need} blocks > "
                f"blocks_per_seq={self.blocks_per_seq} (raise max_seq)"
            )
        have = len(self.owned[slot])
        if need <= have:
            return True
        got = self.allocator.alloc(need - have)
        if got is None:
            return False
        for b in got:
            self.block_tables[slot, len(self.owned[slot])] = b
            self.owned[slot].append(b)
        return True

    def release(self, slot: int) -> None:
        if self.owned[slot]:
            self.allocator.free(self.owned[slot])
        self.owned[slot] = []
        self.block_tables[slot] = BlockAllocator.NULL_BLOCK

    def table_row(self, slot: int) -> np.ndarray:
        return self.block_tables[slot]


def make_import_fn(block_size: int, kv_quant: str = "none"):
    """The scatter of a finished contiguous B=1 prefill cache into a slot's
    pool blocks: positions ``0..plen-1`` go to ``block_row[p // bs] * bs +
    p % bs``; the prompt padding past ``plen`` is dropped.  The physical rows
    are computed on the host from the host block table, and the pools are
    written in place."""
    if kv_quant != "none":
        raise NotImplementedError('int8 KV pools come with quantization (ROADMAP.md Queue 1 "Quantization")')
    bs = block_size

    def imp(pool_layers: Dict[str, torch.Tensor], prefill_layers: Dict[str, torch.Tensor],
            plen: int, block_row: np.ndarray) -> Dict[str, torch.Tensor]:
        pos = np.arange(plen)
        phys = block_row[pos // bs].astype(np.int64) * bs + pos % bs
        phys_t = torch.as_tensor(phys, device=pool_layers["k"].device)
        for nm in ("k", "v"):
            pool = pool_layers[nm]
            for i in range(pool.shape[0]):
                attention.paged_write(pool[i], phys_t, prefill_layers[nm][i, 0, :plen])
        return pool_layers

    return imp
