"""Paged KV cache: free-list block allocator, per-slot block tables, and
the prefill import (port of ``repro/serving/kv_cache.py``).

Every attention layer's K/V lives in one pool of ``num_blocks`` blocks of
``block_size`` tokens.  A sequence owns an ordered list of blocks; logical
position ``p`` maps to flat physical row ``table[p // block_size] *
block_size + p % block_size``.  Growing a sequence is a host-side table
edit, never a reallocation.  **Block 0 is the null block**: free slots'
tables point at it, so their ignored decode writes land somewhere harmless,
and the allocator hands out blocks ``1..num_blocks-1``.

Storage is the compute dtype (bf16 or f32), or int8 codes plus one f32
scale per (token, head) row under ``kv_quant="int8"`` (quantized on write,
prefill import included).  An MLA model pages its latent ``c_kv`` and
shared ``k_rope`` rows the same way, int8 with one f32 scale per token
(no head axis).  The SSM families' conv
history and state are O(1) per sequence and live in per-slot pools beside
the pages: a pure SSM model pages nothing, a hybrid one only its shared
attention block's K/V.  ``bytes_per_block`` / ``blocks_for_budget`` /
``max_concurrent`` are the capacity arithmetic.  The allocator carries the
fail-points ``kv.alloc`` and ``kv.free`` (``reliability.inject``), each
before any mutation, so a raise leaves the free/allocated partition whole.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import dtype_of
from repro_torch.models import attention
from repro_torch.models import transformer as tf_model
from repro_torch.reliability.inject import maybe_fail

__all__ = ["BlockAllocator", "PagedKVCache", "make_import_fn", "bytes_per_block", "blocks_for_budget",
           "max_concurrent"]


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
        maybe_fail("kv.alloc")
        # slice-atomically: a raise between pops would leak the popped prefix
        got = self._free[-n:][::-1] if n else []
        del self._free[len(self._free) - n:]
        self._allocated.update(got)
        return got

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"freeing block {b} not currently allocated")
        maybe_fail("kv.free")
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
                 kv_quant: str = "none", device, plan=None):
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.kv_quant = kv_quant
        self.blocks_per_seq = -(-max_seq // block_size)
        # under a plan the pools hold this rank's KV heads; the tables stay here
        self.pools = tf_model.init_paged_cache(cfg, num_blocks, block_size, kv_quant=kv_quant, slots=slots,
                                               device=device, plan=plan)
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


def bytes_per_block(cfg, block_size: Optional[int] = None, kv_quant: Optional[str] = None, plan=None) -> int:
    """Device bytes one KV block costs across all layers: GQA L * bs * (2 *
    KV * hd elements, plus one f32 scale per (token, head) row for k and v
    when quantized); MLA L * bs * (kv_lora_rank + rope elements, plus one
    f32 scale per token for c_kv and for k_rope when quantized); the
    hybrid pages only its ``n_layers // attn_every`` shared-attention
    instances, and a pure SSM model pages nothing (0).  Under a ``plan``
    the bytes one rank's pools cost: its KV heads, or the whole MLA
    latent."""
    bs = block_size if block_size is not None else cfg.kv_block_size
    kvq = kv_quant if kv_quant is not None else cfg.kv_quant
    item = 1 if kvq != "none" else torch.finfo(dtype_of(cfg.compute_dtype)).bits // 8
    if cfg.is_ssm:
        return 0
    if cfg.use_mla:
        scale = 2 * 4 if kvq != "none" else 0
        return cfg.n_layers * bs * ((cfg.kv_lora_rank + cfg.qk_rope_head_dim) * item + scale)
    n_inst = cfg.n_layers // cfg.attn_every if cfg.is_hybrid else cfg.n_layers
    kv, hd = tf_model._kv_heads(cfg, plan), cfg.resolved_head_dim
    scale = 2 * kv * 4 if kvq != "none" else 0
    return n_inst * bs * (2 * kv * hd * item + scale)


def blocks_for_budget(cfg, budget_bytes: int, block_size: Optional[int] = None,
                      kv_quant: Optional[str] = None) -> int:
    """Usable blocks (null block excluded) a byte budget buys; a pure SSM
    model has no paged bytes and raises."""
    per = bytes_per_block(cfg, block_size, kv_quant)
    if per == 0:
        raise ValueError(f"{cfg.name}: pure-SSM config has no paged KV bytes")
    return max(0, budget_bytes // per - 1)


def max_concurrent(cfg, num_usable_blocks: int, seq_len: int, block_size: Optional[int] = None) -> int:
    """Sequences of ``seq_len`` tokens that fit in ``num_usable_blocks``."""
    bs = block_size if block_size is not None else cfg.kv_block_size
    return num_usable_blocks // -(-seq_len // bs)


def make_import_fn(cfg, block_size: int, kv_quant: str = "none"):
    """The scatter of a finished contiguous B=1 prefill cache into a slot's
    pool blocks: positions ``0..plen-1`` go to ``block_row[p // bs] * bs +
    p % bs``; the prompt padding past ``plen`` is dropped.  A quantized pool
    quantizes each row on import into the codes and its ``{name}_scale``
    pool (per (token, head) for k and v, per token for MLA's latent rows).
    Every pool of the prefill cache is imported: k and v, or MLA's c_kv and
    k_rope; for the SSM families the
    conv history and state go to the slot's row of the per-slot pools, and
    the hybrid's shared-block k and v are scattered as above.  The physical
    rows are computed on the host from the host block table, and the pools
    are written in place."""
    bs = block_size

    def scatter(pool_layers, prefill_layers, plen, block_row):
        pos = np.arange(plen)
        phys = block_row[pos // bs].astype(np.int64) * bs + pos % bs
        phys_t = torch.as_tensor(phys, device=next(iter(prefill_layers.values())).device)
        for nm in prefill_layers:
            pool, scales = pool_layers[nm], pool_layers.get(f"{nm}_scale")
            for i in range(pool.shape[0]):
                attention.paged_write(pool[i], phys_t, prefill_layers[nm][i, 0, :plen],
                                      scale_pool=None if scales is None else scales[i], kv_quant=kv_quant)

    def imp(pool_layers: Dict[str, torch.Tensor], prefill_layers: Dict[str, torch.Tensor], slot: int,
            plen: int, block_row: np.ndarray) -> Dict[str, torch.Tensor]:
        if cfg.ssm_state:
            for nm in ("conv", "state"):
                pool_layers[nm][:, slot].copy_(prefill_layers[nm][:, 0])
            if cfg.is_hybrid:
                scatter(pool_layers["attn"], prefill_layers["attn"], plen, block_row)
            return pool_layers
        scatter(pool_layers, prefill_layers, plen, block_row)
        return pool_layers

    return imp
