"""Attention-backend registry (port of ``repro/api/attention.py``).

Layout contract (flat): ``q (BH, Sq, D)``, ``k (BH, Sk, D)``, ``v (BH, Sk,
Dv)`` -> ``(BH, Sq, Dv)``; ``q_offset`` places query 0 at an absolute key
position (the chunked-prefill shape) and ``kv_len`` bounds the live keys per
row.  Rows that end up fully masked return exactly 0 on every backend.

    flash   the CUDA kernel (``kernels/flash_attention.py``); forward only
    dense   the torch oracle: the same function with the (BH, Sq, Sk)
            scores materialized, in f32 (the peer of ``xla``)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import attention_plain, flash_attention

__all__ = ["DEFAULT_ATTENTION_BACKEND", "attention"]

DEFAULT_ATTENTION_BACKEND = "flash"
_REGISTRY = {"flash": flash_attention, "dense": attention_plain}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              backend: Optional[str] = None, causal: bool = True, q_offset=None,
              kv_len=None, scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch one attention call to a registered backend."""
    name = backend or DEFAULT_ATTENTION_BACKEND
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown attention backend {name!r}; registered: {sorted(_REGISTRY)}") from None
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), q_offset=q_offset, kv_len=kv_len,
              causal=causal, scale=scale)
