"""Zamba2-2.7B [hybrid] — arXiv:2411.15242 (hf tier); port of
``repro/configs/zamba2_2_7b.py``.

Assignment line: 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 + shared attn blocks.  The single shared
attention+FFN block is applied after every 6th Mamba2 block (9 call sites),
following Zamba2's shared-block pattern (its per-application LoRA deltas and
input concatenation are simplified to direct reuse; DESIGN.md §4).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    attn_every=6,
    notes="54 mamba2 blocks + shared GQA block every 6 layers.",
)
