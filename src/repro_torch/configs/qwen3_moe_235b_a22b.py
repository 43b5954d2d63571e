"""Qwen3-MoE 235B-A22B [moe] — hf:Qwen/Qwen3-30B-A3B family (hf tier); port
of ``repro/configs/qwen3_moe_235b_a22b.py``.

Assignment line: 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936,
MoE 128e top-8.  head_dim=128 per the Qwen3 family (explicit head_dim).
Qwen3's qk-norm is omitted (uniform attention path), noted in DESIGN.md.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    n_experts=128,
    n_shared_experts=0,
    moe_top_k=8,
    d_ff_expert=1536,
    rope_theta=1_000_000.0,
    notes="128 routed experts top-8, no shared experts; GQA kv=4.",
)
