"""DeepSeek-V2-Lite 16B [moe] — arXiv:2405.04434 (hf-verified tier); port of
``repro/configs/deepseek_v2_lite_16b.py``.

Assignment line: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE 64e top-6 — MLA kv_lora=512, 2 shared+160 routed top-6.

The assignment's "64e top-6" and "160 routed" conflict; we follow the
explicit config fields (64 routed experts, top-6, 2 shared) — recorded in
DESIGN.md §4.  All layers are MoE (the real model's dense first layer is
folded into the uniform scanned stack).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=102_400,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_ff_expert=1408,
    rope_theta=10_000.0,
    notes="MLA latent cache (512+64 per token); 2 shared + 64 routed experts top-6.",
)
