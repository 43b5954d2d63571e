"""Mamba2-370M [ssm] — arXiv:2405.21060 (unverified tier); port of
``repro/configs/mamba2_370m.py``.

Assignment line: 48L d_model=1024 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    notes="Attention-free SSD; DiP applies to in/out projections and the "
          "chunked quadratic forms; recurrent decay is VPU work.",
)
