"""Yi-9B [dense] — arXiv:2403.04652 (hf tier); port of
``repro/configs/yi_9b.py``.

Assignment line: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=10_000.0,
    notes="llama-arch GQA kv=4.",
)
