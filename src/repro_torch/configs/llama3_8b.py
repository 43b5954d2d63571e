"""Llama-3-8B [dense] — arXiv:2407.21783 (port of ``repro/configs/llama3_8b.py``).

Assignment line: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    notes="GQA kv=8, 128k vocab.",
)
