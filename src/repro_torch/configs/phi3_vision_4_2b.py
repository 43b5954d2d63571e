"""Phi-3-Vision 4.2B [vlm] — hf:microsoft/Phi-3-vision-128k-instruct (hf tier); port of
``repro/configs/phi3_vision_4_2b.py``.

Assignment line: 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064 —
phi3-mini backbone + CLIP frontend.  Per the assignment, the modality
frontend is a STUB: input_specs() provides precomputed patch embeddings
(batch, seq, d_model); only the transformer backbone is modeled.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    frontend="vision_stub",
    rope_theta=10_000.0,
    notes="Backbone only; CLIP patch embeddings stubbed via input_specs().",
)
