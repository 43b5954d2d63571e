"""MusicGen-medium [audio] — arXiv:2306.05284 (hf tier); port of
``repro/configs/musicgen_medium.py``.

Assignment line: 48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048 —
decoder-only over EnCodec tokens.  The EnCodec frontend (4 codebooks,
delay-pattern interleaving) is a STUB: input_specs() provides precomputed
frame embeddings; the decoder predicts one 2048-way codebook stream.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio_stub",
    rope_theta=10_000.0,
    notes="24 heads (not divisible by 16-way TP) — attention uses "
          "sequence sharding instead of head sharding; see docs/benchmarks.md §Perf.",
)
