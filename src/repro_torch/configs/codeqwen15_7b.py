"""CodeQwen1.5-7B [dense] — hf:Qwen/CodeQwen1.5-7B (hf tier); port of
``repro/configs/codeqwen15_7b.py``.

Assignment line: 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416.
Qwen1.5 architecture: QKV bias, MHA (kv == heads).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13_440,
    vocab_size=92_416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    notes="qwen1.5 arch: QKV bias, full MHA.",
)
