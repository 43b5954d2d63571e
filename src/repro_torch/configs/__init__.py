"""Architecture registry (port of ``repro/configs/__init__.py``).

The dense ``llama3-8b``, the two MoE configurations (``deepseek-v2-lite-16b``
with multi-head latent attention, ``qwen3-moe-235b-a22b`` with GQA), the
attention-free ``mamba2-370m`` (tied embeddings) and the hybrid
``zamba2-2.7b`` (Mamba2 blocks and one shared attention+FFN block) are
ported; the other five come with their families (ROADMAP.md Queue 1 "Other
model families").
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

ALL_ARCHS: List[str] = ["deepseek_v2_lite_16b", "qwen3_moe_235b_a22b", "llama3_8b", "mamba2_370m",
                        "zamba2_2_7b"]

_ALIASES: Dict[str, str] = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama3-8b": "llama3_8b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2_7b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALL_ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ported: {ALL_ARCHS}; "
            'the other families come with ROADMAP.md Queue 1 "Other model families")'
        )
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


__all__ = ["ALL_ARCHS", "ArchConfig", "get_config"]
