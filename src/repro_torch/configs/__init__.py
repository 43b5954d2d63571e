"""Architecture registry (port of ``repro/configs/__init__.py``).

Every configuration of the reference resolves here with the same fields.
The port serves and trains the dense ``llama3-8b``, ``yi-9b``,
``codeqwen1.5-7b`` (QKV bias, full MHA) and ``qwen2-72b`` (144 GB in bf16:
``reduced()`` only on one card), the two MoE configurations
(``deepseek-v2-lite-16b`` with multi-head latent attention,
``qwen3-moe-235b-a22b`` with GQA), the attention-free ``mamba2-370m`` (tied
embeddings), the hybrid ``zamba2-2.7b`` (Mamba2 blocks and one shared
attention+FFN block) and the dense decoders behind the stub frontends,
``phi-3-vision-4.2b`` and ``musicgen-medium``: trained on the precomputed
embeddings that the data pipeline stands in for the frontends with, served
from tokens, as the reference does.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPE_CELLS, ArchConfig, ShapeCell
from repro_torch.configs.shapes import MatmulShape, linear_dims, matmul_shapes

ALL_ARCHS: List[str] = [
    "deepseek_v2_lite_16b",
    "qwen3_moe_235b_a22b",
    "mamba2_370m",
    "llama3_8b",
    "codeqwen15_7b",
    "yi_9b",
    "qwen2_72b",
    "phi3_vision_4_2b",
    "musicgen_medium",
    "zamba2_2_7b",
]

# assignment ids (with dashes/dots) -> module names
_ALIASES: Dict[str, str] = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-370m": "mamba2_370m",
    "llama3-8b": "llama3_8b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "yi-9b": "yi_9b",
    "qwen2-72b": "qwen2_72b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-2.7b": "zamba2_2_7b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALL_ARCHS:
        raise KeyError(f"unknown architecture {name!r}; registered: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def shape_cells_for(cfg: ArchConfig) -> List[ShapeCell]:
    """The assigned shape set, honouring the long_500k sub-quadratic gate."""
    return [cell for cell in SHAPE_CELLS if cell.name != "long_500k" or cfg.sub_quadratic]


__all__ = [
    "ALL_ARCHS",
    "ArchConfig",
    "ShapeCell",
    "SHAPE_CELLS",
    "MatmulShape",
    "get_config",
    "shape_cells_for",
    "linear_dims",
    "matmul_shapes",
]
