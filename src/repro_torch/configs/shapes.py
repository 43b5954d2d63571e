"""Matmul workload shapes implied by an architecture config (port of
``repro/configs/shapes.py``).

An autotuner (ROADMAP.md Queue 1 "Tooling") and a benchmark need the
concrete (m, k, n) problems a model dispatches so they can be measured on
the card.  This module enumerates the distinct linear
projections of an :class:`~repro_torch.configs.base.ArchConfig` — the same set
``models.transformer.param_template`` materializes as weights — with the M
dimension supplied by the caller (tokens per dispatch: ``batch * seq`` for
training/prefill, the slot count for decode).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

from repro_torch.configs.base import ArchConfig

__all__ = ["MatmulShape", "linear_dims", "matmul_shapes", "stage_matmul_shapes"]


class MatmulShape(NamedTuple):
    name: str
    m: int
    k: int
    n: int


def linear_dims(cfg: ArchConfig) -> List[Tuple[str, int, int]]:
    """Distinct (name, d_in, d_out) pairs of every dense projection.

    Mirrors the weight layout of ``models.transformer.param_template``
    (attention / MLA / MoE / SSM / hybrid families); the embedding table is
    excluded (a gather, not a matmul) but the untied LM head is included.
    """
    d = cfg.d_model
    dims: List[Tuple[str, int, int]] = []

    def add(name: str, d_in: int, d_out: int) -> None:
        if d_in > 0 and d_out > 0:
            dims.append((name, d_in, d_out))

    if cfg.ssm_state:
        from repro_torch.models.ssm import ssm_dims

        sd = ssm_dims(cfg)
        add("in_proj", d, sd["in_dim"])
        add("out_proj", sd["d_inner"], d)
    if cfg.n_heads and not cfg.use_mla and (not cfg.ssm_state or cfg.is_hybrid):
        hd = cfg.resolved_head_dim
        add("wq", d, cfg.n_heads * hd)
        add("wk", d, cfg.n_kv_heads * hd)
        add("wv", d, cfg.n_kv_heads * hd)
        add("wo", cfg.n_heads * hd, d)
    if cfg.use_mla:
        add("wq", d, cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
        add("w_dkv", d, cfg.kv_lora_rank)
        add("w_krope", d, cfg.qk_rope_head_dim)
        add("w_uk", cfg.kv_lora_rank, cfg.n_heads * cfg.qk_nope_head_dim)
        add("w_uv", cfg.kv_lora_rank, cfg.n_heads * cfg.v_head_dim)
        add("wo", cfg.n_heads * cfg.v_head_dim, d)
    if cfg.is_moe:
        add("router", d, cfg.n_experts)
        add("expert_gate_up", d, cfg.d_ff_expert)
        add("expert_down", cfg.d_ff_expert, d)
        if cfg.n_shared_experts:
            sff = cfg.n_shared_experts * cfg.d_ff_expert
            add("shared_gate_up", d, sff)
            add("shared_down", sff, d)
    elif cfg.d_ff and (not cfg.ssm_state or cfg.is_hybrid):
        add("mlp_gate_up", d, cfg.d_ff)
        add("mlp_down", cfg.d_ff, d)
    if not cfg.tie_embeddings:
        add("lm_head", d, cfg.padded_vocab)
    return dims


def matmul_shapes(cfg: ArchConfig, *, tokens: int = 256) -> List[MatmulShape]:
    """Deduplicated (m, k, n) workloads for ``tokens`` rows per dispatch.

    Projections sharing a (d_in, d_out) signature (e.g. gate and up in a
    SwiGLU MLP) collapse into one entry — tuning measures problems, not
    parameter names.
    """
    if tokens <= 0:
        raise ValueError(f"tokens must be positive, got {tokens}")
    out: List[MatmulShape] = []
    seen = set()
    for name, d_in, d_out in linear_dims(cfg):
        key = (tokens, d_in, d_out)
        if key in seen:
            continue
        seen.add(key)
        out.append(MatmulShape(name, tokens, d_in, d_out))
    return out


def stage_matmul_shapes(
    cfg: ArchConfig, *, train_tokens: int, prefill_tokens: int, decode_slots: int
) -> Dict[str, List[MatmulShape]]:
    """The per-stage matmul workload matrix of one fleet cell.

    A train step and a prefill chunk dispatch ``batch * seq`` rows per
    projection; a paged decode step dispatches one row per slot: the
    (m, k, n) set a cell times at each stage.
    """
    return {
        "train": matmul_shapes(cfg, tokens=train_tokens),
        "prefill": matmul_shapes(cfg, tokens=prefill_tokens),
        "decode": matmul_shapes(cfg, tokens=decode_slots),
    }
