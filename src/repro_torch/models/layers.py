"""Shared model layers: DiP-aware linear, RMSNorm, RoPE (port of
``repro/models/layers.py``).

``linear`` is where the paper's technique enters the model: every dense
projection goes through ``api.matmul`` with the configured backend, and a
``DipWeight`` carries its own logical width.  ``cross_entropy_loss`` belongs
to the training slice and is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import api

__all__ = ["linear", "rms_norm", "rope_frequencies", "rope_tables", "apply_rope"]

_BIAS_EPILOGUES = ("bias", "bias_gelu", "bias_silu")


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
           backend: Optional[str] = None, compute_dtype: torch.dtype = torch.bfloat16,
           epilogue: Optional[str] = None, epilogue_operands=(), prologue: Optional[str] = None,
           prologue_operands=(), prologue_eps: float = 1e-5) -> torch.Tensor:
    """``epilogue(prologue(x) @ W)`` through the registered matmul backend,
    with x and W in ``compute_dtype``.  A bias always rides the epilogue;
    ``swiglu`` takes a ``(w_gate, w_up)`` pair; ``prologue="rmsnorm"``
    fuses the pre-projection norm (``prologue_operands=(gain,)``)."""
    x = x.to(compute_dtype)
    w = tuple(wi.astype(compute_dtype) if isinstance(wi, api.DipWeight) else wi.to(compute_dtype)
              for wi in w) if isinstance(w, (tuple, list)) else (
        w.astype(compute_dtype) if isinstance(w, api.DipWeight) else w.to(compute_dtype))
    operands = tuple(epilogue_operands)
    if b is not None:
        if epilogue is None:
            epilogue = "bias"
        elif epilogue not in _BIAS_EPILOGUES:
            raise ValueError(f"a bias only composes with the bias epilogues {_BIAS_EPILOGUES}, "
                             f"got epilogue={epilogue!r}")
        operands = (b,) + operands
    return api.matmul(x, w, backend=backend, epilogue=epilogue, epilogue_operands=operands,
                      prologue=prologue, prologue_operands=tuple(prologue_operands),
                      prologue_eps=prologue_eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies for rotary embeddings (host constant)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """``(cos, sin)`` tables for the given absolute positions, computed once
    per forward; shapes (..., seq, 1, head_dim/2), float32."""
    inv_freq = torch.as_tensor(rope_frequencies(head_dim, theta), dtype=torch.float32,
                               device=positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor], theta: float, *,
               tables=None) -> torch.Tensor:
    """Rotate channel halves; x: (..., seq, n_heads, head_dim)."""
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], theta)
    cos, sin = tables
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
