"""The dense SwiGLU MLP (port of ``repro/models/moe.py::dense_ffn``).

The routed Mixture-of-Experts layer comes with the MoE family (ROADMAP.md
Queue 1 "Other model families").
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import layers

__all__ = ["dense_ffn"]


def dense_ffn(x: torch.Tensor, p: Dict, cfg, *, residual: Optional[torch.Tensor] = None,
              norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SwiGLU MLP: the gate and up projections run as ONE dual-weight
    ``swiglu`` dispatch (one kernel launch on the ``dip`` backend), then the
    down projection with the block's skip connection fused as the
    ``residual`` epilogue.  ``norm`` is the pre-FFN RMSNorm gain when the
    backend fuses prologues (x then arrives un-normalized)."""
    lk = dict(backend=cfg.matmul_backend, compute_dtype=x.dtype)
    gk = dict(lk) if norm is None else dict(lk, prologue="rmsnorm", prologue_operands=(norm,),
                                            prologue_eps=cfg.norm_eps)
    h = layers.linear(x, (p["w_gate"], p["w_up"]), epilogue="swiglu", **gk)
    if residual is not None:
        return layers.linear(h, p["w_down"], epilogue="residual", epilogue_operands=(residual,), **lk)
    return layers.linear(h, p["w_down"], **lk)
