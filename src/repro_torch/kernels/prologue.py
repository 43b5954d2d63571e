"""Load-stage prologues for the fused matmul kernel (port of
``repro/kernels/prologue.py``).

RMSNorm factorizes into an O(M) reduction and an O(M*K) elementwise
application.  The wrapper reduces one inverse RMS per row in float32
(:func:`inv_rms`); the kernel rescales each x block as it loads it
(:func:`kernel_load`, and ``load_x_tile`` in ``csrc/dip_matmul.cu``)::

    inv[i]  = rsqrt( sum_k x[i,k]^2 / k_true + eps )     (wrapper)
    xn[i,k] = cast( (x32[i,k] * inv[i]) * g[k] )          (kernel load)

The cast back to the x dtype happens BEFORE the product, so the fused path
matches the decomposed ``rms_norm -> matmul`` composition bit for bit on the
operand the product sees.

Variants: ``none`` (identity) and ``rmsnorm`` (operands: the (K,) gain).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "PROLOGUES",
    "PrologueSpec",
    "DEFAULT_EPS",
    "spec",
    "n_operands",
    "inv_rms",
    "apply",
    "kernel_load",
]

DEFAULT_EPS = 1e-5  # matches layers.rms_norm


@dataclasses.dataclass(frozen=True)
class PrologueSpec:
    """``normalize`` marks the rmsnorm family: the kernel receives the
    per-row float32 inverse RMS plus the float32 gain row."""

    name: str
    normalize: bool = False

    @property
    def n_operands(self) -> int:
        return int(self.normalize)


PROLOGUES: Tuple[str, ...] = ("none", "rmsnorm")

_SPECS = {
    "none": PrologueSpec("none"),
    "rmsnorm": PrologueSpec("rmsnorm", normalize=True),
}


def spec(name: Optional[str]) -> PrologueSpec:
    try:
        return _SPECS[name or "none"]
    except KeyError:
        raise ValueError(f"unknown prologue {name!r}; supported: {list(PROLOGUES)}") from None


def n_operands(name: Optional[str]) -> int:
    return spec(name).n_operands


def inv_rms(x: torch.Tensor, *, k_true: Optional[int] = None,
            eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Per-row ``(M, 1)`` float32 inverse RMS of ``x``.  ``k_true`` is the
    un-padded contraction dim: zero padding adds nothing to the sum of
    squares, but the mean's divisor stays the logical width."""
    x32 = x.float()
    k = x.shape[-1] if k_true is None else k_true
    ssq = torch.sum(x32 * x32, dim=-1, keepdim=True)
    return torch.rsqrt(ssq / k + eps)


def kernel_load(name: Optional[str], x: torch.Tensor, pro_operands=()) -> torch.Tensor:
    """The kernel's x load, applied to a whole block: ``rmsnorm`` scales by
    ``(inv, g)`` — inv (..., 1) per row, g (K,) — in float32 and casts ONCE
    back to the x dtype."""
    if not spec(name).normalize:
        return x
    inv, g = pro_operands
    xn = x.float() * inv.float() * g.reshape(-1).float()
    return xn.to(x.dtype)


def apply(name: Optional[str], x: torch.Tensor, *operands: torch.Tensor,
          k_true: Optional[int] = None, eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Apply one prologue to the activation ``x`` (the decomposed form)."""
    s = spec(name)
    if len(operands) != s.n_operands:
        raise ValueError(
            f"prologue {s.name!r} takes {s.n_operands} operand(s), got {len(operands)}"
        )
    if not s.normalize:
        return x
    (g,) = operands
    return kernel_load(name, x, (inv_rms(x, k_true=k_true, eps=eps), g))
