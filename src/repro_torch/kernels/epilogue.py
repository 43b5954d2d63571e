"""Flush-stage epilogues for the fused matmul kernel (port of
``repro/kernels/epilogue.py``).

The kernel applies these to its float32 accumulator once the K loop ends
(``apply_epilogue`` in ``csrc/dip_matmul.cu``) and writes the output once;
the plain versions and the registry's decomposition apply :func:`apply` to
the full float32 product.  All arithmetic is float32, with one cast to the
output dtype by the caller.

    none        z
    bias        z + b                         operands: (b,)  — (N,) bias
    bias_gelu   gelu_tanh(z + b)              operands: (b,)
    bias_silu   silu(z + b)                   operands: (b,)
    swiglu      silu(z_gate) * z_up           dual-weight: w = (w_gate, w_up)
    residual    z + r                         operands: (r,) — (M, N) residual
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["EPILOGUES", "EpilogueSpec", "spec", "n_operands", "apply", "code"]


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    name: str
    dual_weight: bool = False
    bias: bool = False
    residual: bool = False
    activation: Optional[str] = None  # None | "gelu" | "silu"

    @property
    def n_operands(self) -> int:
        """Extra operands beyond (x, w): the up-projection weight for the
        dual-weight epilogue, the bias row, or the residual block."""
        return int(self.dual_weight) + int(self.bias) + int(self.residual)


EPILOGUES: Tuple[str, ...] = ("none", "bias", "bias_gelu", "bias_silu", "swiglu", "residual")

_SPECS = {
    "none": EpilogueSpec("none"),
    "bias": EpilogueSpec("bias", bias=True),
    "bias_gelu": EpilogueSpec("bias_gelu", bias=True, activation="gelu"),
    "bias_silu": EpilogueSpec("bias_silu", bias=True, activation="silu"),
    "swiglu": EpilogueSpec("swiglu", dual_weight=True),
    "residual": EpilogueSpec("residual", residual=True),
}


def spec(name: Optional[str]) -> EpilogueSpec:
    try:
        return _SPECS[name or "none"]
    except KeyError:
        raise ValueError(f"unknown epilogue {name!r}; supported: {list(EPILOGUES)}") from None


def n_operands(name: Optional[str]) -> int:
    return spec(name).n_operands


def code(name: Optional[str]) -> int:
    """The integer the CUDA kernel takes for this epilogue (its ``Epilogue``
    enum follows the order of :data:`EPILOGUES`)."""
    return EPILOGUES.index(spec(name).name)


def _activate(kind: Optional[str], z: torch.Tensor) -> torch.Tensor:
    if kind is None:
        return z
    if kind == "gelu":
        return F.gelu(z, approximate="tanh")
    if kind == "silu":
        return F.silu(z)
    raise ValueError(f"unknown epilogue activation {kind!r}")


def apply(name: Optional[str], z: torch.Tensor, *operands: torch.Tensor) -> torch.Tensor:
    """Apply one epilogue to the float32 pre-activation ``z``.  For
    ``swiglu`` the operand is the up-projection pre-activation; for the bias
    variants a row broadcastable over z; for ``residual`` a tensor of z's
    shape.  Returns float32."""
    s = spec(name)
    if len(operands) != s.n_operands:
        raise ValueError(
            f"epilogue {s.name!r} takes {s.n_operands} operand(s), got {len(operands)}"
        )
    if s.dual_weight:
        (z_up,) = operands
        return F.silu(z) * z_up.float()
    if s.bias:
        (b,) = operands
        z = z + b.float()
    z = _activate(s.activation, z)
    if s.residual:
        (r,) = operands
        z = z + r.float()
    return z
