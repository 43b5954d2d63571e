"""Plain-torch oracles for the matmul kernels (port of
``repro/kernels/ref.py``).

Each ``*_ref`` computes the kernel's function with plain torch ops in
float32 (int32 for integer operands) accumulation.  Integer products go
through :func:`int_matmul`: torch has no integer ``matmul`` for CUDA
tensors, and float64 holds every int8 x int8 sum these shapes give exactly
(|sum| < 2^53), so the cast to int32 is exact.
"""

from __future__ import annotations

import torch

from repro_torch.core import permute
from repro_torch.kernels import epilogue as _epi

__all__ = [
    "acc_dtype_for",
    "int_matmul",
    "ws_matmul_ref",
    "dip_matmul_ref",
    "dip_systolic_ref",
    "quantize_acts_int8",
    "dip_matmul_int8w_ref",
    "dip_matmul_fp8_ref",
    "epilogue_ref",
    "ws_matmul_epilogue_ref",
    "dip_matmul_epilogue_ref",
    "dip_matmul_int8w_epilogue_ref",
    "dip_matmul_fp8_epilogue_ref",
]


def acc_dtype_for(*args: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: int32 for integer operands, else float32."""
    if all(not (a.dtype.is_floating_point or a.dtype.is_complex) for a in args):
        return torch.int32
    return torch.float32


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer operands (through float64)."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def ws_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain matmul in the accumulation dtype."""
    if acc_dtype_for(x, w) == torch.int32:
        return int_matmul(x, w)
    return torch.matmul(x.float(), w.float())


def dip_matmul_ref(x: torch.Tensor, p: torch.Tensor, *, perm_tile: int = 64) -> torch.Tensor:
    """``x @ unpermute_tiled(p)`` — ``p`` in DiP-permutated storage."""
    return ws_matmul_ref(x, permute.unpermute_tiled(p, perm_tile))


def dip_systolic_ref(x: torch.Tensor, p: torch.Tensor, *, perm_tile: int = 64) -> torch.Tensor:
    """The wavefront kernel's function: the same product as the fast path,
    pinned to its own oracle as in the reference."""
    return dip_matmul_ref(x, p, perm_tile=perm_tile)


# ------------------------------------------------------- quantized oracles --
def quantize_acts_int8(x: torch.Tensor):
    """Dynamic symmetric per-row int8 activation quantization: ``(q, scale)``
    with q int8 of x's shape and scale float32 ``(..., 1)``, ``q * scale ~=
    x``; all-zero rows get the floor scale.  Divides, rounds half to even and
    clips exactly as the reference, so the bytes agree.  127 is divided by
    as a tensor on x's device: torch's CUDA division by a Python scalar
    multiplies by its rounded reciprocal, which moves some scales by one
    ulp (and their codes with them) off the reference's IEEE quotient."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8w_z(xq, x_scale, q, w_scale, perm_tile):
    acc = int_matmul(xq, permute.unpermute_tiled(q, perm_tile))
    return acc.float() * x_scale * w_scale.float()


def _fp8_z(x, q, w_scale, perm_tile):
    w = permute.unpermute_tiled(q, perm_tile).float()
    return torch.matmul(x.float(), w) * w_scale.float()


def dip_matmul_int8w_ref(x, q, w_scale, *, perm_tile: int = 64) -> torch.Tensor:
    """W8A8-dynamic: per-row int8 activations times per-column int8 weights,
    exact int32 accumulation, ``acc * x_scale * w_scale`` in f32."""
    xq, x_scale = quantize_acts_int8(x)
    return _int8w_z(xq, x_scale, q, w_scale, perm_tile).to(_out_dtype(x))


def dip_matmul_fp8_ref(x, q, w_scale, *, perm_tile: int = 64) -> torch.Tensor:
    """fp8 weights upcast, f32 accumulation, per-column scale on output."""
    return _fp8_z(x, q, w_scale, perm_tile).to(_out_dtype(x))


epilogue_ref = _epi.apply


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.dtype.is_floating_point else torch.float32


def ws_matmul_epilogue_ref(x, w, *, epilogue="none", operands=()) -> torch.Tensor:
    """``epilogue(x @ w)``; for ``swiglu`` ``operands`` is ``(w_up,)``."""
    z = ws_matmul_ref(x, w).float()
    if _epi.spec(epilogue).dual_weight:
        aux = (ws_matmul_ref(x, operands[0]).float(),)
    else:
        aux = tuple(op.float() for op in operands)
    return _epi.apply(epilogue, z, *aux).to(_out_dtype(x))


def dip_matmul_epilogue_ref(x, p, *, epilogue="none", operands=(), perm_tile=64) -> torch.Tensor:
    """``epilogue(x @ unpermute_tiled(p))``; for ``swiglu`` ``operands`` is
    ``(p_up,)`` in permutated storage."""
    z = dip_matmul_ref(x, p, perm_tile=perm_tile).float()
    if _epi.spec(epilogue).dual_weight:
        aux = (dip_matmul_ref(x, operands[0], perm_tile=perm_tile).float(),)
    else:
        aux = tuple(op.float() for op in operands)
    return _epi.apply(epilogue, z, *aux).to(_out_dtype(x))


def dip_matmul_int8w_epilogue_ref(x, q, w_scale, *, epilogue="none", operands=(),
                                  perm_tile=64) -> torch.Tensor:
    """W8A8-dynamic fused semantics: the epilogue after the scale on output;
    for ``swiglu`` ``operands`` is ``(q_up, w_scale_up)`` over the SAME
    quantized activations."""
    xq, x_scale = quantize_acts_int8(x)
    z = _int8w_z(xq, x_scale, q, w_scale, perm_tile)
    if _epi.spec(epilogue).dual_weight:
        aux = (_int8w_z(xq, x_scale, operands[0], operands[1], perm_tile),)
    else:
        aux = tuple(op.float() for op in operands)
    return _epi.apply(epilogue, z, *aux).to(_out_dtype(x))


def dip_matmul_fp8_epilogue_ref(x, q, w_scale, *, epilogue="none", operands=(),
                                perm_tile=64) -> torch.Tensor:
    """fp8-weight fused semantics: per-column scale, then the epilogue, f32."""
    z = _fp8_z(x, q, w_scale, perm_tile)
    if _epi.spec(epilogue).dual_weight:
        aux = (_fp8_z(x, operands[0], operands[1], perm_tile),)
    else:
        aux = tuple(op.float() for op in operands)
    return _epi.apply(epilogue, z, *aux).to(_out_dtype(x))
