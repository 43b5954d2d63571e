"""Plain-torch oracles for the matmul kernel (port of the parts of
``repro/kernels/ref.py`` this slice needs).

Each ``*_ref`` computes the kernel's function with plain torch ops in
float32 (int32 for integer operands) accumulation.
"""

from __future__ import annotations

import torch

from repro_torch.core import permute
from repro_torch.kernels import epilogue as _epi

__all__ = [
    "acc_dtype_for",
    "ws_matmul_ref",
    "dip_matmul_ref",
    "epilogue_ref",
    "ws_matmul_epilogue_ref",
    "dip_matmul_epilogue_ref",
]


def acc_dtype_for(*args: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: int32 for integer operands, else float32."""
    if all(not (a.dtype.is_floating_point or a.dtype.is_complex) for a in args):
        return torch.int32
    return torch.float32


def ws_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain matmul in the accumulation dtype."""
    acc = acc_dtype_for(x, w)
    return torch.matmul(x.to(acc), w.to(acc))


def dip_matmul_ref(x: torch.Tensor, p: torch.Tensor, *, perm_tile: int = 64) -> torch.Tensor:
    """``x @ unpermute_tiled(p)`` — ``p`` in DiP-permutated storage."""
    return ws_matmul_ref(x, permute.unpermute_tiled(p, perm_tile))


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
