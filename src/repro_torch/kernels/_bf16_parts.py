"""The exact bf16 part split that the tensor-core kernels take for f32
operands, in plain torch.

An f32 value splits into three bf16 parts by truncation (:func:`bf16_parts`,
whose sum is the value exactly), so every part product is exact in f32 and
no operand is rounded to TF32.  ``lm_head_ce``'s bf16 x route splits the f32
head alone; the f32 x f32 routes (``lm_head_ce``, flash attention) split
both operands and keep the :data:`F32_PRODUCTS` largest part products
(:func:`part_products`, summed smallest first as the kernels sum them).
:func:`split_matmul` is that arithmetic for one product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["F32_PRODUCTS", "bf16_parts", "part_products", "split_matmul"]

# bf16 part products a_i b_j of an f32 x f32 product on the tensor cores:
# those with i + j <= 2 (the dropped ones are about 2^-24 of the product;
# three, i + j <= 1, miss f32 TOL)
F32_PRODUCTS = 6


def bf16_parts(w: torch.Tensor, parts: int = 3) -> Tuple[torch.Tensor, ...]:
    """The kernels' split of f32 values into bf16 parts: ``hi`` = w
    truncated to bf16, ``mid`` = (w - hi) truncated, ``lo`` = w - hi - mid
    (for ``parts`` = 3; the f32 subtractions are exact).  For a normal f32
    w, ``hi + mid + lo == w`` exactly, so each part product of a bf16
    operand is exact in f32."""
    def trunc(v):
        return (v.float().contiguous().view(torch.int32) & -65536).view(torch.float32)

    out, rest = [], w.float()
    for _ in range(parts):
        out.append(trunc(rest))
        rest = rest - out[-1]
    return tuple(p.to(torch.bfloat16) for p in out)


def part_products(n: int = F32_PRODUCTS) -> Tuple[Tuple[int, int], ...]:
    """The ``n`` largest part products ``(i, j)`` of two operands split by
    :func:`bf16_parts` (a_i b_j is about 2^-8(i + j) of a b), smallest
    first, the order in which the kernels sum them."""
    by_size = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))
    if not 1 <= n <= len(by_size):
        raise ValueError(f"part products: 1 to {len(by_size)}, got {n}")
    return tuple(reversed(by_size[:n]))


def split_matmul(a: torch.Tensor, b: torch.Tensor, products: int = F32_PRODUCTS,
                 step: Optional[int] = None) -> torch.Tensor:
    """``a @ b`` for f32 (M, K) and (K, N) as the tensor cores take it:
    both split into three bf16 parts, each part product exact in f32, the
    :func:`part_products` summed smallest first from zero over each
    ``step``-deep slice of K and added to an f32 total (``step`` None: one
    slice, the whole of K)."""
    pa, pb = bf16_parts(a), bf16_parts(b)
    k = a.shape[-1]
    step = k if step is None else step
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    for k0 in range(0, k, step):
        acc = torch.zeros_like(total)
        for i, j in part_products(products):
            acc += pa[i][:, k0:k0 + step].float() @ pb[j][k0:k0 + step].float()
        total += acc
    return total
