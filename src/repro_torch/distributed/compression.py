"""Gradient compression with error feedback (port of
``repro/distributed/compression.py``).

1. :func:`compression_transform` — a ``GradientTransform`` for
   ``optim.AdamW(grad_transform=)``: each gradient leaf plus its
   error-feedback residual is quantized to int8 with one scale for the
   leaf, ``max|x| / 127 + 1e-12`` in f32 (:func:`quantize_int8`: round half
   to even, the division by the scale tensor), dequantized, and the
   quantization residual carried to the next step in an f32 buffer shaped
   like the parameter, so the long-run bias vanishes.  (The reference's
   ``enabled`` argument, which it ignores, is not ported.)  AdamW applies it
   before clipping, so ``grad_norm`` is the compressed gradients' norm.
2. :func:`compressed_psum` — the all-reduce mean of an int8-quantized
   tensor over a mesh axis: the ranks' scales maxed (``comm.pmax``), the
   codes summed in int32 (``comm.psum``), rescaled and divided by the
   axis size.

**Under a sharding plan** a rank holds a slice of a leaf (its columns, its
experts, its stage's layers), while the reference's scale is the *whole*
leaf's maximum.  ``fn(grads, state, reduce_max=)`` takes the function that
maxes the vector of the rank's per-leaf maxima over the ranks that share
the leaves (``comm.pmax`` over the plan's rank axis: ONE collective a
step; a leaf every rank holds whole has the same maximum on each); with
that shared scale the transform of a rank's slice is the slice of the
whole leaf's transform, bit for bit.  Without it every rank would quantize
with its own scale and the result would be wrong with no error raised.

Unlike the reference (functional, under ``jit``), the transform works IN
PLACE, as the port's ``AdamW.update`` does: it writes the compressed
gradients into the gradient tensors and the new residual into the buffer,
slab by slab along the leading axis (``optim.adamw.SLAB``), so a
full-width step holds no second copy of either.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import comm
from repro_torch.optim.adamw import GradientTransform, _slabs

__all__ = ["compression_transform", "quantize_int8", "dequantize_int8", "compressed_psum"]


def _over(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` in f32, dividing by a tensor: torch's CUDA division by a
    Python scalar multiplies by its rounded reciprocal (``api/quant.py``)."""
    return t.float() / torch.full((), d, dtype=torch.float32, device=t.device)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """The reference's int8 scale of a tensor whose ``max|x|`` is ``amax``."""
    return _over(amax, 127.0) + 1e-12


def _codes(x: torch.Tensor, scale: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as ``dtype``: half to even,
    the division by the 0-d scale tensor, as the reference's."""
    return torch.round(x.float() / scale).clamp_(-127, 127).to(dtype)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: int8 codes of ``x`` and its f32 0-d scale
    ``max|x| / 127 + 1e-12``."""
    scale = _scale_of(x.abs().amax())
    return _codes(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compression_transform() -> GradientTransform:
    """Int8 gradient quantization with per-leaf error feedback (module
    doc).  ``init(params)``: an f32 zero buffer per parameter leaf (this
    rank's slice under a plan).  ``fn(grads, err, reduce_max=None)``
    returns ``(grads, err)``, both updated in place (module doc)."""

    def init(params):
        return tree.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

    @torch.no_grad()
    def fn(grads, err, reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        flat_g, flat_e = tree.leaves(grads), tree.leaves(err)
        if len(flat_g) != len(flat_e):
            raise ValueError(f"{len(flat_g)} gradient leaves, {len(flat_e)} error-feedback buffers")
        # max|g + e| of each leaf, slab by slab; then shared over the ranks
        amax = torch.stack([torch.stack([(gs.float() + es).abs().amax() for gs, es in zip(_slabs(g), _slabs(e))])
                            .amax() for g, e in zip(flat_g, flat_e)])
        if reduce_max is not None:
            amax = reduce_max(amax)
        scales = _scale_of(amax)
        for g, e, scale in zip(flat_g, flat_e, scales.unbind(0)):
            for gs, es in zip(_slabs(g), _slabs(e)):
                g32 = gs.float() + es
                deq = dequantize_int8(_codes(g32, scale), scale)
                es.copy_(g32 - deq)
                gs.copy_(deq.to(gs.dtype))
        return tree.unflatten(grads, flat_g), err

    return GradientTransform(fn=fn, init=init)


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean over ``axis`` with an int8 payload: each rank quantizes
    with the ranks' largest scale (one ``pmax``), so that the int32 sum of
    the codes (one ``psum``) cannot overflow, then rescales and divides by
    the axis size (the reference's ``psum`` of ones).  Not differentiated."""
    x = x.detach()
    scale = comm.pmax(_scale_of(x.abs().amax()), mesh, axis)
    total = comm.psum(_codes(x, scale, torch.int32), mesh, axis)
    return _over(total.float() * scale, float(mesh.shape[axis])).to(x.dtype)
