"""``DipWeight`` — the paper's permutated weight layout (port of
``repro/api/weights.py``).

``data`` holds the storage, (..., Kp, Np), permutated per 64x64 tile and
zero-padded to the tile grid; ``d_in`` / ``d_out`` are the logical dims;
``perm_tile`` is the tile (64 in the paper).  Leading dims (a layer-stacking
axis) pass through.  ``checksum`` is an optional ABFT child
(``reliability.abft.AbftChecksum``, stamped by ``attach_checksums``) that
``tree`` flattens after ``data`` as the reference does; a new payload or a
cast drops it.  ``plan`` is the optional partition decision
(``distributed.plan.WeightPlan``) that the sharded backends (``dip_tp`` /
``dip_fsdp`` / ``dip_sp``) dispatch on; it rides through a layer slice, a
cast and a new payload.  Under a plan ``data`` is this rank's shard of the
storage while ``d_in`` / ``d_out`` stay the whole weight's logical dims.

Gradients need nothing of this class: ``data`` is the parameter leaf, and
the layer slice (``with_data(data[i])``), the cast of :meth:`astype` and the
gather of :meth:`to_natural` are torch ops, so a cotangent reaches the f32
layer-stacked storage in the permutated layout.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import permute

__all__ = ["PERM_TILE", "DipWeight", "as_dip_weight"]

PERM_TILE = 64  # the paper's systolic-array dimension


def _pad_up(v: int, multiple: int) -> int:
    return v + (-v) % multiple


class DipWeight:
    """Permutated weight storage plus logical-shape metadata."""

    __slots__ = ("data", "d_in", "d_out", "perm_tile", "plan", "checksum")

    def __init__(self, data: torch.Tensor, d_in: int, d_out: int, perm_tile: int = PERM_TILE,
                 plan: Any = None, checksum: Any = None):
        self.data = data
        self.d_in = int(d_in)
        self.d_out = int(d_out)
        self.perm_tile = int(perm_tile)
        self.plan = plan
        self.checksum = checksum

    @staticmethod
    def storage_dims(d_in: int, d_out: int, perm_tile: int = PERM_TILE) -> Tuple[int, int]:
        """Padded (Kp, Np) trailing dims of the permutated storage."""
        return _pad_up(d_in, perm_tile), _pad_up(d_out, perm_tile)

    @classmethod
    def from_natural(cls, w: torch.Tensor, perm_tile: int = PERM_TILE, plan: Any = None) -> "DipWeight":
        """Offline permutation (paper Fig. 3): pad to the tile grid and
        permute each tile; leading dims pass through."""
        d_in, d_out = int(w.shape[-2]), int(w.shape[-1])
        return cls(permute.permute_tiled(w, perm_tile), d_in, d_out, perm_tile, plan)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def storage_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical shape: leading dims + (d_in, d_out)."""
        return tuple(self.data.shape[:-2]) + (self.d_in, self.d_out)

    def to_natural(self) -> torch.Tensor:
        """Recover the natural-layout weight (inverse permutation + crop)."""
        wn = permute.unpermute_tiled(self.data, self.perm_tile)
        return wn[..., : self.d_in, : self.d_out]

    def astype(self, dtype: torch.dtype) -> "DipWeight":
        """Cast the storage (elementwise, so the permutation commutes);
        float-to-float only, as in the reference.  The checksum, computed
        from the old storage, is dropped."""
        if dtype == self.data.dtype:
            return self
        if not dtype.is_floating_point:
            raise TypeError(
                f"DipWeight.astype({dtype}) would truncate storage without scales; "
                "quantize it with api.quant.quantize"
            )
        return self.with_data(self.data.to(dtype))

    def with_data(self, data: torch.Tensor, checksum: Any = None) -> "DipWeight":
        """Same metadata, different payload (a layer slice, a device copy).
        The checksum does not carry over (a new payload invalidates it);
        pass ``checksum=`` to thread a matching one.  The plan rides along."""
        return DipWeight(data, self.d_in, self.d_out, self.perm_tile, self.plan, checksum)

    def with_checksum(self, checksum: Any) -> "DipWeight":
        """Same payload, with an ABFT checksum attached."""
        return DipWeight(self.data, self.d_in, self.d_out, self.perm_tile, self.plan, checksum)

    def with_plan(self, plan: Any) -> "DipWeight":
        """Same payload, another partition decision
        (``distributed.ShardingPlan.attach_params``)."""
        if plan == self.plan:
            return self
        return DipWeight(self.data, self.d_in, self.d_out, self.perm_tile, plan, self.checksum)

    def __repr__(self) -> str:
        plan = "" if self.plan is None else f", plan={self.plan!r}"
        return (f"DipWeight({tuple(self.data.shape)}:{self.data.dtype}, d_in={self.d_in}, "
                f"d_out={self.d_out}, perm_tile={self.perm_tile}{plan})")


def as_dip_weight(w) -> DipWeight:
    """A ``DipWeight`` passes through; a natural tensor is permutated."""
    return w if isinstance(w, DipWeight) else DipWeight.from_natural(w)
