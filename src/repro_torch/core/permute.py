"""DiP weight permutation (paper Fig. 3) and its inverse, on torch tensors.

Port of ``repro/core/permute.py``.  The DiP dataflow stores the weight
matrix *permutated*: each column ``i`` of every ``tile x tile`` block is
rotated **up** by ``i`` positions (wrap-around)::

    P[j][i] = W[(j + i) mod tile][i]

``permute_tiled`` / ``unpermute_tiled`` apply that to each block of a
(possibly batched) matrix, zero-padding ragged edges up to the tile grid and
returning the PADDED storage, exactly as the reference does.
``permute_weights`` / ``unpermute_weights`` rotate whole (R, C) matrices
(modulo R, no tiling), and ``rotate_rows_left`` is the diagonal input
movement of the array.  The numpy index helpers and the literal pseudocode
transcriptions are copied from the reference unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "permutation_indices",
    "inverse_permutation_indices",
    "permute_weights",
    "unpermute_weights",
    "permute_weights_np",
    "unpermute_weights_np",
    "permute_tiled",
    "unpermute_tiled",
    "rotate_rows_left",
]

_BYTE_VIEWED = (torch.float8_e4m3fn, torch.float8_e5m2)


def permutation_indices(rows: int, cols: int) -> np.ndarray:
    """Static gather indices implementing ``P[j][i] = W[(j+i) % rows][i]``."""
    j = np.arange(rows)[:, None]
    i = np.arange(cols)[None, :]
    return ((j + i) % rows).astype(np.int32)


def inverse_permutation_indices(rows: int, cols: int) -> np.ndarray:
    """Indices for the inverse map ``W[k][i] = P[(k - i) % rows][i]``."""
    k = np.arange(rows)[:, None]
    i = np.arange(cols)[None, :]
    return ((k - i) % rows).astype(np.int32)


def _row_gather(w: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """``out[..., j, i] = w[..., idx[j, i], i]`` over the trailing two dims
    (leading dims untouched)."""
    if w.dtype in _BYTE_VIEWED:  # torch's gather has no float8 kernel: move the bytes
        return _row_gather(w.view(torch.uint8), idx).view(w.dtype)
    index = torch.as_tensor(idx, dtype=torch.int64, device=w.device).expand(w.shape)
    return torch.gather(w, -2, index)


def permute_weights(w: torch.Tensor) -> torch.Tensor:
    """DiP-permute the trailing two dims of ``w`` (paper Fig. 3 pseudocode)."""
    return _row_gather(w, permutation_indices(w.shape[-2], w.shape[-1]))


def unpermute_weights(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`permute_weights`."""
    return _row_gather(p, inverse_permutation_indices(p.shape[-2], p.shape[-1]))


def permute_weights_np(w: np.ndarray) -> np.ndarray:
    """Pure-numpy reference, the literal transcription of the paper's pseudocode."""
    rows, cols = w.shape
    out = np.empty_like(w)
    for i in range(cols):
        for j in range(rows):
            out[j][i] = w[(j + i) % rows][i]
    return out


def unpermute_weights_np(p: np.ndarray) -> np.ndarray:
    rows, cols = p.shape
    out = np.empty_like(p)
    for i in range(cols):
        for k in range(rows):
            out[k][i] = p[(k - i) % rows][i]
    return out


_INDEX = {}


def _tile_index(tile: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """The (tile, tile) int64 gather index on ``device``, copied there once
    per (device, tile, direction): a de-shear inside a serving step (MLA's
    absorbed form) then copies no host data, so a CUDA graph can capture it."""
    key = (device, tile, inverse)
    index = _INDEX.get(key)
    if index is None:
        idx = inverse_permutation_indices(tile, tile) if inverse else permutation_indices(tile, tile)
        index = _INDEX[key] = torch.as_tensor(idx, dtype=torch.int64, device=device)
    return index


def _permute_tiled_impl(w: torch.Tensor, tile: int, inverse: bool) -> torch.Tensor:
    if w.dtype in _BYTE_VIEWED:  # torch's gather has no float8 kernel: move the bytes
        return _permute_tiled_impl(w.view(torch.uint8), tile, inverse).view(w.dtype)
    r, c = w.shape[-2], w.shape[-1]
    pr, pc = (-r) % tile, (-c) % tile
    if pr or pc:
        w = F.pad(w, (0, pc, 0, pr))
    rp, cp = w.shape[-2], w.shape[-1]
    lead = tuple(w.shape[:-2])
    # (..., Rt, tile, Ct, tile) -> (..., Rt, Ct, tile, tile)
    blk = w.reshape(lead + (rp // tile, tile, cp // tile, tile)).transpose(-3, -2)
    index = _tile_index(tile, inverse, w.device).expand(blk.shape)
    blk = torch.gather(blk, -2, index)
    # the result stays PADDED to the tile grid (see the reference's note:
    # cropping would drop elements the rotation moved into padding rows)
    return blk.transpose(-3, -2).reshape(lead + (rp, cp))


def permute_tiled(w: torch.Tensor, tile: int = 64) -> torch.Tensor:
    """Permute each ``tile x tile`` block independently; ragged edges are
    zero-padded and the PADDED tensor is returned (the storage format):
    ``unpermute_tiled(permute_tiled(w))[..., :r, :c] == w``."""
    return _permute_tiled_impl(w, tile, False)


def unpermute_tiled(p: torch.Tensor, tile: int = 64) -> torch.Tensor:
    """Inverse of :func:`permute_tiled` (still padded to the tile grid)."""
    return _permute_tiled_impl(p, tile, True)


def rotate_rows_left(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Rotate the trailing axis left by ``shift`` (diagonal input movement):
    an input row hops from PE row ``r`` to ``r + 1`` rotated left by one
    (paper Fig. 2a / Fig. 4a)."""
    return torch.roll(x, -shift, dims=-1)
