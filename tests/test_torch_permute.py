"""The port's DiP permutation against ``repro.core.permute`` on the same
numpy inputs: the layout is a pure relayout, so the comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.api import DipWeight as RefDipWeight
from repro.core import permute as ref
from repro_torch.api import DipWeight
from repro_torch.core import permute

SHAPES = [(64, 64), (128, 192), (100, 130), (7, 300), (65, 1), (3, 64, 128), (2, 2, 70, 33)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", [64, 8])
def test_permute_tiled_matches_reference(shape, tile):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = permute.permute_tiled(torch.from_numpy(w), tile).numpy()
    want = np.asarray(ref.permute_tiled(jnp.asarray(w), tile))
    np.testing.assert_array_equal(got, want)
    back = permute.unpermute_tiled(torch.from_numpy(got), tile).numpy()
    np.testing.assert_array_equal(back, np.asarray(ref.unpermute_tiled(jnp.asarray(want), tile)))
    np.testing.assert_array_equal(back[..., : shape[-2], : shape[-1]], w)


@pytest.mark.parametrize("rows,cols", [(4, 4), (5, 3), (64, 64)])
def test_index_helpers_and_pseudocode_match_reference(rows, cols):
    np.testing.assert_array_equal(permute.permutation_indices(rows, cols),
                                  ref.permutation_indices(rows, cols))
    np.testing.assert_array_equal(permute.inverse_permutation_indices(rows, cols),
                                  ref.inverse_permutation_indices(rows, cols))
    w = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    p = permute.permute_weights_np(w)
    np.testing.assert_array_equal(p, ref.permute_weights_np(w))
    np.testing.assert_array_equal(permute.unpermute_weights_np(p), w)
    if rows == cols:  # one tile: the tiled form is the paper's pseudocode
        np.testing.assert_array_equal(permute.permute_tiled(torch.from_numpy(w), rows).numpy(), p)


def test_bf16_storage_is_a_pure_relayout():
    w = torch.randn(130, 70).to(torch.bfloat16)
    p = permute.permute_tiled(w)
    assert p.dtype == torch.bfloat16 and p.shape == (192, 128)
    assert torch.equal(permute.unpermute_tiled(p)[:130, :70], w)


@pytest.mark.parametrize("shape", [(100, 130), (2, 64, 70)])
def test_dip_weight_matches_reference(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    dw = DipWeight.from_natural(torch.from_numpy(w))
    rw = RefDipWeight.from_natural(jnp.asarray(w))
    assert (dw.d_in, dw.d_out, dw.perm_tile) == (rw.d_in, rw.d_out, rw.perm_tile)
    assert dw.storage_shape == rw.storage_shape and dw.shape == rw.shape
    assert DipWeight.storage_dims(*shape[-2:]) == RefDipWeight.storage_dims(*shape[-2:])
    np.testing.assert_array_equal(dw.data.numpy(), np.asarray(rw.data))
    np.testing.assert_array_equal(dw.to_natural().numpy(), w)
    assert dw.astype(torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="quant.quantize"):  # the reference's message points there too
        dw.astype(torch.int8)
