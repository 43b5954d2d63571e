"""The fp8 route's cast pass for f32 activations (``kernels/dip_matmul_q.py::
cast_pass_plain``, whose CUDA kernel is ``cast_bf16_kernel`` in
``csrc/dip_matmul_q.cu``) against the JAX reference's ``prologue.kernel_load``
followed by ``astype(bfloat16)`` on the same numpy inputs, byte for byte.

With fp8 weights the reference multiplies at ``fp8_compute_dtype``, bf16 on a
GPU, so f32 x is cast to bf16 before the product; with the rmsnorm prologue
the cast follows ``(x * inv_rms) * gain`` in f32.  The pass writes exactly
that, rounded to nearest even once.  Both sides get the same ``inv_rms``, so
the bf16 bytes must agree exactly: tolerance 0.  The rows cover an all-zero
row, f32 values at exact bf16 rounding midpoints (ties to even) and one f32
ulp either side of them, and magnitudes from 1e-30 to 1e30.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import prologue as ref_pro
from repro_torch.kernels.dip_matmul_q import cast_pass, cast_pass_plain

SHAPES = [(12, 128), (1, 64), (37, 256)]


def _rows(seed, m, k):
    """(M, K) float32: random rows of several magnitudes, an all-zero row
    and (where M allows) a row of exact bf16 midpoints and a row of their
    f32 neighbours."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=(m, k)) * r.choice([1e-30, 1e-3, 1.0, 30.0, 1e30], size=(m, 1))).astype(np.float32)
    if m >= 4:
        x[1] = 0.0
        # a bf16 value's f32 bits plus half a bf16 step: a tie, which goes
        # to the even neighbour; then one f32 ulp below and above the tie
        base = (r.integers(0x3C00, 0x4400, size=k, dtype=np.uint32) | (r.integers(0, 2, size=k) << 15)
                .astype(np.uint32)) << 16
        ties = base + 0x8000
        x[2] = ties.view(np.float32)
        x[3] = np.where(np.arange(k) % 2 == 0, ties - 1, ties + 1).astype(np.uint32).view(np.float32)
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _reference(x, inv, gain):
    xj = jnp.asarray(x)
    y = ref_pro.kernel_load("rmsnorm", xj, (jnp.asarray(inv), jnp.asarray(gain))) if gain is not None else xj
    return np.asarray(y.astype(jnp.bfloat16)).view(np.uint16)


@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("m,k", SHAPES)
def test_cast_pass_matches_reference_byte_for_byte(m, k, prologue):
    x = _rows(m * k, m, k)
    inv = gain = None
    if prologue == "rmsnorm":
        r = np.random.default_rng(1)
        inv = (r.random((m, 1)) + 0.5).astype(np.float32)
        gain = (r.random(k) + 0.5).astype(np.float32)
        if m >= 4:
            inv[2:4] = 1.0  # the midpoint rows pass through the prologue unchanged
            gain[:] = np.where(np.arange(k) % 2 == 0, gain, 1.0).astype(np.float32)
    want = _reference(x, inv, gain)
    to_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = cast_pass_plain(torch.from_numpy(x), to_t(inv), to_t(gain))
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    np.testing.assert_array_equal(_bits(got), want)
    # the CPU wrapper is the plain version
    assert torch.equal(cast_pass(torch.from_numpy(x), to_t(inv), to_t(gain)).view(torch.int16), got.view(torch.int16))


def test_cast_pass_rows_of_note():
    """Read off the plain version: zeros stay +0, a tie goes to the even
    bf16 neighbour (its last mantissa bit 0), and one f32 ulp either side
    of a tie goes to the nearer neighbour."""
    m, k = 12, 128
    x = torch.from_numpy(_rows(0, m, k))
    got = _bits(cast_pass_plain(x))
    assert (got[1] == 0).all()
    ties = x[2].numpy().view(np.uint32)
    down, up = ties >> 16, (ties >> 16) + 1
    assert (got[2] == np.where(down % 2 == 0, down, up)).all() and (got[2] % 2 == 0).all()
    near = x[3].numpy().view(np.uint32)
    assert (got[3] == np.where(np.arange(k) % 2 == 0, down, up)).all() and (near >> 16 == down).all()
