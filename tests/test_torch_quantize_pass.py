"""The int8 route's quantizing pass (``kernels/dip_matmul_q.py::
quantize_pass_plain``, whose CUDA kernel is ``quantize_int8_kernel`` in
``csrc/dip_matmul_q.cu``) against the JAX reference's ``prologue.kernel_load``
and ``ref.quantize_acts_int8`` on the same numpy inputs, byte for byte.

The pass computes ``y = cast((x * inv_rms) * gain)`` to x's dtype (or ``y =
x`` without the prologue), then ``scale = max(max|y|, 1e-8) / 127`` and
``codes = clamp(round_half_even(y / scale), -127, 127)``.  Both sides get
the same ``inv_rms`` (the two frameworks' own reductions may differ in the
last bit, which is the prologue's business, not the pass's), so codes and
scales must agree exactly: tolerance 0.  The rows cover an all-zero row
(the floor scale), values at exact .5 code midpoints (round half to even),
and the extremes of a row landing on +127 and -127.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import prologue as ref_pro
from repro.kernels import ref as ref_kernels
from repro_torch.kernels.dip_matmul_q import quantize_pass, quantize_pass_plain

M, K = 12, 128


def _rows(seed):
    """(M, K) float32: random rows of several magnitudes, an all-zero row,
    a row of amax 127 (scale exactly 1) holding every half-integer
    midpoint in [-8.5, 8.5], and rows whose extremes are +amax and -amax."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=(M, K)) * r.choice([1e-3, 1.0, 30.0], size=(M, 1))).astype(np.float32)
    x[1] = 0.0
    mids = np.arange(-8.5, 9.0, 1.0, dtype=np.float32)
    x[2] = np.resize(mids, K)
    x[2, 0], x[2, 1] = 127.0, -127.0
    x[3, 5], x[3, 6] = 50.0, -50.0
    x[4, :] = 1e-9  # amax under the 1e-8 floor
    return x


def _reference(x, dtype, inv, gain):
    xj = jnp.asarray(x).astype(dtype)
    y = ref_pro.kernel_load("rmsnorm", xj, (jnp.asarray(inv), jnp.asarray(gain))) if gain is not None else xj
    q, s = ref_kernels.quantize_acts_int8(y)
    return np.asarray(q), np.asarray(s).reshape(-1)


@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pass_matches_reference_byte_for_byte(dtype, prologue):
    x = _rows(0)
    inv = gain = None
    if prologue == "rmsnorm":
        r = np.random.default_rng(1)
        inv = (r.random((M, 1)) + 0.5).astype(np.float32)
        gain = (r.random(K) + 0.5).astype(np.float32)
        inv[2] = 1.0  # the midpoint row passes through the prologue unchanged
        gain[:] = np.where(np.arange(K) % 2 == 0, gain, 1.0).astype(np.float32)
    want_q, want_s = _reference(x, dtype, inv, gain)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    to_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got_q, got_s = quantize_pass_plain(xt, to_t(inv), to_t(gain))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32 and got_s.shape == (M,)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # the CPU wrapper is the plain version
    cq, cs = quantize_pass(xt, to_t(inv), to_t(gain))
    assert torch.equal(cq, got_q) and torch.equal(cs, got_s)


def test_quantize_pass_rows_of_note():
    """The rows the pass must get right, read off the plain version: zeros
    give zero codes at the floor scale 1e-8 / 127, a scale of exactly 1
    rounds every midpoint to its even neighbour, and a row's extremes land
    on +127 and -127 (never -128)."""
    x = torch.from_numpy(_rows(0))
    q, s = quantize_pass_plain(x)
    assert torch.equal(q[1], torch.zeros(K, dtype=torch.int8))
    assert s[1].item() == np.float32(np.float32(1e-8) / np.float32(127.0))
    assert s[2].item() == 1.0
    mids = x[2, 2:]
    assert torch.equal(q[2, 2:].float(), torch.round(mids)) and bool((q[2, 2:] % 2 == 0).all())
    assert (q[2, 0].item(), q[2, 1].item()) == (127, -127)
    assert (q[3, 5].item(), q[3, 6].item()) == (127, -127)
    assert int(q.min()) >= -127
