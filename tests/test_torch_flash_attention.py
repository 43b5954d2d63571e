"""The port's flash-attention module against
``repro.kernels.flash_attention.flash_attention_pallas`` (interpret mode on
the CPU) on the same numpy inputs: causal masking by absolute position,
``q_offset``, ``kv_len``, fully masked rows, Dv != D, and head dim 80 at
one token (the shape Zamba2's single-token prefill tail sends to the card's
``split_kv`` route) and at 16.

Tolerances (``_torch_parity.TOL``): float32 1e-5 of max(1, max|reference|)
— the same f32 softmax arithmetic, blocked on one side and dense on the
other; bfloat16 8e-3 — plus one bf16 rounding of the output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import TOL, assert_close
from repro.api import attention as ref_attention_fn
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch import api
from repro_torch.kernels.flash_attention import attention_plain, flash_attention

CASES = [
    # bh, sq, sk, d, dv, q_offset, kv_len, causal
    (2, 16, 16, 32, 32, None, None, True),
    (3, 8, 40, 32, 32, 24, None, True),            # chunked prefill: q after 24 cached keys
    (2, 8, 40, 32, 32, [0, 30], [12, 38], True),   # per-row offset and live length
    (2, 8, 24, 48, 32, 0, None, True),             # Dv != D
    (2, 5, 20, 16, 16, 4, [0, 3], True),           # kv_len 0: row 0 fully masked
    (2, 12, 20, 16, 16, None, 9, False),
    # D = 80, Zamba2's shared block (the tensor-core head dims' shapes)
    (2, 1, 96, 80, 80, 70, 71, True),              # one token of the prefill tail
    (3, 16, 128, 80, 80, [0, 40, 100], [16, 0, 116], True),  # Sq = 16; kv_len 0: row 1 fully masked
    (2, 1, 64, 80, 80, [10, 63], [0, 64], True),   # Sq = 1 with a kv_len 0 row
]


def _qkv(case, dtype, seed=0):
    bh, sq, sk, d, dv = case[:5]
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=s).astype(dtype) for s in ((bh, sq, d), (bh, sk, d), (bh, sk, dv)))


def _per_row(v, lib):
    if isinstance(v, list):
        return lib.asarray(np.asarray(v, np.int32)) if lib is jnp else torch.tensor(v, dtype=torch.int32)
    return v


def _t(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_flash_matches_pallas_kernel(case, dtype):
    q, k, v = _qkv(case, dtype)
    qo, kvl, causal = case[5:]
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  q_offset=_per_row(qo, jnp), kv_len=_per_row(kvl, jnp),
                                  causal=causal, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), q_offset=_per_row(qo, torch),
                          kv_len=_per_row(kvl, torch), causal=causal)
    assert got.dtype == _t(q).dtype
    assert_close(got, want, TOL[dtype])
    if kvl is not None and isinstance(kvl, list) and 0 in kvl:
        dead = [i for i, n in enumerate(kvl) if n == 0]
        assert (got[dead] == 0).all() and (np.asarray(want)[dead] == 0).all()


@pytest.mark.parametrize("case", CASES[:3])
def test_dense_oracle_matches_reference_oracle(case):
    q, k, v = _qkv(case, "float32", seed=1)
    qo, kvl, causal = case[5:]
    want = ref_attention_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), backend="xla",
                                   q_offset=_per_row(qo, jnp), kv_len=_per_row(kvl, jnp), causal=causal)
    got = api.attention(_t(q), _t(k), _t(v), backend="dense", q_offset=_per_row(qo, torch),
                        kv_len=_per_row(kvl, torch), causal=causal)
    assert_close(got, want, TOL["float32"])


def test_flash_on_cpu_is_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(CASES[1], "float32"))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v, q_offset=24), attention_plain(q, k, v, q_offset=24),
                               rtol=0, atol=0)
    assert flash_attention.launches == before


def test_q_offset_device_scalar_and_validation():
    q, k, v = (torch.from_numpy(a) for a in _qkv(CASES[1], "float32"))
    a = flash_attention(q, k, v, q_offset=torch.tensor(24))
    b = flash_attention(q, k, v, q_offset=torch.tensor([24, 24, 24]))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="per-row"):
        flash_attention(q, k, v, q_offset=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k[:, :, :16], v)
    with pytest.raises(ValueError, match="unknown attention backend"):
        api.attention(q, k, v, backend="nope")
