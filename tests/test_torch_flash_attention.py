"""The port's flash-attention module against
``repro.kernels.flash_attention.flash_attention_pallas`` (interpret mode on
the CPU) on the same numpy inputs: causal masking by absolute position,
``q_offset``, ``kv_len``, fully masked rows, Dv != D, and head dim 80 at
one token (the shape Zamba2's single-token prefill tail sends to the card's
``split_kv`` route) and at 16.

Tolerances (``_torch_parity.TOL``): float32 1e-5 of max(1, max|reference|)
— the same f32 softmax arithmetic, blocked on one side and dense on the
other; bfloat16 8e-3 — plus one bf16 rounding of the output.  The card's
f32 tensor-core routes take each product as six exact bf16 part products;
that arithmetic in dense torch (``_torch_parity.attention_parts_plain``) is
held to the f32 tolerance at the reduced models' head dims and at 128.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import TOL, assert_close, attention_parts_plain
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


SPLIT_CASES = [
    # bh, sq, sk, d, dv, q_offset, kv_len, causal
    (2, 16, 40, 32, 32, 24, None, True),           # the reduced models' head dim
    (2, 8, 40, 32, 32, [0, 30], [12, 38], True),   # per-row offset and live length
    (2, 8, 24, 48, 32, 0, None, True),             # the reduced MLA pair (48, 32)
    (2, 12, 40, 48, 32, 28, [0, 40], True),        # kv_len 0: row 0 fully masked
    (2, 16, 64, 128, 128, 48, None, True),
    (2, 1, 64, 128, 128, [10, 63], [0, 64], True),  # Sq = 1 with a kv_len 0 row
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_f32_split_products_match_pallas_kernel(case):
    """f32 flash as the card's tensor-core routes take it (q k^T and p v as
    six exact bf16 part products, the softmax in f32) against the
    reference's interpret-mode kernel, within the f32 tolerance; fully
    masked rows exactly 0."""
    q, k, v = _qkv(case, "float32", seed=2)
    qo, kvl, causal = case[5:]
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  q_offset=_per_row(qo, jnp), kv_len=_per_row(kvl, jnp),
                                  causal=causal, interpret=True)
    got = attention_parts_plain(_t(q), _t(k), _t(v), q_offset=_per_row(qo, torch),
                                kv_len=_per_row(kvl, torch), causal=causal)
    assert_close(got, want, TOL["float32"])
    if isinstance(kvl, list) and 0 in kvl:
        dead = [i for i, n in enumerate(kvl) if n == 0]
        assert (got[dead] == 0).all()


@pytest.mark.parametrize("products", [3, 5, 6])
def test_f32_flash_needs_six_part_products(products):
    """Against the float64 dense attention at D = 128 over 256 keys: the
    six part products i + j <= 2 hold the f32 tolerance; five (without
    q_hi k_lo) and three miss it."""
    r = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(r.normal(size=s)) for s in ((2, 64, 128), (2, 256, 128), (2, 256, 128)))
    s = torch.einsum("bqd,bkd->bqk", q, k) * 128 ** -0.5
    s = s.masked_fill(192 + torch.arange(64).view(-1, 1) < torch.arange(256), -torch.inf)
    want = torch.softmax(s, dim=-1) @ v
    got = attention_parts_plain(q.float(), k.float(), v.float(), q_offset=192, products=products)
    if products == 6:
        assert_close(got, want, TOL["float32"])
    else:
        with pytest.raises(AssertionError, match="max.err"):
            assert_close(got, want, TOL["float32"])
