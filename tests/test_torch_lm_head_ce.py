"""The port's fused lm_head + cross-entropy against ``repro.kernels.lm_head_ce``
on the same numpy inputs.

The reference runs ``lm_head_ce_pallas`` in interpret mode on the CPU
(``api.default_interpret``); the port's ``lm_head_ce`` runs its plain version
for CPU tensors and its chunked-recompute backward.  Shapes cover ragged T,
vocab padding (``vocab_size`` < Vp, with whole padding-only chunks), labels
at -100, a ``mask``, and x in bf16 against an f32 head (the training
dtypes).  Tolerance: f32 1e-5 of max(1, max|reference|) — both sides form
the same f32 products (a bf16 x widens exactly) and differ only in the
order of the sums.  The card's f32 x f32 route sums six exact bf16 part
products of each element product; its arithmetic in plain torch
(``_bf16_parts.split_matmul``, ``_torch_parity.lm_head_ce_parts_plain``) is
held to the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import TOL, assert_close, lm_head_ce_parts_plain
from repro import api as ref_api
from repro.kernels import lm_head_ce as ref_ce
from repro_torch.kernels import _bf16_parts as bp
from repro_torch.kernels import _build
from repro_torch.kernels import lm_head_ce as ce

F32 = TOL["float32"]
T, D, VP, VOCAB = 37, 96, 1280, 300  # ragged T; chunks past 300 are all padding


def _inputs(x_dtype, seed=0, t=T, d=D, vp=VP, vocab=VOCAB):
    r = np.random.default_rng(seed)
    x = r.normal(size=(t, d)).astype(np.float32)
    w = (r.normal(size=(d, vp)) / np.sqrt(d)).astype(np.float32)
    labels = r.integers(0, vocab, size=t).astype(np.int32)
    labels[[1, 7, t // 2]] = ce.IGNORE_INDEX
    mask = (r.random(t) > 0.2).astype(np.int32)
    x = x.astype(jnp.bfloat16) if x_dtype == "bfloat16" else x
    return x, w, labels, mask


def _t(a, requires_grad=False):
    a = np.asarray(a)
    t = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) if a.dtype.name == "bfloat16"
         else torch.from_numpy(np.array(a)))
    return t.requires_grad_(requires_grad)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_logz_and_label_match_pallas_kernel(x_dtype):
    x, w, labels, _ = _inputs(x_dtype)
    want_z, want_l = ref_ce.lm_head_ce_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                              vocab_size=VOCAB, interpret=ref_api.default_interpret())
    got_z, got_l = ce.lm_head_ce(_t(x), _t(w), _t(labels), vocab_size=VOCAB)
    assert got_z.dtype == got_l.dtype == torch.float32 and got_z.shape == (T,)
    assert_close(got_z, want_z, F32)
    assert_close(got_l, want_l, F32)
    assert (got_l[torch.from_numpy(labels == ce.IGNORE_INDEX)] == 0).all()


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_fused_loss_and_grads_match_reference(x_dtype, use_mask):
    x, w, labels, mask = _inputs(x_dtype, seed=1)
    m = mask if use_mask else None

    def ref_loss(xx, ww):
        return ref_ce.fused_cross_entropy_loss(
            xx, ww, jnp.asarray(labels), mask=None if m is None else jnp.asarray(m),
            vocab_size=VOCAB, interpret=ref_api.default_interpret())

    want, (want_dx, want_dw) = jax.value_and_grad(ref_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    got = ce.fused_cross_entropy_loss(tx, tw, _t(labels), mask=None if m is None else _t(m),
                                      vocab_size=VOCAB)
    dx, dw = torch.autograd.grad(got, (tx, tw))
    assert dx.dtype == tx.dtype and dw.dtype == torch.float32
    assert_close(got, want, F32)
    assert_close(dx, want_dx, F32)
    assert_close(dw, want_dw, F32)
    assert not dw[:, VOCAB:].any(), "padding columns get no gradient"
    # the unfused oracle on both sides agrees with the fused value
    oracle = ref_ce.reference_lm_head_ce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                         mask=None if m is None else jnp.asarray(m), vocab_size=VOCAB)
    assert_close(ce.reference_lm_head_ce(_t(x), _t(w), _t(labels), mask=None if m is None else _t(m),
                                         vocab_size=VOCAB), oracle, F32)
    assert_close(got, oracle, F32)


def test_leading_dims_and_no_valid_token():
    x, w, labels, _ = _inputs("float32", seed=2, t=12)
    x3, lab3 = x.reshape(2, 6, D), labels.reshape(2, 6)
    want = ref_ce.fused_cross_entropy_loss(jnp.asarray(x3), jnp.asarray(w), jnp.asarray(lab3),
                                           vocab_size=VOCAB, interpret=ref_api.default_interpret())
    assert_close(ce.fused_cross_entropy_loss(_t(x3), _t(w), _t(lab3), vocab_size=VOCAB), want, F32)
    none_valid = torch.full((2, 6), ce.IGNORE_INDEX, dtype=torch.int32)
    assert float(ce.fused_cross_entropy_loss(_t(x3), _t(w), none_valid, vocab_size=VOCAB)) == 0.0


def test_plain_version_chunk_size_does_not_matter():
    x, w, labels, _ = _inputs("float32", seed=3)
    a = ce.lm_head_ce_plain(_t(x), _t(w), _t(labels), vocab_size=VOCAB, block_v=128)
    b = ce.lm_head_ce_plain(_t(x), _t(w), _t(labels), vocab_size=VOCAB, block_v=VP)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t,vocab,padding_splits", [(4092, 128256, 2), (37, 128256, 3), (1, 128256, 3),
                                                    (300, 128256, 6), (4092, 129024, 0), (37, 1000, 1000)])
def test_split_plan_covers_the_vocab_and_isolates_padding(t, vocab, padding_splits):
    """llama3-8b's head: vocab 128256 padded to 129024 (1002 real 128-column
    tiles, 6 of padding).  The splits cover every tile once, in order; each
    is wholly real or wholly padding (the l = 0 case of the kernel's merge),
    and at the training shape the real blocks fill whole waves of 132."""
    vp, sms = 129024, 132
    tiles, splits = ce.split_plan(t, vp, sms, vocab)
    n_tiles, n_real = vp // ce.BLOCK_V, -(-vocab // ce.BLOCK_V)
    assert tiles * splits >= n_tiles > tiles * (splits - 1)
    assert splits <= 65535
    padding = [s * tiles >= n_real for s in range(splits)]
    assert sum(padding) == padding_splits
    for s in range(splits):  # no split mixes real and padding tiles
        assert padding[s] or (s + 1) * tiles <= n_real
    if t == 4092 and vocab == 128256:
        real_blocks = -(-t // ce.BLOCK_T) * (splits - padding_splits)
        assert real_blocks / (-(-real_blocks // sms) * sms) > 0.98


@pytest.mark.parametrize("d,vp,vocab", [(2048, 102400, 102400), (2560, 32768, 32000), (1024, 51200, 50280),
                                        (1536, 2048, 2048)])
def test_split_plan_at_the_families_training_heads(d, vp, vocab):
    """DeepSeek-V2-Lite's, Zamba2's, Mamba2's (tied) and musicgen-medium's
    heads at the training batch's T = 4092: the kernel steps them, the
    splits cover every tile once under the grid limit, and a split is
    wholly real or wholly padding (Zamba2's 768 and Mamba2's 920 padded
    columns are masked by whole splits)."""
    ce.check_kernel_shape(d, vp)
    tiles, splits = ce.split_plan(4092, vp, 132, vocab)
    n_tiles, n_real = vp // ce.BLOCK_V, -(-vocab // ce.BLOCK_V)
    assert tiles * splits >= n_tiles > tiles * (splits - 1) and splits <= 65535
    for s in range(splits):
        assert s * tiles >= n_real or (s + 1) * tiles <= n_real


def test_wrapper_checks_shapes():
    x, w, labels, _ = _inputs("float32")
    with pytest.raises(ValueError, match="contraction"):
        ce.lm_head_ce(_t(x)[:, :10], _t(w), _t(labels), vocab_size=VOCAB)
    with pytest.raises(ValueError, match="labels"):
        ce.lm_head_ce(_t(x), _t(w), _t(labels)[:5], vocab_size=VOCAB)
    with pytest.raises(ValueError, match="vocab_size"):
        ce.lm_head_ce(_t(x), _t(w), _t(labels), vocab_size=VP + 1)


def test_card_path_refuses_a_gradient_it_cannot_give():
    """The CUDA paths of the forward-only kernels (flash attention, a bare
    DiP launch) call this check before they launch: with grad mode on, an
    input that requires grad raises instead of losing its gradient."""
    q = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("flash_attention", q, torch.zeros(2, 3))
    with torch.no_grad():
        _build.refuse_grad("flash_attention", q)
    _build.refuse_grad("flash_attention", q.detach(), None)


@pytest.mark.parametrize("d,vp,ok", [(4096, 129024, True), (64, 2048, True), (4100, 129024, False),
                                     (4096, 129000, False)])
def test_card_path_refuses_shapes_the_kernel_does_not_step(d, vp, ok):
    """The kernel steps D by 32 and the head by 128 columns; the CUDA path
    checks that before it launches rather than padding a copy of the head."""
    if ok:
        ce.check_kernel_shape(d, vp)
    else:
        with pytest.raises(ValueError, match="lm_head_ce kernel needs"):
            ce.check_kernel_shape(d, vp)


@pytest.mark.parametrize("lo_exp,hi_exp", [(-100, -60), (-30, 30), (60, 100)])
def test_bf16_parts_sum_to_the_head_exactly(lo_exp, hi_exp):
    """The kernel's split of an f32 head element into three bf16 parts
    (truncations of w, of w - hi and of w - hi - mid) sums back to w with
    no rounding, for finite normal f32 of any sign across the exponent
    range; two parts leave less than 2^-15 of |w|."""
    r = np.random.default_rng(7)
    mant = r.uniform(1.0, 2.0, size=20000) * r.choice([-1.0, 1.0], size=20000)
    w = torch.from_numpy((mant * 2.0 ** r.integers(lo_exp, hi_exp, size=20000)).astype(np.float32))
    hi, mid, lo = ce.bf16_parts(w, 3)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), w)
    assert torch.equal(hi.float() + mid.float() + lo.float(), w)
    two = sum(p.float() for p in ce.bf16_parts(w, 2))
    assert ((two - w).abs() < w.abs() * 2.0 ** -15).all()


@pytest.mark.parametrize("parts", [3, 2])
def test_split_product_of_bf16_x_matches_the_f32_product(parts):
    """At the training width D = 4096: bf16 x times the parts, each part
    product exact in f32, summed smallest part first as the kernel
    accumulates them, gives the f32 product x @ w within TOL["float32"] of
    max(1, max|x @ w|); two parts are held to the same tolerance here, on
    the card the label logit of llama3-8b's head needs three
    (chip_smoke.py phase 2 prints both)."""
    r = np.random.default_rng(11)
    d, v = 4096, 256
    x = torch.from_numpy(r.normal(size=(64, d)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((r.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32))
    want = x.double() @ w.double()
    got = torch.zeros(64, v, dtype=torch.float32)
    for part in reversed(ce.bf16_parts(w, parts)):
        got = got + x.float() @ part.float()
    assert_close(got, want.float(), F32)
    assert_close(x.float() @ w, want.float(), F32)


def test_f32_split_products_match_pallas_kernel():
    """f32 x against the f32 head as the card takes it (both split into
    three bf16 parts, the six part products i + j <= 2 of each element
    product): logz and the label logit against the reference's
    interpret-mode kernel, at the ragged T and the padded vocab above."""
    x, w, labels, _ = _inputs("float32", seed=4)
    want_z, want_l = ref_ce.lm_head_ce_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                              vocab_size=VOCAB, interpret=ref_api.default_interpret())
    got_z, got_l = lm_head_ce_parts_plain(_t(x), _t(w), _t(labels), VOCAB, products=ce.F32_PRODUCTS)
    assert_close(got_z, want_z, F32)
    assert_close(got_l, want_l, F32)
    assert (got_l[torch.from_numpy(labels == ce.IGNORE_INDEX)] == 0).all()


@pytest.mark.parametrize("products", [1, 3, 6])
def test_split_product_of_f32_x_matches_the_f32_product(products):
    """At the training width D = 4096, f32 x against the f32 head as the
    kernel sums them (both split into bf16 parts, each part product exact
    in f32, the products smallest first from zero over each 32-deep step,
    added to an f32 total), against the float64 product: the six products
    i + j <= 2 are within TOL["float32"] of max(1, max|x @ w|), as close as
    the f32 product itself; three (i + j <= 1) and one miss it.  (Five,
    without x_hi w_lo, land at 0.92 of TOL here: no margin.)"""
    r = np.random.default_rng(11)
    d, v = 4096, 256
    x = torch.from_numpy(r.normal(size=(64, d)).astype(np.float32))
    w = torch.from_numpy((r.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32))
    want = (x.double() @ w.double()).float()
    got = bp.split_matmul(x, w, products, step=ce.BLOCK_K_F32)
    if products == ce.F32_PRODUCTS:
        assert_close(got, want, F32)
        assert (got - want).abs().max() <= 4 * (x @ w - want).abs().max()
    else:
        with pytest.raises(AssertionError, match="max.err"):
            assert_close(got, want, F32)


def test_part_products_are_the_largest_smallest_first():
    """The kernels' order: a_i b_j is about 2^-8(i + j) of a b; the first n
    by size, summed smallest first, hi x hi last."""
    assert bp.part_products(6) == ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))
    assert bp.part_products(3) == ((0, 1), (1, 0), (0, 0))
    assert bp.part_products(1) == ((0, 0),)
    assert all(i + j <= 2 for i, j in bp.part_products(ce.F32_PRODUCTS))
    with pytest.raises(ValueError, match="part products"):
        bp.part_products(7)
