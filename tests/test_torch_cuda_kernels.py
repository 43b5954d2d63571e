"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (the kernels have no CPU mode).  On an H100 run them with
``python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.

Tolerances, relative to the largest |value| of the plain result:
float32 1e-5 — both sides multiply the same f32 operands in IEEE f32 (no
TF32) and differ only in summation order; bfloat16 8e-3 — both sides
accumulate the same bf16 operands in f32, so the outputs differ by at most
about one bf16 rounding step (2^-8) after the final cast.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core import permute
from repro_torch.device import make_generator
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels.dip_matmul import dip_matmul, dip_matmul_plain
from repro_torch.kernels.flash_attention import SPLIT_MAX_SQ, TC_PAIRS, attention_plain, flash_attention, flash_plan
from repro_torch.kernels import lm_head_ce as ce
from repro_torch.models import transformer as tf_model
from repro_torch.optim import AdamW

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= TOL[dtype] * scale, f"max|err| {err} > {TOL[dtype]} * {scale}"


def _operands(epilogue, m, k, n, dtype, dev, g):
    s = epi.spec(epilogue)
    if s.dual_weight:
        return (torch.randn(k, n, generator=g, device=dev).to(dtype),)
    if s.bias:
        return (torch.randn(n, generator=g, device=dev),)
    if s.residual:
        return (torch.randn(m, n, generator=g, device=dev).to(dtype),)
    return ()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("m", [4, 100])
@pytest.mark.parametrize("deshear", [True, False])
def test_dip_matmul_kernel_matches_plain(dev, dtype, epilogue, prologue, m, deshear):
    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 192, 128
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    p = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype)
    eops = _operands(epilogue, m, k, n, dtype, dev, g)
    if epi.spec(epilogue).dual_weight:
        eops = ((eops[0] / k ** 0.5).to(dtype),)
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops, prologue_k=k - 7,
              fuse_deshear=deshear)
    before = dip_matmul.launches
    got = dip_matmul(x, p, *eops, **kw)
    assert dip_matmul.launches == before + 1
    want = dip_matmul_plain(x, p, *eops, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, n)
    _close(got, want, dtype)


def test_dip_kernel_deshear_is_the_inverse_permutation(dev):
    """Identity x: the kernel's output IS the de-sheared weight."""
    w = torch.randn(128, 192, device=dev)
    p = permute.permute_tiled(w)
    eye = torch.eye(128, device=dev)
    torch.testing.assert_close(dip_matmul(eye, p), w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registry_shim_ragged_on_card_matches_cpu(dev, dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 37, 100, generator=g).to(dtype)
    w = (torch.randn(100, 70, generator=g) / 10).to(dtype)
    gain = torch.rand(100, generator=g) + 0.5
    res = torch.randn(2, 37, 70, generator=g).to(dtype)
    dw = api.DipWeight.from_natural(w)
    kw = dict(backend="dip", epilogue="residual", epilogue_operands=(res,), prologue="rmsnorm",
              prologue_operands=(gain,))
    want = api.matmul(x, dw, **kw)
    got = api.matmul(x.to(dev), dw.with_data(dw.data.to(dev)),
                     **dict(kw, epilogue_operands=(res.to(dev),), prologue_operands=(gain.to(dev),)))
    _close(got.cpu(), want, dtype)


FLASH_CASES = [
    # bh, sq, sk, d, dv, q_offset, kv_len, causal
    (3, 70, 200, 64, 64, 0, None, True),
    (2, 64, 160, 128, 128, 96, 140, True),
    (2, 40, 100, 48, 32, 0, 30, True),       # Dv != D; rows past kv_len
    (2, 33, 50, 64, 64, 10, 0, True),        # kv_len 0: every row fully masked
    (2, 33, 50, 64, 64, 0, 45, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, dtype, case):
    bh, sq, sk, d, dv, qo, kvl, causal = case
    g = torch.Generator(device=dev).manual_seed(sq)
    q = torch.randn(bh, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(bh, sk, dv, generator=g, device=dev).to(dtype)
    kw = dict(q_offset=torch.tensor(qo, device=dev), kv_len=kvl, causal=causal)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    want = attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(got, want, dtype)
    if kvl == 0:
        assert (got == 0).all(), "fully masked rows must be exactly 0"


def test_reduced_model_card_matches_cpu(dev):
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip",
                              compute_dtype="float32")
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu")
    on_card = _to(params, dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(2, 512, (2, 24)))
    want, _ = tf_model.forward(params, cfg, tokens=tokens)
    got, _ = tf_model.forward(on_card, cfg, tokens=tokens.to(dev), attn_backend="flash")
    _close(got.cpu(), want, torch.float32)


LM_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
            (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("pair", LM_PAIRS, ids=["f32xf32", "bf16xf32", "bf16xbf16"])
@pytest.mark.parametrize("t", [37, 300, 4092])
def test_lm_head_ce_kernel_matches_plain(dev, pair, t):
    """Ragged T, vocab padding with whole padding-only splits, labels at
    -100.  f32 1e-5 where W is f32 (the tensor cores on three bf16 parts of
    W, each part product exact in f32; for f32 x, x split too and the six
    part products i + j <= 2), 8e-3 for bf16 x bf16 (tensor-core
    accumulation), of max(1, max|plain|)."""
    xd, wd = pair
    g = torch.Generator(device=dev).manual_seed(t)
    d, vp, vocab = 256, 2048, 1500
    x = torch.randn(t, d, generator=g, device=dev).to(xd)
    w = (torch.randn(d, vp, generator=g, device=dev) / d ** 0.5).to(wd)
    labels = torch.randint(0, vocab, (t,), generator=g, device=dev, dtype=torch.int32)
    labels[::7] = ce.IGNORE_INDEX
    tiles, splits = ce.split_plan(t, vp, torch.cuda.get_device_properties(dev).multi_processor_count, vocab)
    assert (splits - 1) * tiles * ce.BLOCK_V >= vocab, "a split lies wholly in the padding"
    before = ce.lm_head_ce.launches
    with torch.no_grad():
        got = ce.lm_head_ce(x, w, labels, vocab_size=vocab)
    assert ce.lm_head_ce.launches == before + 1
    want = ce.lm_head_ce_plain(x, w, labels, vocab_size=vocab)
    torch.cuda.synchronize()
    tol = torch.bfloat16 if wd == torch.bfloat16 else torch.float32
    for a, b in zip(got, want):
        _close(a, b, tol)
    assert (got[1][labels == ce.IGNORE_INDEX] == 0).all()


def test_fused_loss_gradients_card_match_cpu(dev):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(45, 128, generator=g)
    w = torch.randn(128, 1024, generator=g) / 128 ** 0.5
    labels = torch.randint(0, 700, (45,), generator=g, dtype=torch.int32)
    out = {}
    for where in ("cpu", "cuda"):
        tx, tw = x.to(where).requires_grad_(), w.to(where).requires_grad_()
        loss = ce.fused_cross_entropy_loss(tx, tw, labels.to(where), vocab_size=700)
        out[where] = (loss,) + torch.autograd.grad(loss, (tx, tw))
    for a, b in zip(out["cuda"], out["cpu"]):
        _close(a.cpu(), b, torch.float32)


@pytest.mark.parametrize("epilogue", ["swiglu", "residual", "bias_gelu"])
def test_dip_dispatch_gradients_card_match_cpu(dev, epilogue):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 37, 100, generator=g)
    ws = [api.DipWeight.from_natural(torch.randn(100, 70, generator=g) / 10) for _ in range(2)]
    gain = torch.rand(100, generator=g) + 0.5
    s = epi.spec(epilogue)
    op = torch.randn(70, generator=g) if s.bias else torch.randn(2, 37, 70, generator=g)
    out = {}
    for where in ("cpu", "cuda"):
        leaves = [t.to(where).requires_grad_() for t in (x, ws[0].data, ws[1].data, gain, op)]
        wt = [w.with_data(d) for w, d in zip(ws, leaves[1:3])]
        y = api.matmul(leaves[0], tuple(wt) if s.dual_weight else wt[0], backend="dip", epilogue=epilogue,
                       epilogue_operands=() if s.dual_weight else (leaves[4],), prologue="rmsnorm",
                       prologue_operands=(leaves[3],))
        used = [t for i, t in enumerate(leaves) if not (i == 2 and not s.dual_weight)
                and not (i == 4 and s.dual_weight)]
        out[where] = (y,) + torch.autograd.grad(y.square().sum(), used)
    for a, b in zip(out["cuda"], out["cpu"]):
        _close(a.detach().cpu(), b.detach(), torch.float32)


def test_forward_only_kernels_refuse_a_gradient(dev):
    q = torch.randn(2, 8, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q.detach(), q.detach())
    with pytest.raises(RuntimeError, match="no backward"):
        dip_matmul(torch.randn(4, 64, device=dev, requires_grad=True), torch.randn(64, 64, device=dev))


def test_reduced_train_step_card_matches_cpu(dev):
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip",
                              compute_dtype="float32")
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(2, 512, (2, 24)))
    metrics = {}
    for where, p in (("cuda", _to(params, dev)), ("cpu", params)):
        opt = AdamW(lr=1e-3)
        state = {"params": p, "opt_state": opt.init(p), "step": 0}
        before = (dip_matmul.launches, ce.lm_head_ce.launches)
        _, metrics[where] = tf_model.train_step_fn(cfg, opt)(state, {"tokens": toks.to(where),
                                                                     "labels": toks.to(where)})
        if where == "cuda":
            assert (dip_matmul.launches - before[0], ce.lm_head_ce.launches - before[1]) == (
                6 * cfg.n_layers, 1)
    for k in ("loss", "grad_norm"):
        _close(metrics["cuda"][k].cpu(), metrics["cpu"][k], torch.float32)


def _to(t, dev):
    if isinstance(t, dict):
        return {k: _to(v, dev) for k, v in t.items()}
    if isinstance(t, api.DipWeight):
        return t.with_data(t.data.to(dev))
    return t.to(dev)


# ------------------------------------------- quantized serving slice -------
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("m", [4, 100])
@pytest.mark.parametrize("deshear", [True, False])
def test_dip_matmul_int8_kernel_is_exact(dev, epilogue, m, deshear):
    """int8 x int8 accumulates exactly in int32 on the tensor cores: no
    epilogue gives the int32 sums bit for bit, an epilogue their f32 image."""
    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 1088, 128
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    p = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = epi.spec(epilogue)
    eops = ((torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8),) if s.dual_weight else
            (torch.randn(n, generator=g, device=dev) * 1e4,) if s.bias else
            (torch.randint(-127, 128, (m, n), generator=g, device=dev, dtype=torch.int8),) if s.residual else ())
    kw = dict(epilogue=epilogue, fuse_deshear=deshear)
    got, want = dip_matmul(x, p, *eops, **kw), dip_matmul_plain(x, p, *eops, **kw)
    assert got.dtype == want.dtype == (torch.int32 if epilogue == "none" else torch.float32)
    if epilogue == "none":
        assert torch.equal(got, want)
    else:
        _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("m", [4, 37])
@pytest.mark.parametrize("scheme", ["int8", "fp8_e4m3"])
def test_dip_matmul_q_kernel_matches_plain(dev, scheme, m, prologue, epilogue, dtype):
    """Both sides multiply the same operands: for int8 the same activation
    codes (quantized by the same wrapper code on the card) into exact int32
    sums, for fp8 the same bf16 values into f32 sums; so the f32 tolerance
    holds for f32 outputs and one bf16 step for bf16 ones."""
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain

    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 192, 128
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    qw = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, scheme) for _ in range(2)]
    s = epi.spec(epilogue)
    eops = ((qw[1].data, qw[1].scale) if s.dual_weight else _operands(epilogue, m, k, n, dtype, dev, g))
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops, prologue_k=k - 7)
    before = dip_matmul_q.launches
    got = dip_matmul_q(x, qw[0].data, qw[0].scale, *eops, **kw)
    assert dip_matmul_q.launches == before + 1 and got.dtype == dtype
    _close(got, dip_matmul_q_plain(x, qw[0].data, qw[0].scale, *eops, **kw), dtype)


@pytest.mark.parametrize("m", [37, 256])
def test_dip_matmul_q_fp8_f32_x_long_k_holds_f32_tol(dev, m):
    """fp8 weights with f32 x: summing a whole K in the tensor cores' f32
    fragments, which round toward zero, drifts past the f32 tolerance at
    llama3-8b's down projection (K = 14336; chip_smoke.py phase 2, M = 37:
    6.2e-05 against 6.14e-05, on an earlier kernel).  The mainloops' f32
    output adds each K tile's products (decode) or every four K tiles'
    (wgmma, M = 37 and 256 here) to a running total in IEEE f32."""
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain

    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 14336, 4096
    x = torch.randn(m, k, generator=g, device=dev)
    qw = api.quant.quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, "fp8_e4m3")
    res = torch.randn(m, n, generator=g, device=dev)
    got = dip_matmul_q(x, qw.data, qw.scale, res, epilogue="residual")
    _close(got, dip_matmul_q_plain(x, qw.data, qw.scale, res, epilogue="residual"), torch.float32)


# the rmsnorm prologue normalizes float activations, so int8 runs without it
SYSTOLIC_INPUTS = [(torch.float32, "none"), (torch.float32, "rmsnorm"), (torch.bfloat16, "none"),
                   (torch.bfloat16, "rmsnorm"), (torch.int8, "none")]


@pytest.mark.parametrize("dtype,prologue", SYSTOLIC_INPUTS)
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("m", [4, 100])
def test_dip_systolic_kernel_matches_plain(dev, dtype, epilogue, prologue, m):
    from repro_torch.kernels.dip_systolic import dip_systolic, dip_systolic_plain

    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 192, 128
    if dtype == torch.int8:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        p, pu = (torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8) for _ in range(2))
        res = torch.randint(-127, 128, (m, n), generator=g, device=dev, dtype=torch.int8)
    else:
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        p, pu = ((torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype) for _ in range(2))
        res = torch.randn(m, n, generator=g, device=dev).to(dtype)
    s = epi.spec(epilogue)
    eops = (pu,) if s.dual_weight else (torch.randn(n, generator=g, device=dev),) if s.bias else (
        (res,) if s.residual else ())
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops, prologue_k=k - 7)
    before = dip_systolic.launches
    got = dip_systolic(x, p, *eops, **kw)
    want = dip_systolic_plain(x, p, *eops, **kw)
    assert dip_systolic.launches == before + 1 and got.dtype == want.dtype
    if dtype == torch.int8 and epilogue == "none":
        assert got.dtype == torch.int32 and torch.equal(got, want)
    else:
        _close(got, want, torch.float32 if dtype == torch.int8 else dtype)


@pytest.mark.parametrize("scheme,kv_quant", [("int8", "int8"), ("fp8_e4m3", "none")])
def test_reduced_quantized_model_card_matches_cpu(dev, scheme, kv_quant):
    """Same quantized weights, greedy tokens on the card and on the CPU."""
    from repro_torch.runtime import Request, Server, ServerConfig

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), quantization=scheme,
                              matmul_backend=api.quant.scheme_info(scheme).backend, kv_quant=kv_quant,
                              param_dtype="float32", compute_dtype="float32")
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")

    def to(t, d):
        if isinstance(t, dict):
            return {k: to(v, d) for k, v in t.items()}
        if isinstance(t, api.QuantizedDipWeight):
            return t.with_data(t.data.to(d), t.scale.to(d))
        return t.to(d)

    on_card = to(params, dev)
    prompts = [np.arange(2, 2 + n, dtype=np.int32) * 7 % cfg.vocab_size for n in (5, 13)]
    outs = []
    for where, p in (("cuda", on_card), ("cpu", params)):
        server = Server(cfg, ServerConfig(batch_slots=2, max_seq=48, max_new_tokens=5, temperature=0.0,
                                          prefill_chunk=8), p, device=where)
        outs.append(server.serve([Request(rid=i, prompt=q) for i, q in enumerate(prompts)]))
    assert outs[0] == outs[1]


# ------------------------------------------- Hopper redesign (bf16) --------
# The bf16 DiP matmul's two regimes (mma.sync decode tile with split-K up to
# M = 32, the wgmma prefill tile above) and flash attention's tensor-core
# route.  K = 1088 (17 tiles): at N = 4096 the decode plan splits K with a
# ragged last split, and at M = 257 the prefill block walks all 17 tiles, more
# than its ring of 4 stages; N = 192 and 320 are not multiples of the
# prefill tile's 128 columns (tests/test_torch_kernel_plans.py holds that
# these cases reach each path).
@pytest.mark.parametrize("deshear", [True, False])
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("n", [192, 320, 4096])
@pytest.mark.parametrize("m", [1, 4, 16, 100, 257])
def test_dip_matmul_bf16_plans_match_plain(dev, m, n, epilogue, prologue, deshear):
    from repro_torch.kernels.dip_matmul import matmul_plan

    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    k = 1088
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    p = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    eops = _operands(epilogue, m, k, n, torch.bfloat16, dev, g)
    if epi.spec(epilogue).dual_weight:
        eops = ((eops[0] / k ** 0.5).to(torch.bfloat16),)
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops, prologue_k=k - 7,
              fuse_deshear=deshear)
    plan = matmul_plan(m, n, k, epi.spec(epilogue).dual_weight,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    before = dip_matmul.launches
    got = dip_matmul(x, p, *eops, **kw)
    assert dip_matmul.launches == before + 1
    want = dip_matmul_plain(x, p, *eops, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n), plan
    _close(got, want, torch.bfloat16)


TC_FLASH_CASES = [
    # bh, sq, sk, d, q_offset, kv_len (None, int, or a per-row list), causal
    (3, 70, 200, 64, 0, None, True),          # Sq not a multiple of the 64-row tile
    (2, 130, 300, 128, 96, 250, True),        # q_offset > 0, rows past kv_len
    (4, 64, 256, 128, 192, [0, 256, 0, 100], True),  # kv_len 0 rows: exactly 0
    (2, 33, 150, 64, 10, 0, True),            # every row fully masked
    (2, 70, 190, 128, 0, 170, False),         # causal off
    (1, 256, 1024, 128, 512, 768, True),      # the prefill chunk's shape
    (3, 70, 200, 80, 0, None, True),          # D = 80, Zamba2's shared block
    (4, 130, 300, 80, 96, [0, 250, 300, 17], True),
    (2, 256, 1024, 80, 512, 768, True),       # D = 80 at the chunk's shape
    (2, 70, 190, 96, 30, 170, True),          # D = 96
    (2, 70, 190, 112, 30, 170, True),         # D = 112
    (3, 33, 150, 112, 0, 140, False),
]


def _flash_case(dev, bh, sq, sk, d, qo, kvl, causal, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=dev).to(torch.bfloat16) for s in (sq, sk, sk))
    # kv_len lists as int32 and q_offset as int64 tensors: the kernels read both widths
    kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev) if isinstance(kvl, list) else kvl
    return q, k, v, dict(q_offset=torch.tensor(qo, device=dev), kv_len=kv_len, causal=causal)


def _assert_dead_rows_zero(got, kvl, bh, sk):
    dead = torch.as_tensor(kvl if kvl is not None else sk).reshape(-1).expand(bh) == 0
    if dead.any():
        assert (got[dead.to(got.device)] == 0).all(), "fully masked rows must be exactly 0"


def _counters():
    return flash_attention.launches, flash_attention.launches_tc, flash_attention.launches_split


@pytest.mark.parametrize("case", TC_FLASH_CASES)
def test_flash_tensor_core_route_matches_plain(dev, case):
    """bf16 at the tensor-core head dims: Sq above SPLIT_MAX_SQ on the
    unsplit 64-row tiles, Sq = 33 and 64 on split_kv; one launch, counted
    on the tensor cores."""
    bh, sq, sk, d, qo, kvl, causal = case
    q, k, v, kw = _flash_case(dev, *case, seed=sq + d)
    route = flash_plan(bh, sq, sk, d, d, torch.bfloat16, torch.cuda.get_device_properties(dev).multi_processor_count)[0]
    assert route == ("tensor_cores" if sq > SPLIT_MAX_SQ else "split_kv")
    before = _counters()
    got = flash_attention(q, k, v, **kw)
    assert _counters() == (before[0] + 1, before[1] + 1, before[2] + (route == "split_kv"))
    want = attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _close(got, want, torch.bfloat16)
    _assert_dead_rows_zero(got, kvl, bh, sk)


SPLIT_FLASH_CASES = [
    # bh, sq, sk, d, q_offset (int or per-row list), kv_len (None, int or per-row list), causal
    (32, 1, 1024, 80, 700, 701, True),        # Zamba2's prefill tail: 4 splits, the last wholly dead
    (32, 1, 1024, 128, 700, 701, True),       # the same at D = 128
    (8, 3, 640, 80, 500, 503, True),          # Sq = 3; live keys end mid-tile
    (4, 16, 1024, 96, [0, 300, 1000, 64], None, True),  # Sq = 16, a whole query tile; causal dead splits
    (4, 16, 700, 112, 600, [0, 616, 5, 650], True),     # kv_len 0 row: exactly 0; a row ending at key 5
    (6, 1, 40, 64, 39, None, True),           # Sk below one KV tile: one split, written by the block
    (6, 5, 50, 80, 0, [0, 0, 0, 0, 0, 0], True),        # every row fully masked
    (2, 2, 900, 64, 0, 880, False),           # causal off: every split live
    (32, 1, 1024, 80, 0, 1, True),            # one live key: every split but the first wholly dead
    (4, 16, 1024, 128, 1008, 1000, True),     # 16 splits; live keys end mid-tile in the last live split
]


@pytest.mark.parametrize("case", SPLIT_FLASH_CASES)
def test_flash_split_kv_route_matches_plain(dev, case):
    """The short-query route (16-row query tiles, the keys split across
    blocks, the partials merged in the same launch by the last block of
    each query tile) against the plain version, one launch per call, fully
    masked rows exactly 0 and two calls bit for bit equal (the merge sums
    the splits in split order, whichever block finishes last)."""
    bh, sq, sk, d, qo, kvl, causal = case
    q, k, v, kw = _flash_case(dev, *case, seed=sq * 7 + d)
    route, q_tile, splits = flash_plan(bh, sq, sk, d, d, torch.bfloat16,
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
    assert (route, q_tile) == ("split_kv", 16)
    before = _counters()
    got = flash_attention(q, k, v, **kw)
    assert _counters() == (before[0] + 1, before[1] + 1, before[2] + 1)
    again = flash_attention(q, k, v, **kw)
    want = attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again), f"two calls differ ({splits} splits)"
    _close(got, want, torch.bfloat16)
    _assert_dead_rows_zero(got, kvl, bh, sk)


def test_flash_split_kv_tail_fills_one_wave(dev):
    """Zamba2's tail (BH = 32, Sq = 1, Sk = 1024) is split over the keys
    until its blocks fill one wave of this card's SMs; its chunk (Sq = 256)
    keeps 128 unsplit 64-row blocks."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    route, q_tile, splits = flash_plan(32, 1, 1024, 80, 80, torch.bfloat16, sms)
    assert route == "split_kv" and splits > 1 and sms - 32 < 32 * splits <= sms
    assert flash_plan(32, 256, 1024, 80, 80, torch.bfloat16, sms) == ("tensor_cores", 64, 1)


OLD_ROUTE_CASES = [(torch.bfloat16, 128, 64), (torch.bfloat16, 256, 256), (torch.bfloat16, 40, 24),
                   (torch.float32, 128, 64), (torch.float32, 256, 256), (torch.float32, 40, 24)]
# the cases that ran on the CUDA cores before f32 and the reduced head dims
# took the tensor cores
MOVED_ROUTE_CASES = [(torch.float32, 128, 128), (torch.float32, 64, 64), (torch.float32, 192, 128),
                     (torch.bfloat16, 48, 48)]


def _old_route_case(dev, dtype, d, dv):
    g = torch.Generator(device=dev).manual_seed(d + dv)
    q, k = (torch.randn(2, s, d, generator=g, device=dev).to(dtype) for s in (70, 150))
    v = torch.randn(2, 150, dv, generator=g, device=dev).to(dtype)
    return q, k, v, dict(q_offset=torch.tensor(40, device=dev), kv_len=120, causal=True)


@pytest.mark.parametrize("dtype,d,dv", OLD_ROUTE_CASES)
def test_flash_cuda_core_route_matches_plain(dev, dtype, d, dv):
    """The pairs no tensor-core route takes (Dv != D other than (48, 32) and
    (192, 128), D above 128, D not a multiple of 16), in both dtypes."""
    q, k, v, kw = _old_route_case(dev, dtype, d, dv)
    before = _counters()
    got = flash_attention(q, k, v, **kw)
    assert _counters() == (before[0] + 1, before[1], before[2])
    torch.cuda.synchronize()
    _close(got, attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype,d,dv", MOVED_ROUTE_CASES)
def test_flash_moved_cases_take_the_tensor_cores(dev, dtype, d, dv):
    """The CUDA-core route's former f32 cases and bf16 D = 48, at Sq = 70:
    one launch counted on the tensor cores, within TOL of plain."""
    q, k, v, kw = _old_route_case(dev, dtype, d, dv)
    before = _counters()
    got = flash_attention(q, k, v, **kw)
    assert _counters() == (before[0] + 1, before[1] + 1, before[2])
    torch.cuda.synchronize()
    _close(got, attention_plain(q, k, v, **kw), dtype)


# ------------------------- Hopper redesign: fp8 route, lm_head_ce, alignment --
# dip_matmul_q with bf16 x and e4m3 weights runs the tensor-core mainloops of
# dip_matmul.cu under matmul_plan(weight_bytes=1): K = 1088 gives a ragged
# split at decode and more K tiles than the ring at M = 257; N = 192 and 320
# are not multiples of the 128-column tiles (test_torch_kernel_plans.py holds
# that these cases reach each path).  Both sides multiply the same bf16
# values (the upcast is exact) in f32, so one bf16 step holds.
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("n", [192, 320, 4096])
@pytest.mark.parametrize("m", [1, 4, 32, 33, 257])
def test_dip_matmul_q_fp8_route_plans_match_plain(dev, m, n, epilogue, prologue):
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain

    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    k = 1088
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    qw = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, "fp8_e4m3") for _ in range(2)]
    s = epi.spec(epilogue)
    eops = (qw[1].data, qw[1].scale) if s.dual_weight else _operands(epilogue, m, k, n, torch.bfloat16, dev, g)
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops, prologue_k=k - 7)
    before = (dip_matmul_q.launches, dip_matmul_q.launches_tc)
    got = dip_matmul_q(x, qw[0].data, qw[0].scale, *eops, **kw)
    assert (dip_matmul_q.launches, dip_matmul_q.launches_tc) == (before[0] + 1, before[1] + 1)
    want = dip_matmul_q_plain(x, qw[0].data, qw[0].scale, *eops, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("m", [8, 64, 100])
def test_fp8_upcast_is_exact_for_every_code(dev, m):
    """Identity rows of x read the de-sheared, upcast weight back: every
    e4m3 code but the two NaNs, subnormals and both zeros included, on the
    decode and the prefill mainloop, bit for bit."""
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q

    codes = torch.tensor([c for c in range(256) if c not in (0x7F, 0xFF)], dtype=torch.uint8)
    nat = codes.repeat(64 * 128 // codes.numel() + 1)[:64 * 128].reshape(64, 128).view(torch.float8_e4m3fn)
    q = permute.permute_tiled(nat.float()).to(torch.float8_e4m3fn).to(dev)
    eye = torch.eye(m, 64, device=dev).to(torch.bfloat16)
    got = dip_matmul_q(eye, q, torch.ones(1, 128, device=dev))
    want = torch.eye(m, 64) @ nat.float()
    assert torch.equal(got.cpu(), want.to(torch.bfloat16))


def test_offset_views_are_refused_and_leave_the_context_usable(dev):
    """A contiguous view whose storage offset is not 16-byte aligned would
    fault in the kernels' 16-byte loads and poison the CUDA context: flash's
    tensor-core routes, lm_head_ce and dip_matmul_q refuse it before the
    launch, and the same calls on aligned tensors then run."""
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q

    g = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randn(2 * 64 * 128 + 8, generator=g, device=dev).to(torch.bfloat16)
    q = buf[1:1 + 2 * 64 * 128].view(2, 64, 128)  # 2-byte offset
    fresh = q.clone()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, fresh, fresh)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(fresh, fresh, q)
    with pytest.raises(ValueError, match="16-byte aligned"):  # Sq = 1: the split route
        flash_attention(buf[1:1 + 2 * 128].view(2, 1, 128), fresh, fresh)
    x = buf[3:3 + 37 * 256].view(37, 256)
    w = torch.randn(256, 1024, generator=g, device=dev) / 16
    w_off = torch.randn(256 * 1024 + 4, generator=g, device=dev)[1:1 + 256 * 1024].view(256, 1024)
    labels = torch.randint(0, 1000, (37,), generator=g, device=dev, dtype=torch.int32)
    with torch.no_grad():
        with pytest.raises(ValueError, match="16-byte aligned"):
            ce.lm_head_ce(x, w, labels, vocab_size=1000)
        with pytest.raises(ValueError, match="16-byte aligned"):
            ce.lm_head_ce(x.clone(), w_off, labels, vocab_size=1000)
    qw = api.quant.quantize(torch.randn(256, 128, generator=g, device=dev) / 16, "fp8_e4m3")
    with pytest.raises(ValueError, match="16-byte aligned"):
        dip_matmul_q(x[:4], qw.data, qw.scale)
    torch.cuda.synchronize()
    _close(flash_attention(fresh, fresh, fresh), attention_plain(fresh, fresh, fresh), torch.bfloat16)
    with torch.no_grad():
        got = ce.lm_head_ce(x.clone(), w, labels, vocab_size=1000)
    for a, b in zip(got, ce.lm_head_ce_plain(x.clone(), w, labels, vocab_size=1000)):
        _close(a, b, torch.float32)
    torch.cuda.synchronize()


# ------------------- Hopper redesign: the wavefront and the int8 route -------
# The int8 route of dip_matmul_q: a quantizing pass (codes and per-row
# scales, byte for byte those of the plain version) and the int8 mainloops
# of dip_matmul.cu under matmul_plan(weight_bytes=1), K = 1088 giving a
# ragged decode split and more K tiles than the ring at prefill; N = 192
# and 320 are not multiples of the 128-column tiles (test_torch_kernel_plans
# .py holds that these cases reach each path).  The codes are the same on
# both sides and the int32 sums exact, so with no epilogue the output is
# bit for bit the plain version's; an epilogue is f32 arithmetic in another
# order, so TOL of the output dtype.
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("m,k", [(1, 4096), (4, 14336), (37, 1088), (256, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_pass_kernel_matches_plain(dev, dtype, m, k, prologue):
    from repro_torch.kernels import prologue as pro
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, quantize_pass, quantize_pass_plain

    g = torch.Generator(device=dev).manual_seed(m + k)
    x = (torch.randn(m, k, generator=g, device=dev) * 3).to(dtype)
    if m > 1:
        x[1] = 0
    gain = torch.rand(k, generator=g, device=dev) + 0.5 if prologue == "rmsnorm" else None
    inv = pro.inv_rms(x) if gain is not None else None
    before = dip_matmul_q.launches_quant
    codes, scale = quantize_pass(x, inv, gain)
    assert dip_matmul_q.launches_quant == before + 1
    want_codes, want_scale = quantize_pass_plain(x, inv, gain)
    torch.cuda.synchronize()
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)


# the KV pools' and the weights' quantizers on the card give the CPU's bytes:
# scales divided as IEEE quotients (a CUDA division by a Python scalar
# multiplies by the rounded reciprocal), the codes divided by them
@pytest.mark.parametrize("scheme", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("shape", [(27, 300, 576), (9, 300, 32, 80), (2048, 512)])
def test_quantizers_on_the_card_give_the_cpu_bytes(dev, shape, scheme):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(torch.bfloat16)
    x[0, 1] = 0
    q, s = api.quant.quantize_rows(x, scheme)
    q_cpu, s_cpu = api.quant.quantize_rows(x.cpu(), scheme)
    assert torch.equal(s.cpu(), s_cpu) and torch.equal(q.cpu().view(torch.uint8), q_cpu.view(torch.uint8))
    if len(shape) == 2:
        w, w_cpu = api.quant.quantize(x.float(), scheme), api.quant.quantize(x.float().cpu(), scheme)
        assert torch.equal(w.scale.cpu(), w_cpu.scale)
        assert torch.equal(w.data.cpu().view(torch.uint8), w_cpu.data.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("n", [192, 320, 4096])
@pytest.mark.parametrize("m", [1, 4, 32, 33, 256, 4096])
def test_dip_matmul_q_int8_route_plans_match_plain(dev, m, n, epilogue, prologue, dtype):
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain

    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    k = 1088
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    qw = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, "int8") for _ in range(2)]
    s = epi.spec(epilogue)
    eops = (qw[1].data, qw[1].scale) if s.dual_weight else _operands(epilogue, m, k, n, dtype, dev, g)
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops, prologue_k=k - 7)
    before = (dip_matmul_q.launches, dip_matmul_q.launches_tc, dip_matmul_q.launches_quant)
    got = dip_matmul_q(x, qw[0].data, qw[0].scale, *eops, **kw)
    assert (dip_matmul_q.launches, dip_matmul_q.launches_tc, dip_matmul_q.launches_quant) == tuple(
        b + 1 for b in before)
    want = dip_matmul_q_plain(x, qw[0].data, qw[0].scale, *eops, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (m, n)
    if epilogue == "none":
        assert torch.equal(got, want)
    else:
        _close(got, want, dtype)


# The wavefront over its plans (kernels/dip_systolic.py::systolic_plan):
# decode M = 1, 4 and 13 (a 16-row block with warps past M, K split with a
# ragged last split at N = 4096), prefill M = 17 and 100 (the 32-row block,
# 17 K tiles through a ring of 2 or 3 stages); N = 192 and 320 are not
# multiples of the 128- and 256-column blocks.  f32 and bf16 within TOL,
# int8 exact (int32 partial sums where K is split).
@pytest.mark.parametrize("dtype,prologue", SYSTOLIC_INPUTS)
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("n", [192, 320, 4096])
@pytest.mark.parametrize("m", [1, 4, 13, 17, 100])
def test_dip_systolic_plans_match_plain(dev, m, n, epilogue, dtype, prologue):
    from repro_torch.kernels.dip_systolic import dip_systolic, dip_systolic_plain

    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    k = 1088
    if dtype == torch.int8:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        p, pu = (torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8) for _ in range(2))
        res = torch.randint(-127, 128, (m, n), generator=g, device=dev, dtype=torch.int8)
    else:
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        p, pu = ((torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype) for _ in range(2))
        res = torch.randn(m, n, generator=g, device=dev).to(dtype)
    s = epi.spec(epilogue)
    eops = (pu,) if s.dual_weight else (torch.randn(n, generator=g, device=dev),) if s.bias else (
        (res,) if s.residual else ())
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops, prologue_k=k - 7)
    before = dip_systolic.launches
    got = dip_systolic(x, p, *eops, **kw)
    want = dip_systolic_plain(x, p, *eops, **kw)
    torch.cuda.synchronize()
    assert dip_systolic.launches == before + 1 and got.dtype == want.dtype and got.shape == (m, n)
    if dtype == torch.int8 and epilogue == "none":
        assert got.dtype == torch.int32 and torch.equal(got, want)
    else:
        _close(got, want, torch.float32 if dtype == torch.int8 else dtype)


# ------------------------------------------------ DeepSeek-V2-Lite slice ---
_DS = get_config("deepseek-v2-lite-16b")
_DS_SFF = _DS.n_shared_experts * _DS.d_ff_expert
# (label, K, N, epilogue, prologue) of every projection a DeepSeek-V2-Lite
# forward sends to the kernel (tests/test_torch_kernel_plans.py)
DEEPSEEK_PROJECTIONS = [
    ("wq", 2048, _DS.n_heads * (_DS.qk_nope_head_dim + _DS.qk_rope_head_dim), "none", "rmsnorm"),
    ("w_dkv", 2048, _DS.kv_lora_rank, "none", "rmsnorm"),
    ("w_krope", 2048, _DS.qk_rope_head_dim, "none", "rmsnorm"),
    ("wo", _DS.n_heads * _DS.v_head_dim, 2048, "residual", "none"),
    ("shared gate+up", 2048, _DS_SFF, "swiglu", "none"),
    ("shared down", _DS_SFF, 2048, "none", "none"),
    ("lm_head", 2048, _DS.padded_vocab, "none", "none"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 256])
@pytest.mark.parametrize("proj", DEEPSEEK_PROJECTIONS, ids=[p[0] for p in DEEPSEEK_PROJECTIONS])
def test_dip_matmul_deepseek_projections_match_plain(dev, proj, m, dtype):
    """Every DeepSeek-V2-Lite projection at a decode step's M and a prefill
    chunk's, N = 64 (half the prefill tile's width) included."""
    label, k, n, epilogue, prologue = proj
    g = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    p = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype)
    eops = _operands(epilogue, m, k, n, dtype, dev, g)
    if epi.spec(epilogue).dual_weight:
        eops = ((eops[0] / k ** 0.5).to(dtype),)
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops)
    before = dip_matmul.launches
    got = dip_matmul(x, p, *eops, **kw)
    assert dip_matmul.launches == before + 1
    want = dip_matmul_plain(x, p, *eops, **kw)
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    _close(got, want, dtype)


# the reduced MoE models, card against CPU on the same weights: f32 logits of
# two layers, each matmul within TOL (1e-5), so 1e-4 as chip_smoke.py phase 3
MODEL_TOL = 1e-4


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"])
def test_reduced_moe_model_card_matches_cpu(dev, name):
    """Forward logits and a paged decode step of the reduced MoE model (its
    w_krope 16 columns wide, padded to one 64-wide tile) on the card against
    the plain versions on the CPU, with the same routing."""
    cfg = dataclasses.replace(get_config(name).reduced(), matmul_backend="dip", param_dtype="float32",
                              compute_dtype="float32")
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu")
    on_card = _to(params, dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(2, 512, (2, 24)))
    stats = {"cpu": {}, "cuda": {}}
    want, _ = tf_model.forward(params, cfg, tokens=tokens, moe_trace=stats["cpu"])
    got, _ = tf_model.forward(on_card, cfg, tokens=tokens.to(dev), attn_backend="flash", moe_trace=stats["cuda"])
    assert [int(d) for d in stats["cuda"]["dropped"]] == [int(d) for d in stats["cpu"]["dropped"]]
    err = (got.cpu()[..., :cfg.vocab_size] - want[..., :cfg.vocab_size]).abs().max().item()
    assert err <= MODEL_TOL * max(1.0, want[..., :cfg.vocab_size].abs().max().item())
    tables = torch.tensor([[1, 2], [3, 4]])
    pos, toks = torch.tensor([5, 2]), torch.tensor([[7], [9]])
    step = tf_model.paged_decode_step_fn(cfg)
    outs = []
    for params_d, d in ((params, "cpu"), (on_card, dev)):
        pool = tf_model.init_paged_cache(cfg, 5, 16, device=d)
        outs.append(step(params_d, pool, toks.to(d), pos.to(d), tables.to(d))[0].cpu())
    err = (outs[1] - outs[0])[..., :cfg.vocab_size].abs().max().item()
    assert err <= MODEL_TOL * max(1.0, outs[0][..., :cfg.vocab_size].abs().max().item())


# ------------------------------------- Zamba2 / Mamba2 (SSM) serving slice ---
_ZB, _MB = get_config("zamba2-2.7b"), get_config("mamba2-370m")
# (label, K, N, epilogue, prologue) of every projection a Zamba2-2.7B or
# Mamba2-370M forward sends to the kernel: in_proj's logical width is not a
# multiple of 64 (10448 -> storage 10496, 4384 -> 4416), so its last tile is
# padded; out_proj carries the block's residual at K = 5120 / 2048
SSM_PROJECTIONS = [
    ("zamba2 in_proj", 2560, 2 * _ZB.d_inner + 2 * _ZB.ssm_state + _ZB.n_ssm_heads, "none", "none"),
    ("zamba2 out_proj", _ZB.d_inner, 2560, "residual", "none"),
    ("zamba2 wq", 2560, 2560, "none", "rmsnorm"),
    ("zamba2 wo", 2560, 2560, "residual", "none"),
    ("zamba2 gate+up", 2560, _ZB.d_ff, "swiglu", "rmsnorm"),
    ("zamba2 down", _ZB.d_ff, 2560, "residual", "none"),
    ("zamba2 lm_head", 2560, _ZB.padded_vocab, "none", "none"),
    ("mamba2 in_proj", 1024, 2 * _MB.d_inner + 2 * _MB.ssm_state + _MB.n_ssm_heads, "none", "none"),
    ("mamba2 out_proj", _MB.d_inner, 1024, "residual", "none"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 256])
@pytest.mark.parametrize("proj", SSM_PROJECTIONS, ids=[p[0] for p in SSM_PROJECTIONS])
def test_dip_matmul_ssm_projections_match_plain(dev, proj, m, dtype):
    """Each projection through the registry on a ``DipWeight`` of its
    logical width (the shim pads and crops), against the plain version of
    the padded storage cropped to the same width: M = 1 (the prefill
    tail), 4 (a decode step) and 256 (a prefill chunk)."""
    label, k, n, epilogue, prologue = proj
    g = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    ws = [api.DipWeight.from_natural((torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype))
          for _ in range(2 if epilogue == "swiglu" else 1)]
    res = torch.randn(m, n, generator=g, device=dev).to(dtype) if epilogue == "residual" else None
    gain = torch.rand(k, generator=g, device=dev) + 0.5
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=(gain,) if prologue == "rmsnorm" else ())
    before = dip_matmul.launches
    got = api.matmul(x, tuple(ws) if len(ws) == 2 else ws[0], backend="dip",
                     epilogue_operands=() if res is None else (res,), **kw)
    assert dip_matmul.launches == before + 1
    pad = ws[0].data.shape[1] - n
    eops = ((ws[1].data,) if len(ws) == 2 else
            (torch.nn.functional.pad(res, (0, pad)),) if res is not None else ())
    want = dip_matmul_plain(x, ws[0].data, *eops, **kw)[:, :n]
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,q_offset", [(256, 0), (256, 512), (1, 700)])
def test_flash_zamba2_head_dim_80_matches_plain(dev, dtype, sq, q_offset):
    """Zamba2's shared attention at prefill: 32 heads of 80, a 256-token
    chunk or one token of the prefill tail against up to 1024 keys of the
    prefill cache.  Both dtypes take the tensor cores (the chunk unsplit,
    the tail on ``split_kv``)."""
    bh, sk, d = 32, 1024, 80
    g = torch.Generator(device=dev).manual_seed(sq + q_offset)
    q = torch.randn(bh, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(bh, sk, d, generator=g, device=dev).to(dtype)
    kw = dict(q_offset=torch.tensor(q_offset, device=dev), kv_len=q_offset + sq, causal=True)
    route = flash_plan(bh, sq, sk, d, d, dtype, torch.cuda.get_device_properties(dev).multi_processor_count)[0]
    assert route == ("split_kv" if sq == 1 else "tensor_cores")
    before = _counters()
    got = flash_attention(q, k, v, **kw)
    assert _counters() == (before[0] + 1, before[1] + (route != "cuda_cores"), before[2] + (route == "split_kv"))
    want = attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "mamba2-370m"])
def test_reduced_ssm_model_card_matches_cpu(dev, name):
    """Forward logits, a chunk and a single token through the prefill step,
    and a paged decode step of the reduced SSM / hybrid model on the card
    against the plain versions on the CPU; the state pools too."""
    cfg = dataclasses.replace(get_config(name).reduced(), matmul_backend="dip", param_dtype="float32",
                              compute_dtype="float32")
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu")
    on_card = _to(params, dev)
    v = cfg.vocab_size

    def near(got, want):
        err = (got.cpu() - want).abs().max().item()
        assert err <= MODEL_TOL * max(1.0, want.abs().max().item()), err

    tokens = torch.as_tensor(np.random.default_rng(0).integers(2, 512, (2, 45)))
    near(tf_model.forward(on_card, cfg, tokens=tokens.to(dev))[0][..., :v],
         tf_model.forward(params, cfg, tokens=tokens)[0][..., :v])
    step = tf_model.decode_step_fn(cfg, attn_backend="flash")
    caches = [tf_model.init_cache(cfg, 1, 64, device=d) for d in ("cpu", dev)]
    for lo, hi in ((0, 40), (40, 41)):
        outs = [step(p, c, tokens[:1, lo:hi].to(c["layers"]["state"].device)) for p, c in zip((params, on_card), caches)]
        near(outs[1][0][..., :v], outs[0][0][..., :v])
    for nm in ("conv", "state"):
        near(caches[1]["layers"][nm], caches[0]["layers"][nm])
    tables = torch.tensor([[1, 2], [3, 4]])
    pos, toks = torch.tensor([5, 2]), torch.tensor([[7], [9]])
    pstep = tf_model.paged_decode_step_fn(cfg)
    outs = []
    for params_d, d in ((params, "cpu"), (on_card, dev)):
        pool = tf_model.init_paged_cache(cfg, 5, 16, slots=2, device=d)
        outs.append(pstep(params_d, pool, toks.to(d), pos.to(d), tables.to(d))[0].cpu())
    near(outs[1][..., :v], outs[0][..., :v])


# -------------------- the families' training heads: lm_head_ce's new shapes --
# (d_model, padded vocab, vocab): DeepSeek-V2-Lite, Zamba2-2.7B, Mamba2-370M
# (tied: the head is embed.t()) and musicgen-medium, at the training batch's
# T = 4 x 1023
FAMILY_HEADS = [(2048, 102400, 102400), (2560, 32768, 32000), (1024, 51200, 50280), (1536, 2048, 2048)]


@pytest.mark.parametrize("d,vp,vocab", FAMILY_HEADS)
def test_lm_head_ce_family_heads_match_plain(dev, d, vp, vocab):
    """bf16 x against the f32 head, as training runs it: the split plan
    stays under the grid limit and the padded lanes are masked (f32 TOL of
    max(1, max|plain|): three exact bf16 part products)."""
    t = 4 * 1023
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(t, d, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(d, vp, generator=g, device=dev) / d ** 0.5
    labels = torch.randint(0, vocab, (t,), generator=g, device=dev, dtype=torch.int32)
    labels[::11] = ce.IGNORE_INDEX
    tiles, splits = ce.split_plan(t, vp, torch.cuda.get_device_properties(dev).multi_processor_count, vocab)
    assert splits <= 65535 and (vp == vocab or (splits - 1) * tiles * ce.BLOCK_V >= vocab)
    before = ce.lm_head_ce.launches
    with torch.no_grad():
        got = ce.lm_head_ce(x, w, labels, vocab_size=vocab)
    assert ce.lm_head_ce.launches == before + 1
    want = ce.lm_head_ce_plain(x, w, labels, vocab_size=vocab)
    for a, b in zip(got, want):
        _close(a, b, torch.float32)


def test_tied_head_gradient_into_the_embedding_card_matches_cpu(dev):
    """The tied head's fused loss on the card (the kernel reads a contiguous
    copy of ``embed.t()``): the loss and the embedding's gradient, lookup
    and head summed, against the plain versions on the CPU."""

    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(), matmul_backend="dip", param_dtype="float32",
                              compute_dtype="float32")
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 40)))
    out = {}
    for where, p in (("cpu", params), ("cuda", _to(params, dev))):
        embed = p["embed"].requires_grad_(True)
        before = ce.lm_head_ce.launches
        loss = tf_model.loss_fn(p, cfg, {"tokens": toks.to(where), "labels": toks.to(where)})
        (grad,) = torch.autograd.grad(loss, [embed])
        assert ce.lm_head_ce.launches == before + (where == "cuda")
        out[where] = (loss.detach(), grad)
    for a, b in zip(out["cuda"], out["cpu"]):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.abs().max().item()), err


# ---------------- the MLA pair (192, 128) and fp8 with f32 x on the tensor cores --
MLA_FLASH_CASES = [
    # bh, sq, sk, q_offset (int or per-row list), kv_len (None, int or per-row list), causal
    (16, 541, 541, 0, None, True),             # DeepSeek-V2-Lite's 541-token prompt, no cache
    (2, 130, 300, 96, 250, True),              # q_offset > 0, rows past kv_len
    (4, 100, 256, [0, 150, 10, 100], [0, 256, 0, 200], True),  # per-row values, kv_len 0 rows: exactly 0
    (2, 70, 190, 0, 170, False),               # causal off
    (32, 256, 1024, 512, 768, True),           # phase 7's 2-DvD shape
    (32, 1, 1024, 700, 701, True),             # split_kv, the last split wholly dead
    (4, 16, 700, 600, [0, 616, 5, 650], True),  # split_kv, a kv_len 0 row and a row ending at key 5
    (4, 64, 1024, [0, 300, 900, 64], None, True),  # split_kv at SPLIT_MAX_SQ
    (2, 2, 900, 0, 880, False),                # split_kv, causal off
]


def _mla_case(dev, bh, sq, sk, qo, kvl, causal):
    g = torch.Generator(device=dev).manual_seed(sq * 3 + sk)
    q, k = (torch.randn(bh, s, 192, generator=g, device=dev).to(torch.bfloat16) for s in (sq, sk))
    v = torch.randn(bh, sk, 128, generator=g, device=dev).to(torch.bfloat16)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev) if isinstance(kvl, list) else kvl
    return q, k, v, dict(q_offset=torch.tensor(qo, device=dev), kv_len=kv_len, causal=causal)


@pytest.mark.parametrize("case", MLA_FLASH_CASES)
def test_flash_mla_pair_matches_plain(dev, case):
    """bf16 with D = 192 (nope + rope) and Dv = 128, DeepSeek-V2-Lite's
    whole-prompt MLA attention: Sq above SPLIT_MAX_SQ on the unsplit 64-row
    tiles, shorter on split_kv; one launch counted on the tensor cores,
    within bf16 TOL of the plain version, fully masked rows exactly 0, two
    split calls bit for bit equal."""
    bh, sq, sk, qo, kvl, causal = case
    q, k, v, kw = _mla_case(dev, *case)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    route = flash_plan(bh, sq, sk, 192, 128, torch.bfloat16, sms)[0]
    assert route == ("tensor_cores" if sq > SPLIT_MAX_SQ else "split_kv")
    before = _counters()
    got = flash_attention(q, k, v, **kw)
    assert _counters() == (before[0] + 1, before[1] + 1, before[2] + (route == "split_kv"))
    want = attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == (bh, sq, 128) and got.dtype == torch.bfloat16
    _close(got, want, torch.bfloat16)
    _assert_dead_rows_zero(got, kvl, bh, sk)
    if route == "split_kv":
        assert torch.equal(got, flash_attention(q, k, v, **kw)), "two split calls differ"


def test_flash_mla_pair_refuses_offset_views(dev):
    """q, k or v at a storage offset that is not 16-byte aligned is refused
    before the launch on both tensor-core routes of the (192, 128) pair,
    and the aligned call then runs."""
    g = torch.Generator(device=dev).manual_seed(9)
    buf = torch.randn(2 * 150 * 192 + 8, generator=g, device=dev).to(torch.bfloat16)
    q, k = (torch.randn(2, s, 192, generator=g, device=dev).to(torch.bfloat16) for s in (70, 150))
    v = torch.randn(2, 150, 128, generator=g, device=dev).to(torch.bfloat16)
    for bad in ((buf[1:1 + 2 * 70 * 192].view(2, 70, 192), k, v), (q, buf[3:3 + 2 * 150 * 192].view(2, 150, 192), v),
                (q, k, buf[1:1 + 2 * 150 * 128].view(2, 150, 128)), (buf[1:1 + 2 * 192].view(2, 1, 192), k, v)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention(*bad)
    torch.cuda.synchronize()
    _close(flash_attention(q, k, v), attention_plain(q, k, v), torch.bfloat16)


def _fp8_f32_call(dev, m, k, n, epilogue, prologue, seed):
    """An fp8 f32-x call on the card: the launches it made (products on the
    tensor cores, cast passes) and its output against the plain version's."""
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev)
    qw = [api.quant.quantize(torch.randn(k, n, generator=g, device=dev) / k ** 0.5, "fp8_e4m3") for _ in range(2)]
    s = epi.spec(epilogue)
    eops = (qw[1].data, qw[1].scale) if s.dual_weight else _operands(epilogue, m, k, n, torch.float32, dev, g)
    pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
    kw = dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops)
    before = (dip_matmul_q.launches, dip_matmul_q.launches_tc, dip_matmul_q.launches_cast)
    got = dip_matmul_q(x, qw[0].data, qw[0].scale, *eops, **kw)
    moved = tuple(c - b for c, b in zip((dip_matmul_q.launches, dip_matmul_q.launches_tc, dip_matmul_q.launches_cast),
                                        before))
    want = dip_matmul_q_plain(x, qw[0].data, qw[0].scale, *eops, **kw)
    torch.cuda.synchronize()
    return moved, got, want


# the families' projections of phases 5d-5h at their storage widths (in_proj
# padded to a 64-multiple), f32 x as an f32-compute model gives them
FP8_F32_PROJECTIONS = [(label, k, -(-n // 64) * 64, e, pr) for label, k, n, e, pr in
                       DEEPSEEK_PROJECTIONS + SSM_PROJECTIONS]


@pytest.mark.parametrize("m", [1, 4, 256])
@pytest.mark.parametrize("proj", FP8_F32_PROJECTIONS, ids=[p[0] for p in FP8_F32_PROJECTIONS])
def test_dip_matmul_q_fp8_f32_x_family_projections_match_plain(dev, proj, m):
    """fp8 weights with f32 x at every family projection: one cast pass and
    one product on the tensor-core route, f32 out within f32 TOL of the
    plain version (the same bf16 operands, summed in IEEE f32 across K)."""
    label, k, n, epilogue, prologue = proj
    moved, got, want = _fp8_f32_call(dev, m, k, n, epilogue, prologue, seed=m + k + n)
    assert moved == (1, 1, 1) and got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, want, torch.float32)


@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", ["bias", "bias_gelu", "bias_silu", "residual", "swiglu"])
@pytest.mark.parametrize("m", [1, 4, 256])
def test_dip_matmul_q_fp8_f32_x_epilogues_match_plain(dev, m, epilogue, prologue):
    """The bias, residual and swiglu epilogues with and without the rmsnorm
    prologue at DeepSeek-V2-Lite's width (K = 2048, N = 2816)."""
    moved, got, want = _fp8_f32_call(dev, m, 2048, 2816, epilogue, prologue, seed=m)
    assert moved == (1, 1, 1) and got.dtype == torch.float32
    _close(got, want, torch.float32)


@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("m,k", [(1, 2048), (4, 14336), (37, 1088), (256, 4096)])
def test_cast_pass_kernel_matches_plain_byte_for_byte(dev, m, k, prologue):
    """The fp8 route's cast pass on the card: bf16 bytes equal to the plain
    version's, an all-zero row and a row of exact bf16 rounding midpoints
    (ties to even) included."""
    from repro_torch.kernels import prologue as pro
    from repro_torch.kernels.dip_matmul_q import cast_pass, cast_pass_plain, dip_matmul_q

    g = torch.Generator(device=dev).manual_seed(m + k)
    x = torch.randn(m, k, generator=g, device=dev) * 3
    if m > 2:
        x[1] = 0
        bits = (torch.randint(0x3C00, 0x4400, (k,), generator=g, device=dev, dtype=torch.int32) << 16) + 0x8000
        x[2] = bits.view(torch.float32)
    gain = torch.rand(k, generator=g, device=dev) + 0.5 if prologue == "rmsnorm" else None
    inv = pro.inv_rms(x) if gain is not None else None
    before = dip_matmul_q.launches_cast
    got = cast_pass(x, inv, gain)
    assert dip_matmul_q.launches_cast == before + 1 and got.dtype == torch.bfloat16
    want = cast_pass_plain(x, inv, gain)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ------- f32 on the tensor cores (flash, lm_head_ce), the reduced head dims --
# f32 flash at every tensor-core pair and bf16 at the reduced models' pairs:
# both routes by Sq, ragged Sq and Sk, per-row q_offset / kv_len, kv_len 0
# rows exactly 0.  f32 takes each product as the six exact bf16 part
# products i + j <= 2, so it holds the f32 TOL of the plain version.
NEW_FLASH_SHAPES = [
    # bh, sq, sk, q_offset (int or per-row list), kv_len (None, int or per-row list), causal
    (3, 70, 200, 0, None, True),               # Sq not a multiple of the 64-row tile
    (4, 130, 300, [0, 96, 170, 40], [0, 250, 300, 17], True),  # per-row values; kv_len 0: exactly 0
    (2, 70, 190, 30, 170, False),              # causal off
    (2, 256, 1024, 512, 768, True),            # the prefill chunk's shape
    (32, 1, 1024, 700, 701, True),             # split_kv: one token, the last split wholly dead
    (4, 16, 700, 600, [0, 616, 5, 650], True),  # split_kv: a kv_len 0 row, a row ending at key 5
    (3, 33, 150, 10, 0, True),                 # split_kv: every row fully masked
    (4, 64, 1024, [0, 300, 900, 64], None, True),  # split_kv at SPLIT_MAX_SQ
]
NEW_FLASH_ROUTES = ([(torch.float32, p) for p in sorted(TC_PAIRS)]
                    + [(torch.bfloat16, p) for p in ((32, 32), (48, 48), (48, 32))])


@pytest.mark.parametrize("case", NEW_FLASH_SHAPES)
@pytest.mark.parametrize("dtype,pair", NEW_FLASH_ROUTES,
                         ids=[f"{str(dt).split('.')[-1]}-{p[0]}x{p[1]}" for dt, p in NEW_FLASH_ROUTES])
def test_flash_f32_and_reduced_head_dims_on_the_tensor_cores(dev, dtype, pair, case):
    """One launch on the planned tensor-core route (``tensor_cores`` above
    SPLIT_MAX_SQ, ``split_kv`` at or below), counted by route; within TOL
    of the plain version; fully masked rows exactly 0; two split calls bit
    for bit equal."""
    bh, sq, sk, qo, kvl, causal = case
    d, dv = pair
    g = torch.Generator(device=dev).manual_seed(sq * 5 + d + dv)
    q, k = (torch.randn(bh, s, d, generator=g, device=dev).to(dtype) for s in (sq, sk))
    v = torch.randn(bh, sk, dv, generator=g, device=dev).to(dtype)
    kw = dict(q_offset=torch.tensor(qo, device=dev),
              kv_len=torch.tensor(kvl, dtype=torch.int32, device=dev) if isinstance(kvl, list) else kvl,
              causal=causal)
    route = flash_plan(bh, sq, sk, d, dv, dtype, torch.cuda.get_device_properties(dev).multi_processor_count)[0]
    assert route == ("tensor_cores" if sq > SPLIT_MAX_SQ else "split_kv")
    before = _counters()
    got = flash_attention(q, k, v, **kw)
    assert _counters() == (before[0] + 1, before[1] + 1, before[2] + (route == "split_kv"))
    want = attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == (bh, sq, dv) and got.dtype == dtype
    _close(got, want, dtype)
    _assert_dead_rows_zero(got, kvl, bh, sk)
    if route == "split_kv":
        assert torch.equal(got, flash_attention(q, k, v, **kw)), "two split calls differ"


def test_flash_f32_refuses_offset_views(dev):
    """f32 q, k or v at a storage offset that is not 16-byte aligned is
    refused before the launch on both tensor-core routes, and the aligned
    calls then run."""
    g = torch.Generator(device=dev).manual_seed(11)
    buf = torch.randn(2 * 150 * 128 + 8, generator=g, device=dev)
    q, k, v = (torch.randn(2, s, 128, generator=g, device=dev) for s in (70, 150, 150))
    for bad in ((buf[1:1 + 2 * 70 * 128].view(2, 70, 128), k, v), (q, buf[2:2 + 2 * 150 * 128].view(2, 150, 128), v),
                (q, k, buf[3:3 + 2 * 150 * 128].view(2, 150, 128)), (buf[1:1 + 2 * 128].view(2, 1, 128), k, v)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention(*bad)
    torch.cuda.synchronize()
    for qq in (q, q[:, :1].clone()):
        _close(flash_attention(qq, k, v), attention_plain(qq, k, v), torch.float32)


@pytest.mark.parametrize("d,vp,vocab", FAMILY_HEADS)
def test_lm_head_ce_f32_family_heads_match_plain(dev, d, vp, vocab):
    """f32 x against the f32 head at the families' training heads, T = 4
    x 1023 (the first training step in f32 compute): one launch, within f32
    TOL of max(1, max|plain|) (six exact bf16 part products); Mamba2's tied
    head as ``embed.t()``, the (d, Vp) view of a (Vp, d) embedding; labels
    at -100 add nothing."""
    t = 4 * 1023
    g = torch.Generator(device=dev).manual_seed(d + 1)
    x = torch.randn(t, d, generator=g, device=dev)
    tied = (d, vp) == (1024, 51200)
    w = (torch.randn(vp, d, generator=g, device=dev).t() if tied else torch.randn(d, vp, generator=g, device=dev))
    w = w / d ** 0.5
    labels = torch.randint(0, vocab, (t,), generator=g, device=dev, dtype=torch.int32)
    labels[::11] = ce.IGNORE_INDEX
    before = ce.lm_head_ce.launches
    with torch.no_grad():
        got = ce.lm_head_ce(x, w, labels, vocab_size=vocab)
    assert ce.lm_head_ce.launches == before + 1
    want = ce.lm_head_ce_plain(x, w, labels, vocab_size=vocab)
    for a, b in zip(got, want):
        _close(a, b, torch.float32)
    assert (got[1][labels == ce.IGNORE_INDEX] == 0).all()
