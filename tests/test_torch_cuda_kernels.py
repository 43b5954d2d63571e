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
from repro_torch.kernels.flash_attention import attention_plain, flash_attention
from repro_torch.models import transformer as tf_model

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


def _to(t, dev):
    if isinstance(t, dict):
        return {k: _to(v, dev) for k, v in t.items()}
    if isinstance(t, api.DipWeight):
        return t.with_data(t.data.to(dev))
    return t.to(dev)
