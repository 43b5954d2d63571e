"""The port's quantized matmul backends (``dip_int8w``, ``dip_fp8``, kernel
module ``kernels/dip_matmul_q.py``) against ``repro.api.matmul`` with the
reference's ``dip_matmul_q_pallas`` in interpret mode, on the same numpy
inputs and the same quantized weights (``params`` quantized on both sides
from one float32 array: the storage is byte-identical, test_torch_quant.py).

Shapes are ragged in M, K and N so the padding shim is exercised.
Tolerances: float32 1e-5 of max(1, max|reference|) — the int8 path's
integer sums are exact on both sides, so what is left is the f32 scaling
and epilogue in another order; the int8 activation codes are asserted
identical first, since one flipped code would move an output by a whole
quantization step.  bfloat16: ``_torch_parity.TOL``, about one bf16 step.

int8 with the rmsnorm prologue: the two frameworks' inverse RMS differ in
the last bit on some rows (another summation order and rsqrt), which can
flip an activation code.  So the reference's fused path is held to the port
on the codes of the reference's own normalized activations (asserted
identical), and the port's fused path is held to its own decomposition
(normalize over the padded K as the dispatch does, then the prologue-free
dispatch) bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from _torch_parity import TOL, assert_close
from repro import api as ref_api
from repro.kernels import prologue as ref_pro
from repro.kernels import ref as ref_kernels
from repro_torch import api
from repro_torch.api import quant
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels import prologue as pro
from repro_torch.kernels import ref
from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain, fp8_compute_dtype

M, K, N = 37, 100, 70
BACKENDS = {"int8": "dip_int8w", "fp8_e4m3": "dip_fp8"}


def _inputs(epilogue, dtype, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(M, K)).astype(np.float32)
    w = (r.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    wu = (r.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    g = (r.random(K) + 0.5).astype(np.float32)
    b = r.normal(size=(N,)).astype(np.float32)
    res = r.normal(size=(M, N)).astype(np.float32)
    s = epi.spec(epilogue)
    ops = (b,) if s.bias else (res,) if s.residual else ()
    return x, w, wu, g, ops


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a, dtype=jnp.float32).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("scheme", sorted(BACKENDS))
def test_quantized_backend_matches_reference(scheme, epilogue, prologue, dtype):
    x, w, wu, g, ops = _inputs(epilogue, dtype)
    dual = epi.spec(epilogue).dual_weight
    rw = tuple(ref_api.quant.quantize(jnp.asarray(a), scheme) for a in (w, wu))
    pw = tuple(quant.quantize(torch.from_numpy(a), scheme) for a in (w, wu))
    r_ops = tuple(_j(o, dtype if o.ndim == 2 else "float32") for o in ops)
    p_ops = tuple(_t(o, dtype if o.ndim == 2 else "float32") for o in ops)
    rkw = dict(prologue="rmsnorm", prologue_operands=(jnp.asarray(g),)) if prologue == "rmsnorm" else {}
    pkw = dict(prologue="rmsnorm", prologue_operands=(torch.from_numpy(g),)) if prologue == "rmsnorm" else {}
    xj, xt = _j(x, dtype), _t(x, dtype)
    port = lambda xx, **kw: api.matmul(xx, pw if dual else pw[0], backend=BACKENDS[scheme],  # noqa: E731
                                       epilogue=epilogue, epilogue_operands=p_ops, **kw)
    want = ref_api.matmul(xj, rw if dual else rw[0], backend=BACKENDS[scheme], epilogue=epilogue,
                          epilogue_operands=r_ops, **rkw)
    got = port(xt, **pkw)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    if scheme == "int8":  # the activation codes both kernels multiply
        xr = ref_pro.apply("rmsnorm", xj, jnp.asarray(g), k_true=K) if rkw else xj
        xs = _t(np.asarray(xr.astype(jnp.float32)), dtype)
        (rq, rs), (pq, ps) = ref_kernels.quantize_acts_int8(xr), ref.quantize_acts_int8(xs)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
        if rkw:
            # normalized as the dispatch does it: over K padded to the storage
            kp = pw[0].storage_shape[0]
            xp = pro.apply("rmsnorm", F.pad(xt, (0, kp - K)), F.pad(torch.from_numpy(g), (0, kp - K)),
                           k_true=K)[:, :K]
            assert torch.equal(got, port(xp))
            got = port(xs)
    assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("scheme", sorted(BACKENDS))
def test_plain_version_matches_the_port_oracle(scheme):
    """The kernel module's plain version on padded storage against the
    port's ``ref`` oracles, every epilogue (swiglu with its own scales)."""
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.normal(size=(5, 128)).astype(np.float32))
    qw = [quant.quantize(torch.from_numpy(r.normal(size=(128, 64)).astype(np.float32)), scheme) for _ in range(2)]
    oracle = ref.dip_matmul_int8w_epilogue_ref if scheme == "int8" else ref.dip_matmul_fp8_epilogue_ref
    for e in epi.EPILOGUES:
        s = epi.spec(e)
        ops = ((qw[1].data, qw[1].scale) if s.dual_weight else
               (torch.from_numpy(r.normal(size=(64,)).astype(np.float32)),) if s.bias else
               (torch.from_numpy(r.normal(size=(5, 64)).astype(np.float32)),) if s.residual else ())
        got = dip_matmul_q(x, qw[0].data, qw[0].scale, *ops, epilogue=e)
        want = oracle(x, qw[0].data, qw[0].scale, epilogue=e, operands=ops)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert fp8_compute_dtype("cpu") == torch.float32 and fp8_compute_dtype("cuda") == torch.bfloat16


def test_quantized_dispatch_routes_and_refuses():
    r = np.random.default_rng(2)
    w = torch.from_numpy(r.normal(size=(64, 64)).astype(np.float32))
    x = torch.from_numpy(r.normal(size=(3, 64)).astype(np.float32))
    q8, f8 = quant.quantize(w, "int8"), quant.quantize(w, "fp8_e4m3")
    # no backend: the weight's scheme picks it; the float path dequantizes
    torch.testing.assert_close(api.matmul(x, q8), api.matmul(x, q8, backend="dip_int8w"))
    torch.testing.assert_close(api.matmul(x, f8, backend="torch"), x @ f8.to_natural(), rtol=1e-6, atol=1e-6)
    assert api.matmul(x.bfloat16(), q8, backend="torch").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="requantize"):
        api.matmul(x, f8, backend="dip_int8w")
    with pytest.raises(ValueError, match="scheme"):
        api.matmul(x, (q8, f8), backend="dip_int8w", epilogue="swiglu")
    # an input that needs a gradient takes the straight-through backward
    # (refused until it was ported; test_torch_quant_grad.py holds it to the reference)
    xg = x.clone().requires_grad_()
    api.matmul(xg, q8).sum().backward()
    torch.testing.assert_close(xg.grad, q8.to_natural().sum(1).expand(3, 64))
    with pytest.raises(ValueError, match="w_scale"):
        dip_matmul_q_plain(x, q8.data, q8.scale[:, :32])
