"""The port's matmul registry and DiP kernel module against
``repro.api.matmul`` on the same numpy inputs.

The reference runs its Pallas kernels in interpret mode on the CPU
(``api.default_interpret``); the port's wrapper runs the kernel's plain
version for CPU tensors.  Shapes are ragged in M, K and N so the padding
shim is exercised.  Tolerances (``_torch_parity.TOL``): float32 1e-5 and
bfloat16 8e-3 of max(1, max|reference|) — the same f32 arithmetic in
another summation order, plus at most about one bf16 rounding step.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import TOL, assert_close
from repro import api as ref_api
from repro.configs import get_config as ref_get
from repro.kernels import epilogue as ref_epi
from repro.kernels import prologue as ref_pro
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels import prologue as pro
from repro_torch.kernels import ref
from repro_torch.kernels.dip_matmul import dip_matmul, dip_matmul_plain

M, K, N = 37, 100, 70


def _inputs(epilogue, dtype, seed=0, m=M, k=K, n=N):
    r = np.random.default_rng(seed)
    x = r.normal(size=(m, k)).astype(np.float32)
    w = (r.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    wu = (r.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    g = (r.random(k) + 0.5).astype(np.float32)
    b = r.normal(size=(n,)).astype(np.float32)
    res = r.normal(size=(m, n)).astype(np.float32)
    s = epi.spec(epilogue)
    ops = (b,) if s.bias else (res.astype(dtype),) if s.residual else ()
    return x.astype(dtype), w.astype(dtype), wu.astype(dtype), g, ops


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
def test_dip_backend_matches_pallas_dip(epilogue, prologue, dtype):
    x, w, wu, g, ops = _inputs(epilogue, dtype)
    dual = epi.spec(epilogue).dual_weight
    rw = (ref_api.DipWeight.from_natural(jnp.asarray(w)), ref_api.DipWeight.from_natural(jnp.asarray(wu)))
    pw = (api.DipWeight.from_natural(_t(w)), api.DipWeight.from_natural(_t(wu)))
    pkw = dict(prologue=prologue, prologue_operands=(g,)) if prologue == "rmsnorm" else {}
    want = ref_api.matmul(jnp.asarray(x), rw if dual else rw[0], backend="pallas_dip", epilogue=epilogue,
                          epilogue_operands=tuple(jnp.asarray(o) for o in ops),
                          **{k: (tuple(jnp.asarray(v) for v in val) if k == "prologue_operands" else val)
                             for k, val in pkw.items()})
    got = api.matmul(_t(x), pw if dual else pw[0], backend="dip", epilogue=epilogue,
                     epilogue_operands=tuple(_t(o) for o in ops),
                     **{k: (tuple(_t(v) for v in val) if k == "prologue_operands" else val)
                        for k, val in pkw.items()})
    assert str(got.dtype).endswith(dtype)
    assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
def test_ws_backend_matches_reference_ws(epilogue, dtype):
    x, w, wu, g, ops = _inputs(epilogue, dtype, seed=1)
    dual = epi.spec(epilogue).dual_weight
    want = ref_api.matmul(jnp.asarray(x), (jnp.asarray(w), jnp.asarray(wu)) if dual else jnp.asarray(w),
                          backend="ws", epilogue=epilogue,
                          epilogue_operands=tuple(jnp.asarray(o) for o in ops),
                          prologue="rmsnorm", prologue_operands=(jnp.asarray(g),))
    got = api.matmul(_t(x), (_t(w), _t(wu)) if dual else _t(w), backend="ws", epilogue=epilogue,
                     epilogue_operands=tuple(_t(o) for o in ops), prologue="rmsnorm",
                     prologue_operands=(_t(g),))
    assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
def test_decomposed_torch_backend_matches_fused_dip(epilogue):
    """The decomposition rule (torch backend) and the fused path agree."""
    x, w, wu, g, ops = _inputs(epilogue, "float32", seed=2)
    dual = epi.spec(epilogue).dual_weight
    kw = dict(epilogue=epilogue, epilogue_operands=tuple(_t(o) for o in ops), prologue="rmsnorm",
              prologue_operands=(_t(g),))
    fused = api.matmul(_t(x), (api.DipWeight.from_natural(_t(w)), api.DipWeight.from_natural(_t(wu)))
                       if dual else api.DipWeight.from_natural(_t(w)), backend="dip", **kw)
    plain = api.matmul(_t(x), (_t(w), _t(wu)) if dual else _t(w), backend="torch", **kw)
    assert_close(fused, plain, TOL["float32"])


def test_batched_x_through_the_shim():
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 5, 100)).astype(np.float32)
    w = r.normal(size=(100, 70)).astype(np.float32)
    res = r.normal(size=(2, 5, 70)).astype(np.float32)
    want = ref_api.matmul(jnp.asarray(x), ref_api.DipWeight.from_natural(jnp.asarray(w)),
                          backend="pallas_dip", epilogue="residual", epilogue_operands=(jnp.asarray(res),))
    got = api.matmul(_t(x), api.DipWeight.from_natural(_t(w)), backend="dip", epilogue="residual",
                     epilogue_operands=(_t(res),))
    assert got.shape == (2, 5, 70)
    assert_close(got, want, TOL["float32"])


@pytest.mark.parametrize("name", epi.EPILOGUES)
def test_epilogue_apply_matches_reference(name):
    r = np.random.default_rng(4)
    z = r.normal(size=(6, 8)).astype(np.float32) * 3
    s = epi.spec(name)
    ops = (r.normal(size=(6, 8)).astype(np.float32),) if (s.dual_weight or s.residual) else (
        (r.normal(size=(8,)).astype(np.float32),) if s.bias else ())
    want = ref_epi.apply(name, jnp.asarray(z), *(jnp.asarray(o) for o in ops))
    got = epi.apply(name, torch.from_numpy(z), *(torch.from_numpy(o) for o in ops))
    assert_close(got, want, 1e-6)
    assert epi.EPILOGUES == ref_epi.EPILOGUES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prologue_matches_reference(dtype):
    r = np.random.default_rng(5)
    x = np.pad(r.normal(size=(4, 90)), ((0, 0), (0, 38))).astype(dtype)  # zero-padded K
    g = (r.random(128) + 0.5).astype(np.float32)
    inv_want = ref_pro.inv_rms(jnp.asarray(x), k_true=90)
    inv_got = pro.inv_rms(_t(x), k_true=90)
    assert_close(inv_got, inv_want, 1e-6)
    want = ref_pro.apply("rmsnorm", jnp.asarray(x), jnp.asarray(g), k_true=90)
    got = pro.apply("rmsnorm", _t(x), _t(g), k_true=90)
    assert_close(got, want, 1e-6 if dtype == "float32" else TOL[dtype])
    assert pro.PROLOGUES == ref_pro.PROLOGUES and pro.DEFAULT_EPS == ref_pro.DEFAULT_EPS


def test_oracles_and_plain_version_agree():
    x, w, wu, g, _ = _inputs("swiglu", "float32", seed=6, m=9, k=128, n=64)
    p, pu = (api.DipWeight.from_natural(_t(a)).data for a in (w, wu))
    want = ref.dip_matmul_epilogue_ref(_t(x), p, epilogue="swiglu", operands=(pu,))
    got = dip_matmul(_t(x), p, pu, epilogue="swiglu")
    assert_close(got, want, 1e-6)
    assert_close(ref.ws_matmul_ref(_t(x), _t(w)), _t(x) @ _t(w), 1e-6)
    assert ref.acc_dtype_for(torch.zeros(1, dtype=torch.int8)) == torch.int32


def test_kernel_wrapper_checks_its_inputs():
    x = torch.randn(4, 100)
    with pytest.raises(ValueError, match="multiples"):
        dip_matmul_plain(x, torch.randn(100, 64))
    with pytest.raises(ValueError, match="swiglu up-weight"):
        dip_matmul(torch.randn(4, 64), torch.randn(64, 64), torch.randn(64, 128), epilogue="swiglu")
    with pytest.raises(ValueError, match="residual"):
        dip_matmul(torch.randn(4, 64), torch.randn(64, 64), torch.randn(3, 64), epilogue="residual")
    with pytest.raises(ValueError, match="unknown epilogue"):
        api.matmul(x, torch.randn(100, 10), epilogue="relu")


def test_registry_names_and_layouts():
    assert api.list_backends() == ["dip", "dip_ep", "dip_fp8", "dip_fsdp", "dip_int8w", "dip_sp", "dip_tp",
                                   "systolic", "torch", "ws"]
    assert api.get_backend("xla").name == "torch" and api.get_backend("pallas_dip").name == "dip"
    assert api.get_backend("pallas_systolic").name == "systolic"
    assert api.backend_layout("dip") == "dip" and api.backend_layout("ws") == "natural"
    assert api.backend_layout("systolic") == "dip"
    assert api.backend_layout("dip_int8w") == api.backend_layout("dip_fp8") == "dip_q"
    assert (api.get_backend("dip_int8w").scheme, api.get_backend("dip_fp8").scheme) == ("int8", "fp8_e4m3")
    assert api.backend_layout("dip_tp") == api.backend_layout("dip_fsdp") == api.backend_layout("dip_sp") == "sharded"
    assert api.backend_layout("dip_ep") == "sharded"
    with pytest.raises(KeyError, match="unknown matmul backend"):
        api.get_backend("nope")


def test_config_fields_and_values_match_reference():
    rc, pc = ref_get("llama3_8b"), get_config("llama3-8b")
    ref_fields = {f.name: f.default for f in dataclasses.fields(rc)}
    port_fields = {f.name: f.default for f in dataclasses.fields(pc)}
    assert ref_fields == port_fields
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    assert dataclasses.asdict(rc.reduced()) == dataclasses.asdict(pc.reduced())
    assert (rc.padded_vocab, rc.param_count()) == (pc.padded_vocab, pc.param_count())
    for be in ("xla", "pallas_dip", "ws", "pallas_systolic", "dip_int8w", "dip_fp8"):
        assert (dataclasses.replace(rc, matmul_backend=be).uses_dip_storage
                == dataclasses.replace(pc, matmul_backend=be).uses_dip_storage)


@pytest.mark.parametrize("backend", ["dip", "ws"])
def test_int8_accumulates_exactly_in_int32(backend):
    """int8 x int8 on ``dip`` and ``ws``: an exact int32 accumulator and an
    int32 output with no epilogue, as the reference's ``acc_dtype_for``
    defines it (its conformance suite holds these backends to atol=0).  At
    K = 1088 with operands at +-126/127 the sums pass 2^24, where float32
    is no longer exact; an epilogue returns float32."""
    r = np.random.default_rng(7)
    m, k, n = 16, 1088, 70
    x = (127 - (r.random((m, k)) < 0.3)).astype(np.int8)
    w = ((127 - (r.random((k, n)) < 0.3)) * np.where(np.arange(n) % 2, 1, -1)).astype(np.int8)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    assert (np.asarray(_t(x).float() @ _t(w).float(), np.int64) != exact).any()  # f32 would round
    if backend == "dip":
        rw, pw = ref_api.DipWeight.from_natural(jnp.asarray(w)), api.DipWeight.from_natural(_t(w))
        ref_backend = "pallas_dip"
    else:
        rw, pw, ref_backend = jnp.asarray(w), _t(w), "ws"
    want = ref_api.matmul(jnp.asarray(x), rw, backend=ref_backend)
    got = api.matmul(_t(x), pw, backend=backend)
    assert str(np.asarray(want).dtype) == "int32" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), exact)
    b = r.normal(size=(n,)).astype(np.float32)
    got_b = api.matmul(_t(x), pw, backend=backend, epilogue="bias", epilogue_operands=(_t(b),))
    assert got_b.dtype == torch.float32
    assert_close(got_b, np.asarray(ref_api.matmul(jnp.asarray(x), rw, backend=ref_backend, epilogue="bias",
                                                  epilogue_operands=(jnp.asarray(b),))), TOL["float32"])
