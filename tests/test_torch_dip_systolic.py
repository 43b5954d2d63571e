"""The port's ``systolic`` backend (the wavefront kernel module
``kernels/dip_systolic.py``) against ``repro.api.matmul`` with the
reference's ``pallas_systolic`` (``dip_systolic_pallas`` in interpret mode)
on the same numpy inputs, in the two dtypes the reference's conformance
suite holds that backend to: float32 and int8.

Tolerances: float32 1e-5 of max(1, max|reference|) (the same f32 sums in
another order); int8 without an epilogue is exact (atol=0) and int32, as
the reference returns it; int8 with an epilogue is f32 arithmetic on the
same exact int32 sums, so 1e-5 again.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import TOL, assert_close
from repro import api as ref_api
from repro_torch import api
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels.dip_matmul import dip_matmul_plain
from repro_torch.kernels.dip_systolic import dip_systolic, dip_systolic_plain

M, K, N = 37, 100, 70


def _inputs(epilogue, dtype, seed=0):
    r = np.random.default_rng(seed)
    if dtype == "int8":
        x = r.integers(-127, 128, (M, K)).astype(np.int8)
        w, wu = (r.integers(-127, 128, (K, N)).astype(np.int8) for _ in range(2))
        res = r.integers(-127, 128, (M, N)).astype(np.int8)
    else:
        x = r.normal(size=(M, K)).astype(np.float32)
        w, wu = ((r.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32) for _ in range(2))
        res = r.normal(size=(M, N)).astype(np.float32)
    g = (r.random(K) + 0.5).astype(np.float32)
    b = r.normal(size=(N,)).astype(np.float32) * (1000.0 if dtype == "int8" else 1.0)
    s = epi.spec(epilogue)
    ops = (b,) if s.bias else (res,) if s.residual else ()
    return x, w, wu, g, ops


@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
def test_systolic_float32_matches_reference(epilogue, prologue):
    x, w, wu, g, ops = _inputs(epilogue, "float32")
    dual = epi.spec(epilogue).dual_weight
    rw = tuple(ref_api.DipWeight.from_natural(jnp.asarray(a)) for a in (w, wu))
    pw = tuple(api.DipWeight.from_natural(torch.from_numpy(a)) for a in (w, wu))
    rkw = dict(prologue="rmsnorm", prologue_operands=(jnp.asarray(g),)) if prologue == "rmsnorm" else {}
    pkw = dict(prologue="rmsnorm", prologue_operands=(torch.from_numpy(g),)) if prologue == "rmsnorm" else {}
    want = ref_api.matmul(jnp.asarray(x), rw if dual else rw[0], backend="pallas_systolic", epilogue=epilogue,
                          epilogue_operands=tuple(jnp.asarray(o) for o in ops), **rkw)
    got = api.matmul(torch.from_numpy(x), pw if dual else pw[0], backend="pallas_systolic", epilogue=epilogue,
                     epilogue_operands=tuple(torch.from_numpy(o) for o in ops), **pkw)
    assert got.dtype == torch.float32
    assert_close(got, want, TOL["float32"])


@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
def test_systolic_int8_matches_reference(epilogue):
    x, w, wu, _, ops = _inputs(epilogue, "int8", seed=1)
    dual = epi.spec(epilogue).dual_weight
    rw = tuple(ref_api.DipWeight.from_natural(jnp.asarray(a)) for a in (w, wu))
    pw = tuple(api.DipWeight.from_natural(torch.from_numpy(a)) for a in (w, wu))
    want = np.asarray(ref_api.matmul(jnp.asarray(x), rw if dual else rw[0], backend="pallas_systolic",
                                     epilogue=epilogue, epilogue_operands=tuple(jnp.asarray(o) for o in ops)))
    got = api.matmul(torch.from_numpy(x), pw if dual else pw[0], backend="systolic", epilogue=epilogue,
                     epilogue_operands=tuple(torch.from_numpy(o) for o in ops))
    if epilogue == "none":
        assert got.dtype == torch.int32 and str(want.dtype) == "int32"
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64))
    else:
        assert got.dtype == torch.float32 and str(want.dtype) == "float32"
        assert_close(got, want, TOL["float32"])


def test_plain_version_is_the_fast_paths_function():
    """One oracle for both kernels, as in the reference: the wavefront's
    plain version is the DiP matmul's, and the CPU wrapper runs it."""
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.normal(size=(5, 128)).astype(np.float32))
    p = api.DipWeight.from_natural(torch.from_numpy(r.normal(size=(128, 64)).astype(np.float32))).data
    gain = torch.from_numpy((r.random(128) + 0.5).astype(np.float32))
    kw = dict(prologue="rmsnorm", prologue_operands=(gain,))
    assert torch.equal(dip_systolic(x, p, **kw), dip_matmul_plain(x, p, **kw))
    assert torch.equal(dip_systolic_plain(x, p, **kw), dip_matmul_plain(x, p, **kw))
    with pytest.raises(ValueError, match="multiples"):
        dip_systolic(torch.randn(4, 100), torch.randn(100, 64))
