"""The port's sharded matmul backends (``dip_tp`` column and row, ``dip_fsdp``,
``dip_sp`` column and row) against the reference.

One gloo world of 4 ranks runs every case (``_torch_sharded_ranks``); the
meshes are (data 1, model 4) for tp and sp, where the reference's counts
assume model = 4, (data 4, model 1) for fsdp and (data 2, model 2) for the
int8 row path.  The global output is the concatenation of the ranks'
outputs along the split dim.  Each case is held against

(a) the reference's single-device dispatch (``pallas_dip`` in interpret
    mode; quantized weights through their scheme's kernel) at the
    tolerances of ``tests/test_sharded_backends.py`` (f32 2e-3; bf16 0.5 /
    0.05; fp8 1e-5), and int8 on the full-K paths also against the
    reference's plain ``dip_matmul_int8w_epilogue_ref``: byte for byte with
    no epilogue (the interpret-mode kernel multiplies the two scales in
    another order, one f32 ulp apart);
(b) for the K-split row paths, the reference's ``shard_map`` body run once
    per shard on one device (each shard's partial through
    ``api.matmul(..., backend="pallas_dip")`` on x widened to f32, as the
    body widens it; int8 shards through the plain reference), summed in
    numpy, the reference's epilogue applied once: f32 within 1e-5 relative,
    bf16 within one bf16 step, int8 with no epilogue byte for byte (two
    shards: the sum is order-free).

The communicator's counts and issue order equal the reference's jaxpr
contract (``tests/test_sharded_backends.py:121-140``, ``:253-262``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from repro import api as rapi
from repro.kernels import epilogue as repi
from repro.kernels import prologue as rpro
from repro.kernels import ref as rref

from repro_torch.distributed import run_world

import _torch_sharded_ranks as ranks

M, K, N = 8, 256, 256
EPILOGUES = ("none", "bias", "bias_gelu", "bias_silu", "swiglu", "residual")
DTYPES = ("float32", "bfloat16")
PATHS = ("tp_col", "tp_row", "fsdp", "sp_col", "sp_row")
TOL = {"float32": dict(atol=2e-3, rtol=2e-3), "bfloat16": dict(atol=0.5, rtol=0.05)}
TOL_B = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=0.125, rtol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(r, epilogue, dtype):
    """The reference test's draws: x, the weight(s), bias, residual (numpy
    f32 holding values exact in ``dtype``)."""
    def draw(shape):
        return np.asarray(jnp.asarray(r.normal(0, 1, shape).astype(np.float32)).astype(JDT[dtype]), np.float32)

    x, wg, wu = draw((M, K)), draw((K, N)), draw((K, N))
    b = r.normal(0, 1, (N,)).astype(np.float32)
    resid = draw((M, N))
    return dict(x=x, ws=[wg, wu] if epilogue == "swiglu" else [wg],
                bias=b if epilogue.startswith("bias") else None, resid=resid if epilogue == "residual" else None)


def _ref_single(case):
    dt = JDT[case["dtype"]]
    x = jnp.asarray(case["x"]).astype(dt)
    ws = [jnp.asarray(w).astype(dt) for w in case["ws"]]
    if case.get("scheme"):
        w = [rapi.quant.quantize(wi, case["scheme"]) for wi in ws]
        backend = None
    else:
        w = [rapi.DipWeight.from_natural(wi) for wi in ws]
        backend = "pallas_dip"
    ops = ()
    if case.get("bias") is not None:
        ops = (jnp.asarray(case["bias"]),)
    elif case.get("resid") is not None:
        ops = (jnp.asarray(case["resid"]).astype(dt),)
    pro = {}
    if case.get("gain") is not None:
        pro = dict(prologue="rmsnorm", prologue_operands=(jnp.asarray(case["gain"]),))
    out = rapi.matmul(x, tuple(w) if len(w) == 2 else w[0], backend=backend, epilogue=case["epilogue"],
                      epilogue_operands=ops, **pro)
    return np.asarray(out.astype(jnp.float32) if jnp.issubdtype(out.dtype, jnp.floating) else out)


def _ref_plain_int8(case):
    """The reference's plain int8 function on the whole weight."""
    qw = rapi.quant.quantize(jnp.asarray(case["ws"][0]), "int8")
    ops = () if case.get("bias") is None else (jnp.asarray(case["bias"]).reshape(1, -1),)
    return np.asarray(rref.dip_matmul_int8w_epilogue_ref(jnp.asarray(case["x"]), qw.data, qw.scale,
                                                         epilogue=case["epilogue"], operands=ops))


def _ref_row_body(case, tp):
    """The reference's row ``shard_map`` body once per shard (module doc,
    (b)); the whole reduced output."""
    dt = JDT[case["dtype"]]
    x = jnp.asarray(case["x"]).astype(dt)
    if case.get("gain") is not None:
        x = rpro.apply("rmsnorm", x, jnp.asarray(case["gain"]))
    kl = K // tp
    parts = []
    for w in case["ws"]:
        if case.get("scheme"):
            full = rapi.quant.quantize(jnp.asarray(w), case["scheme"])
        else:
            full = rapi.DipWeight.from_natural(jnp.asarray(w).astype(dt))
        acc = np.zeros((M, N), np.float32)
        for r in range(tp):
            xl = x[:, r * kl:(r + 1) * kl].astype(jnp.float32)
            if case.get("scheme"):
                part = rref.dip_matmul_int8w_ref(xl, full.data[r * kl:(r + 1) * kl], full.scale)
            else:
                wl = rapi.DipWeight(full.data[r * kl:(r + 1) * kl], kl, N, full.perm_tile)
                part = rapi.matmul(xl, wl, backend="pallas_dip")
            acc = acc + np.asarray(part, np.float32)
        parts.append(acc)
    ep = case["epilogue"]
    if ep == "none":
        return np.asarray(jnp.asarray(parts[0]).astype(dt).astype(jnp.float32))
    if ep == "swiglu":
        aux = (jnp.asarray(parts[1]),)
    elif case.get("bias") is not None:
        aux = (jnp.asarray(case["bias"]),)
    else:
        aux = (jnp.asarray(case["resid"]).astype(jnp.float32),)
    return np.asarray(repi.apply(ep, jnp.asarray(parts[0]), *aux).astype(dt).astype(jnp.float32))


def _cases():
    r = np.random.default_rng(0)
    cases = []
    for epilogue in EPILOGUES:
        for dtype in DTYPES:
            inp = _inputs(r, epilogue, dtype)
            for path in PATHS:
                cases.append(dict(inp, path=path, epilogue=epilogue, dtype=dtype,
                                  mesh="f4" if path == "fsdp" else "m4", name=f"{path}/{epilogue}/{dtype}"))
    gain = r.normal(1, 0.1, (K,)).astype(np.float32)
    for dtype in DTYPES:
        inp = _inputs(r, "none", dtype)
        for path in PATHS:
            cases.append(dict(inp, path=path, epilogue="none", dtype=dtype, gain=gain,
                              mesh="f4" if path == "fsdp" else "m4", name=f"{path}/rmsnorm/{dtype}"))
    r = np.random.default_rng(1)
    x = r.normal(0, 1, (M, K)).astype(np.float32)
    w = r.normal(0, 1, (K, N)).astype(np.float32)
    b = r.normal(0, 1, (N,)).astype(np.float32)
    for scheme in ("int8", "fp8_e4m3"):
        for epilogue in ("none", "bias_silu"):
            for path in ("tp_col", "fsdp", "sp_col"):
                cases.append(dict(x=x, ws=[w], bias=b if epilogue != "none" else None, resid=None, path=path,
                                  epilogue=epilogue, dtype="float32", scheme=scheme,
                                  mesh="f4" if path == "fsdp" else "m4", name=f"{path}/{epilogue}/{scheme}"))
    for epilogue in ("none", "bias_silu"):
        for path in ("tp_row", "sp_row"):
            cases.append(dict(x=x, ws=[w], bias=b if epilogue != "none" else None, resid=None, path=path,
                              epilogue=epilogue, dtype="float32", scheme="int8", mesh="m22",
                              name=f"{path}/{epilogue}/int8"))
    return cases


def _assemble(case, coords, outs):
    """The global output from the ranks' outputs (module doc)."""
    mesh = case["mesh"]
    by = {coords[r][mesh]: outs[r] for r in range(len(outs))}
    path = case["path"]
    if path == "tp_row":
        return by[(0, 0)], [by[c] for c in by]
    if path == "fsdp":
        return np.concatenate([by[(d, 0)] for d in range(4)], 0), None
    tp = 2 if mesh == "m22" else 4
    axis = -1 if path in ("tp_col", "sp_col") else 0
    return np.concatenate([by[(0, j)] for j in range(tp)], axis), None


@pytest.fixture(scope="module")
def world():
    """Every case through the 4-rank world, and the reference's answers."""
    cases = _cases()
    sent = [{k: v for k, v in c.items() if k != "name"} for c in cases]
    results = run_world(ranks.matmul_rank, 4, sent, timeout=240)
    coords = [res[0] for res in results]
    out = {}
    for i, case in enumerate(cases):
        per_rank = [res[1][i] for res in results]
        got, replicas = _assemble(case, coords, [p[0] for p in per_rank])
        tp = 2 if case["mesh"] == "m22" else 4
        out[case["name"]] = dict(case=case, got=got, replicas=replicas, counts=per_rank[0][1],
                                 schedule=per_rank[0][2], dtype=per_rank[0][3], want=_ref_single(case),
                                 body=_ref_row_body(case, tp) if case["path"] in ("tp_row", "sp_row") else None,
                                 plain=_ref_plain_int8(case) if case.get("scheme") == "int8" else None)
    return out


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("epilogue", EPILOGUES + ("rmsnorm",))
def test_sharded_dispatch_matches_reference(world, path, dtype, epilogue):
    res = world[f"{path}/{epilogue}/{dtype}"]
    assert res["got"].shape == res["want"].shape
    assert res["dtype"] == f"torch.{dtype}"
    np.testing.assert_allclose(res["got"], res["want"], **TOL[dtype], err_msg=f"{path}/{epilogue}/{dtype}")
    if res["replicas"] is not None:  # every rank of a tp row holds the same whole output
        for rep in res["replicas"]:
            np.testing.assert_array_equal(rep, res["got"])
    if res["body"] is not None:
        np.testing.assert_allclose(res["got"], res["body"], **TOL_B[dtype], err_msg=f"(b) {path}/{epilogue}")


@pytest.mark.parametrize("path", ("tp_col", "fsdp", "sp_col"))
@pytest.mark.parametrize("epilogue", ("none", "bias_silu"))
@pytest.mark.parametrize("scheme", ("int8", "fp8_e4m3"))
def test_quantized_full_k_paths(world, path, epilogue, scheme):
    """Column / fsdp keep the whole contraction per shard: int8 equals the
    reference's plain single-device function byte for byte with no
    epilogue (the same activation codes, int32 sums and scale order); both
    schemes within 1e-5 of the reference's kernel."""
    res = world[f"{path}/{epilogue}/{scheme}"]
    np.testing.assert_allclose(res["got"], res["want"], atol=1e-5, rtol=1e-5)
    if scheme == "int8" and epilogue == "none":
        np.testing.assert_array_equal(res["got"], res["plain"])
    elif scheme == "int8":
        np.testing.assert_allclose(res["got"], res["plain"], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("path", ("tp_row", "sp_row"))
@pytest.mark.parametrize("epilogue", ("none", "bias_silu"))
def test_int8_row_paths_follow_the_shard_body(world, path, epilogue):
    """The K-split int8 path quantizes each shard's x with the shard's own
    row maxima: byte for byte the reference body's (b) with no epilogue
    (within 1e-6 through silu), and within the reference's int8 bound (2%
    of max|y|) of the float product."""
    res = world[f"{path}/{epilogue}/int8"]
    if epilogue == "none":
        np.testing.assert_array_equal(res["got"], res["body"])
        want_f = np.asarray(rref.ws_matmul_ref(jnp.asarray(res["case"]["x"]), jnp.asarray(res["case"]["ws"][0])))
        assert np.abs(res["got"] - want_f).max() / np.abs(want_f).max() < 0.02
    else:
        np.testing.assert_allclose(res["got"], res["body"], atol=1e-6, rtol=1e-6)


def _counts(world, name):
    c = world[name]["counts"]
    return {k: c[k] for k in c}


def test_collective_counts_match_the_reference_contract(world):
    """``tests/test_sharded_backends.py:121-140`` and ``:253-262``."""
    c = _counts(world, "tp_col/none/float32")
    assert c["psum"] == 0 and c["all_gather"] == 0 and c["launch"] == 1, c
    c = _counts(world, "tp_col/swiglu/float32")
    assert c["psum"] == 0 and c["launch"] == 1, c
    c = _counts(world, "tp_row/none/float32")
    assert c["psum"] == 1 and c["all_gather"] == 0 and c["launch"] == 1, c
    c = _counts(world, "tp_row/swiglu/float32")
    assert c["psum"] == 1 and c["launch"] == 2, c  # ONE psum for the pair
    c = _counts(world, "tp_row/bias_silu/float32")
    assert c["psum"] == 1, c
    c = _counts(world, "fsdp/none/float32")
    assert c["all_gather"] == 1 and c["psum"] == 0 and c["launch"] == 1, c
    c = _counts(world, "fsdp/swiglu/float32")
    assert c["all_gather"] == 2 and c["psum"] == 0 and c["launch"] == 1, c
    c = _counts(world, "sp_col/none/float32")
    assert c["all_gather"] == 0 and c["psum"] == 0, c
    assert c["ppermute"] == 3 and c["launch"] == 4, c
    c = _counts(world, "sp_col/swiglu/float32")
    assert c["launch"] == 4 and c["psum"] == 0, c
    c = _counts(world, "sp_row/none/float32")
    assert c["reduce_scatter"] == 1 and c["psum"] == 0, c
    assert c["launch"] == 1 and c["all_gather"] == 0, c
    # the row prologue's whole-row sum of squares is one more psum
    assert _counts(world, "tp_row/rmsnorm/float32")["psum"] == 2
    assert _counts(world, "tp_col/rmsnorm/float32")["psum"] == 0


def test_sp_ring_issues_each_hop_before_its_launch(world):
    sched = world["sp_col/none/float32"]["schedule"]
    assert sched[0] == "ppermute", sched
    assert sched[:4] == ["ppermute", "launch"] * 2, sched
    assert sched == ["ppermute", "launch"] * 3 + ["launch"], sched
    assert world["tp_row/swiglu/float32"]["schedule"] == ["launch", "launch", "psum"]
    assert world["sp_row/swiglu/float32"]["schedule"] == ["launch", "launch", "reduce_scatter", "reduce_scatter"]


def test_world_timeout_fails_instead_of_hanging():
    """A rank that never returns fails the call within its timeout."""
    with pytest.raises(TimeoutError):
        run_world(ranks.sleep_rank, 2, 60.0, timeout=8)


def test_rank_error_carries_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_world(ranks.fail_rank, 2, timeout=60)
