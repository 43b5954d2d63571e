"""The sharded matmul backends on the card: a 2-rank world sharing one card
over the ``host`` transport (gloo groups, payloads copied through host
memory) and a 1-rank NCCL world, so that both transports' branches are
built and run.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false.  On an H100 run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda_sharded.py``.

Every path (tp column and row, fsdp, sp column and row) at small shapes, in
bf16 and f32, with no epilogue, ``bias_silu``, ``swiglu`` and ``residual``,
against the single-rank dispatch of the whole weight on the same card and
against the plain version of the whole product on the CPU, both within
``TOL`` of the output's magnitude; each rank's row partial (the f32 store
for bf16 x) against the plain version on the same card inputs (int8 byte
for byte); the int8 and bf16 row outputs equal to their partials' sum
(two shards, order-free) cast once; the launches counted by the kernels'
own counters equal the communicator's.  At Zamba2-2.7B's shapes: the
``tp`` / ``fsdp`` shards, and the ``sp`` model path's ``dip_sp`` column
launch on one real row and one pad row and its row launch with the
reduce-scatter.  DeepSeek-V2-Lite's MoE layer under ``fsdp`` on gathered
banks against the whole-bank layer.
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed import run_world

import _torch_sharded_ranks as ranks

pytestmark = pytest.mark.cuda

M, K, N = 64, 256, 256
# max|err| <= TOL * max(1, max|want|).  float32: the same IEEE f32 products
# summed in another order (the row paths add the ranks' partials); the bf16
# mainloops' f32 store sums exact bf16 products in f32 alike.  bfloat16: f32
# sums cast once on both sides, which land about one bf16 step (2^-8) apart
# where they straddle a rounding midpoint
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
PATHS = ("tp_col", "tp_row", "fsdp", "sp_col", "sp_row")


def _cases():
    r = np.random.default_rng(0)
    cases = []
    for dtype in ("float32", "bfloat16"):
        x = torch.from_numpy(r.normal(0, 1, (M, K)).astype(np.float32)).to(getattr(torch, dtype)).float().numpy()
        ws = [torch.from_numpy(r.normal(0, 1, (K, N)).astype(np.float32)).to(getattr(torch, dtype)).float().numpy()
              for _ in range(2)]
        b = r.normal(0, 1, (N,)).astype(np.float32)
        res = torch.from_numpy(r.normal(0, 1, (M, N)).astype(np.float32)).to(getattr(torch, dtype)).float().numpy()
        for epilogue in ("none", "bias_silu", "swiglu", "residual"):
            for path in PATHS:
                cases.append(dict(x=x, ws=ws if epilogue == "swiglu" else ws[:1], path=path, dtype=dtype,
                                  epilogue=epilogue, bias=b if epilogue == "bias_silu" else None,
                                  resid=res if epilogue == "residual" else None))
    x = r.normal(0, 1, (M, K)).astype(np.float32)
    w = r.normal(0, 1, (K, N)).astype(np.float32)
    for path in ("tp_row", "sp_row"):
        cases.append(dict(x=x, ws=[w], path=path, dtype="bfloat16", epilogue="none", scheme="int8"))
    return cases


@pytest.fixture(scope="module", params=["host", "nccl"])
def world(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    n = 2 if request.param == "host" else 1
    cases = _cases()
    return request.param, n, cases, run_world(ranks.cuda_rank, n, request.param, cases, timeout=600)


def _close(got, want, dtype, what):
    err = float(np.abs(got - want).max())
    bound = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max|err| {err:.3e} > {bound:.3e}"


def _plain(case):
    """The whole product through the registry on the CPU: the plain
    version."""
    from repro_torch import api

    dt = getattr(torch, case["dtype"])
    full = [api.DipWeight.from_natural(ranks._t(w, dt)) for w in case["ws"]]
    ops = (torch.from_numpy(case["bias"]),) if case.get("bias") is not None else (
        (ranks._t(case["resid"], dt),) if case.get("resid") is not None else ())
    out = api.matmul(ranks._t(case["x"], dt), tuple(full) if len(full) == 2 else full[0], backend="dip",
                     epilogue=case["epilogue"], epilogue_operands=ops)
    return out.float().numpy()


def _global(path, outs):
    if path == "tp_row":
        return outs[0]
    return np.concatenate(outs, -1 if path in ("tp_col", "sp_col") else 0)


def test_every_path_against_the_single_rank_dispatch(world):
    transport, n, cases, res = world
    for i, case in enumerate(cases):
        if case.get("scheme"):
            continue
        got = _global(case["path"], [r[i][0] for r in res])
        _close(got, res[0][i][1], case["dtype"], f"{transport} {case['path']}/{case['epilogue']}/{case['dtype']}")


def test_every_path_against_the_plain_version(world):
    transport, n, cases, res = world
    for i, case in enumerate(cases):
        if case.get("scheme"):  # a K shard's own activation scales: held by its partials below
            continue
        got = _global(case["path"], [r[i][0] for r in res])
        _close(got, _plain(case), case["dtype"], f"{transport} {case['path']}/{case['epilogue']}/{case['dtype']}")


def test_row_partials_against_the_plain_version(world):
    transport, n, cases, res = world
    for i, case in enumerate(cases):
        for r in res:
            if r[i][4] is None:
                continue
            got, want, dtype, launched = r[i][4]
            what = f"{transport} {case['path']}/{case['dtype']}/{case.get('scheme')}"
            assert dtype == "torch.float32" and launched == 1, (what, dtype, launched)
            if case.get("scheme"):
                np.testing.assert_array_equal(got, want, err_msg=what)
            else:
                _close(got, want, "float32", what)


def test_int8_and_bf16_row_partials_sum_to_the_output(world):
    transport, n, cases, res = world
    for i, case in enumerate(cases):
        if res[0][i][4] is None or not (case.get("scheme") or (case["dtype"] == "bfloat16"
                                                               and case["epilogue"] == "none")):
            continue
        partials = [r[i][4][0] for r in res]
        # the f32 partials' sum, cast once to bf16 (x's dtype)
        want = torch.from_numpy(sum(partials[1:], partials[0])).bfloat16().float().numpy()
        got = [r[i][0] for r in res]
        if case["path"] == "tp_row":
            for g in got:
                np.testing.assert_array_equal(g, want)
        else:
            m_loc = -(-M // n)
            for j, g in enumerate(got):
                np.testing.assert_array_equal(g, want[j * m_loc:(j + 1) * m_loc])


def test_kernel_counters_equal_the_logged_launches(world):
    transport, n, cases, res = world
    for i, case in enumerate(cases):
        for r in res:
            counts, counted = r[i][2], r[i][3]
            assert counted == counts["launch"], (transport, case["path"], counts, counted)


# ---- Zamba2-2.7B's shard shapes (the SSM family under tp and fsdp) ----
Z_D, Z_IN, Z_INNER = 2560, 10448, 5120  # d_model, in_proj's in_dim (storage 10496), d_inner


def _zamba2_cases():
    """in_proj column-parallel (5248 storage columns a rank, the last
    rank's 48 of them padding), out_proj row-parallel (K 2560 a rank, the
    residual added once after the all-reduce), and in_proj under dip_fsdp
    (K 1280 a rank, gathered for one whole-width launch on the rank's 2 of
    4 rows); bf16, a decode step's 4 rows."""
    r = np.random.default_rng(29)

    def bf16(*shape):
        return torch.from_numpy(r.normal(0, 1, shape).astype(np.float32)).bfloat16().float().numpy()

    w_in = bf16(Z_D, Z_IN) * Z_D ** -0.5
    return [dict(x=bf16(4, Z_D), ws=[w_in], path="tp_col", dtype="bfloat16", epilogue="none"),
            dict(x=bf16(4, Z_INNER), ws=[bf16(Z_INNER, Z_D) * Z_INNER ** -0.5], path="tp_row", dtype="bfloat16",
                 epilogue="residual", resid=bf16(4, Z_D)),
            dict(x=bf16(4, Z_D), ws=[w_in], path="fsdp", dtype="bfloat16", epilogue="none")]


@pytest.fixture(scope="module")
def zamba2_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    cases = _zamba2_cases()
    return cases, run_world(ranks.cuda_rank, 2, "host", cases, timeout=600)


def test_zamba2_shards_against_single_rank_and_plain(zamba2_world):
    cases, res = zamba2_world
    for i, case in enumerate(cases):
        got = _global(case["path"], [r[i][0] for r in res])
        assert got.shape == (4, Z_IN if case["path"] != "tp_row" else Z_D), (case["path"], got.shape)
        _close(got, res[0][i][1], "bfloat16", f"zamba2 {case['path']} against the single-rank dispatch")
        _close(got, _plain(case), "bfloat16", f"zamba2 {case['path']} against the plain version")
        for r in res:
            counts, counted = r[i][2], r[i][3]
            assert counted == counts["launch"] == 1, (case["path"], counts, counted)
            # one all-gather of the K shards under fsdp; one all-reduce of the row partials; none for a column
            want = {"tp_col": (0, 0), "tp_row": (1, 0), "fsdp": (0, 1)}[case["path"]]
            assert (counts["psum"], counts["all_gather"]) == want, (case["path"], counts)


def test_zamba2_out_proj_row_partial_against_plain(zamba2_world):
    cases, res = zamba2_world
    i = next(j for j, c in enumerate(cases) if c["path"] == "tp_row")
    for r in res:
        got, want, dtype, launched = r[i][4]
        assert dtype == "torch.float32" and launched == 1 and got.shape == (4, Z_D)
        _close(got, want, "float32", "zamba2 out_proj row partial (K 2560 a rank, f32 store)")


def _zamba2_sp_cases():
    """The ``sp`` model path's launches on a Zamba2 tail token (1 real row,
    rank 1 holding a pad row of zeros): in_proj's ``dip_sp`` column (each
    rank its row, then one ring hop: both rows of its 5248 storage
    columns) and out_proj's ``dip_sp`` row (K 2560 a rank, one
    reduce-scatter, the residual added on the rank's row); bf16."""
    r = np.random.default_rng(30)

    def bf16(*shape):
        return torch.from_numpy(r.normal(0, 1, shape).astype(np.float32)).bfloat16().float().numpy()

    def padded(a):
        return np.concatenate([a, np.zeros_like(a)], 0)

    return [dict(x=padded(bf16(1, Z_D)), ws=[bf16(Z_D, Z_IN) * Z_D ** -0.5], path="sp_col", dtype="bfloat16",
                 epilogue="none"),
            dict(x=padded(bf16(1, Z_INNER)), ws=[bf16(Z_INNER, Z_D) * Z_INNER ** -0.5], path="sp_row",
                 dtype="bfloat16", epilogue="residual", resid=padded(bf16(1, Z_D)))]


@pytest.fixture(scope="module")
def zamba2_sp_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    cases = _zamba2_sp_cases()
    return cases, run_world(ranks.cuda_rank, 2, "host", cases, timeout=600)


def test_zamba2_sp_launches_with_a_pad_row_against_single_rank_and_plain(zamba2_sp_world):
    cases, res = zamba2_sp_world
    for i, case in enumerate(cases):
        got = _global(case["path"], [r[i][0] for r in res])
        assert got.shape == (2, Z_IN if case["path"] == "sp_col" else Z_D), (case["path"], got.shape)
        _close(got, res[0][i][1], "bfloat16", f"zamba2 {case['path']} against the single-rank dispatch")
        _close(got, _plain(case), "bfloat16", f"zamba2 {case['path']} against the plain version")
        if case["path"] == "sp_col":  # the pad row stays zero
            assert not np.any(got[1])
        for r in res:
            counts, counted = r[i][2], r[i][3]
            want = {"sp_col": (1, 0, 2), "sp_row": (0, 1, 1)}[case["path"]]  # (ppermute, reduce_scatter, launch)
            assert (counts["ppermute"], counts["reduce_scatter"], counts["launch"]) == want, (case["path"], counts)
            assert counted == counts["launch"], (case["path"], counts, counted)


def test_zamba2_sp_out_proj_row_partial_against_plain(zamba2_sp_world):
    cases, res = zamba2_sp_world
    i = next(j for j, c in enumerate(cases) if c["path"] == "sp_row")
    for r in res:
        got, want, dtype, launched = r[i][4]
        assert dtype == "torch.float32" and launched == 1 and got.shape == (2, Z_D)
        _close(got, want, "float32", "zamba2 out_proj sp row partial (K 2560 a rank, f32 store)")


@pytest.fixture(scope="module")
def deepseek_fsdp_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return run_world(ranks.cuda_moe_fsdp_rank, 2, 1, 128, 30, timeout=900)


def test_deepseek_fsdp_moe_layer_on_gathered_banks_against_the_whole_banks(deepseek_fsdp_world):
    """Layer 0's routed and shared experts at full width: each rank's
    sequence through the banks it gathers (d / 2 of gate and up, ffe / 2
    of down, d / 2 of the router) equals the whole-bank layer's rows
    (bf16 ``TOL``: the shared experts' launch runs the rank's 128 rows
    where the whole layer's runs 256), with the same expert ids."""
    for r, out in enumerate(deepseek_fsdp_world):
        assert out["banks"] == {"router": (1024, 64), "w_gate": (64, 1024, 1408), "w_up": (64, 1024, 1408),
                                "w_down": (64, 704, 2048)}
        assert out["ids_equal"], r
        _close(out["got"], out["want"], "bfloat16", f"rank {r}: the fsdp layer against the whole-bank layer")
        c = out["counts"]  # router + 3 banks + the shared experts' 3 storages; gate+up and down launches
        assert (c["all_gather"], c["launch"], c["psum"]) == (7, 2, 0), c
    assert sum(o["dropped"] for o in deepseek_fsdp_world) == deepseek_fsdp_world[0]["want_dropped"]


# ---------------------------------------------------------- the backward ---
# the collectives' and the backends' backward on the card (the CPU cases of
# test_torch_sharded_train.py, every operand on card 0, 2 ranks over the
# host transport): the shard launches are the kernel's (f32 x, the IEEE
# route) and each backward the f32 recompute, against the single-rank
# dispatch's gradients on the same card within f32 TOL of the largest
from test_torch_sharded_train import CASES as TRAIN_CASES  # noqa: E402
from test_torch_sharded_train import COLLECTIVES, _backward_counts  # noqa: E402


@pytest.fixture(scope="module")
def train_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return run_world(ranks.cuda_train_grad_rank, 2, list(COLLECTIVES), TRAIN_CASES, timeout=600)


def test_collective_backward_on_the_card(train_world):
    for coll, _ in train_world:
        for name, (got, want, counts) in coll.items():
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            assert {k: v for k, v in counts.items() if v} == COLLECTIVES[name], (name, counts)


def test_backend_backward_on_the_card(train_world):
    for _, back in train_world:
        for case, (pairs, _, bwd) in zip(TRAIN_CASES, back):
            for got, want in pairs:
                assert got.shape == want.shape
                err = float(np.abs(got - want).max())
                assert err <= TOL["float32"] * max(1.0, float(np.abs(want).max())), (case, err)
            assert {k: v for k, v in bwd.items() if v} == _backward_counts(**case), (case, bwd)


@pytest.fixture(scope="module")
def pp_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    import _torch_pipeline_ranks as pp_ranks

    return run_world(pp_ranks.cuda_pp_rank, 2, timeout=600)


def test_pipeline_stages_and_pmax_on_the_card(pp_world):
    """``train_step_fn(plan=pp)`` (the pipelined step, 4 microbatches of
    the reduced llama3-8b in f32 over 2 stages) against the single-rank
    step on the card: the loss and norm within 1e-5, every parameter within
    1e-4 of max(1, max|leaf|) (plain AdamW) and within 2 lr where a
    compressed gradient took the neighbouring code; the counts of the CPU
    tests (6 ticks and 4 reverse hops, 4 psums, a pmax when compressing),
    each tick's DiP launches; ``comm.pmax`` of the ranks' values."""
    for r in pp_world:
        np.testing.assert_array_equal(r["pmax"], [1.0, 0.0])
        for name in ("plain", "compressed"):
            g = r[name]
            (lk, lp), (nk, npl) = g["loss"], g["grad_norm"]
            assert abs(lk - lp) <= 1e-5 * max(1.0, abs(lp)) and abs(nk - npl) <= 1e-5 * max(1.0, npl), g
            want = dict(psum=4, all_gather=0, reduce_scatter=0, ppermute=10, all_to_all=0, launch=0)
            assert g["counts"] == (dict(want, pmax=1) if name == "compressed" else want), g["counts"]
            assert g["dip_launches"] == 6 * 1 * 6 + 1  # 6 ticks x 1 layer a stage x 6 launches, the head
            assert max(g["param_err"]) <= (1e-4 if name == "plain" else 1e-4 + 2e-3), g["param_err"]
