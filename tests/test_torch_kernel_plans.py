"""The plans the port's wrappers hand to the Hopper kernels, checked on the CPU.

``kernels/dip_matmul.py::matmul_plan`` shapes the tensor-core DiP matmul
(regime by M, block tile, K splits, grid) for bf16 weights and for the
one-byte weights of ``dip_matmul_q`` (``weight_bytes=1``: e4m3 and int8);
``kernels/dip_systolic.py::systolic_plan`` shapes the wavefront kernel on
the CUDA cores; ``kernels/dip_matmul_q.py::q_route`` and
``kernels/flash_attention.py::flash_route`` pick a kernel by dtypes and
head dims, and ``flash_plan`` the flash route, its query tile and its
splits of the keys by the shapes; ``kernels/_build.py::check_aligned`` is the alignment check
every wrapper runs before a launch.
All are plain Python, so their contracts are held here; the kernels
themselves are held against their plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``-m cuda``).
"""

import inspect

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.dip_matmul import DECODE_MAX_M, TILE, dip_matmul, matmul_plan
from repro_torch.kernels.dip_matmul_q import dip_matmul_q, q_route
from repro_torch.kernels.dip_systolic import SYSTOLIC_DECODE_MAX_M, dip_systolic, systolic_plan
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (KV_TILE, SPLIT_MAX_SQ, TC_HEAD_DIMS, attention_plain, flash_attention,
                                                 flash_plan, flash_route, split_count, split_ranges)

SMS = 132  # an H100 SXM

_ARCH = get_config("llama3-8b")
_D, _FF, _KV, _VOCAB = _ARCH.d_model, _ARCH.d_ff, _ARCH.n_kv_heads * _ARCH.resolved_head_dim, _ARCH.padded_vocab
# (label, K, N, swiglu) of every projection a llama3-8b forward sends to the kernel
LLAMA_PROJECTIONS = [("q", _D, _D, False), ("k/v", _D, _KV, False), ("o", _D, _D, False),
                     ("gate+up", _D, _FF, True), ("down", _FF, _D, False), ("lm_head", _D, _VOCAB, False)]
_DS = get_config("deepseek-v2-lite-16b")
_DS_D, _DS_H, _DS_SFF = _DS.d_model, _DS.n_heads, _DS.n_shared_experts * _DS.d_ff_expert
# (label, K, N, swiglu) of every projection a DeepSeek-V2-Lite forward sends
# to the kernel: the MLA projections (q, the latent, the shared RoPE key, the
# out projection), the shared experts' gate+up and down, the lm_head; the
# routed experts' banks are plain einsums, as in the reference
DEEPSEEK_PROJECTIONS = [
    ("wq", _DS_D, _DS_H * (_DS.qk_nope_head_dim + _DS.qk_rope_head_dim), False),
    ("w_dkv", _DS_D, _DS.kv_lora_rank, False), ("w_krope", _DS_D, _DS.qk_rope_head_dim, False),
    ("wo", _DS_H * _DS.v_head_dim, _DS_D, False), ("shared gate+up", _DS_D, _DS_SFF, True),
    ("shared down", _DS_SFF, _DS_D, False), ("lm_head", _DS_D, _DS.padded_vocab, False)]
# the (M, N, K) of the card tests' bf16 cases (tests/test_torch_cuda_kernels.py)
CARD_CASES = [(m, n, 1088) for m in (1, 4, 16, 100, 257) for n in (192, 320, 4096)]
# and of their fp8-route cases
FP8_CARD_CASES = [(m, n, 1088) for m in (1, 4, 32, 33, 257) for n in (192, 320, 4096)]
# and of the int8 route's (the same plan, weight_bytes=1)
INT8_CARD_CASES = [(m, n, 1088) for m in (1, 4, 32, 33, 256, 4096) for n in (192, 320, 4096)]
# and of the wavefront's (systolic_plan)
SYSTOLIC_CARD_CASES = [(m, n, 1088) for m in (1, 4, 13, 17, 100) for n in (192, 320, 4096)]
WEIGHT_BYTES = pytest.mark.parametrize("weight_bytes", [2, 1], ids=["bf16", "fp8"])


def _cdiv(a, b):
    return -(-a // b)


@WEIGHT_BYTES
@pytest.mark.parametrize("dual", [False, True], ids=["single", "swiglu"])
@pytest.mark.parametrize("m", [1, 4, 16, 32, 33, 64, 100, 256, 257, 4092, 4096])
@pytest.mark.parametrize("label,k,n", [(lab, k, n) for lab, k, n, _ in LLAMA_PROJECTIONS + DEEPSEEK_PROJECTIONS]
                         + [("ragged", 1088, 192), ("ragged", 1088, 320), ("short", 64, 64)])
def test_splits_cover_k_once_in_order(label, k, n, m, dual, weight_bytes):
    """The splits tile K exactly once, in 64-deep steps, in split order,
    with no empty split; only the last may be short."""
    plan = matmul_plan(m, n, k, dual, SMS, weight_bytes)
    # split s covers K tiles [s kps, (s + 1) kps) (dip_matmul.cu), and the
    # second pass adds the splits in that order
    step = plan.k_tiles_per_split * TILE
    ranges = [(s * step, min(k, (s + 1) * step)) for s in range(plan.splits)]
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1, "splits must be contiguous and in order"
    for i, (b, e) in enumerate(ranges):
        assert b % TILE == 0 and e % TILE == 0 and e > b
        assert e - b == plan.k_tiles_per_split * TILE or i == plan.splits - 1
    # the kernel's own check of the plan (dip_matmul.cu::launch_bf16)
    k_tiles = k // TILE
    assert plan.splits * plan.k_tiles_per_split >= k_tiles > (plan.splits - 1) * plan.k_tiles_per_split


@WEIGHT_BYTES
@pytest.mark.parametrize("dual", [False, True], ids=["single", "swiglu"])
@pytest.mark.parametrize("m", [1, 4, 16, 100, 256, 257, 4096])
@pytest.mark.parametrize("k,n", [(1088, 192), (4096, 14336), (14336, 4096), (4096, 129024)])
def test_plan_tiles_and_grid(k, n, m, dual, weight_bytes):
    """The decode tile is 32 x 64, but 32 x 128 for a single e4m3 weight:
    every decode block reads 128-byte segments of each weight row."""
    plan = matmul_plan(m, n, k, dual, SMS, weight_bytes)
    if m <= DECODE_MAX_M:
        assert (plan.regime, plan.bm, plan.bn) == ("decode", 32, 128 if weight_bytes == 1 and not dual else 64)
    else:
        assert (plan.regime, plan.bm, plan.bn) == ("prefill", 128, 64 if dual else 128)
    assert plan.grid == (_cdiv(n, plan.bn), _cdiv(m, plan.bm), plan.splits)
    assert plan.blocks == plan.grid[0] * plan.grid[1] * plan.grid[2]


@WEIGHT_BYTES
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("label,k,n,dual", LLAMA_PROJECTIONS, ids=[p[0] for p in LLAMA_PROJECTIONS])
def test_decode_grid_fills_the_card(label, k, n, dual, m, weight_bytes):
    """At the llama3-8b decode shapes every projection puts at least one
    block on every SM (the weights must stream from all of them); the fp8
    plan rounds its splits so that both resident blocks of every SM stream,
    2 x SMs blocks."""
    plan = matmul_plan(m, n, k, dual, SMS, weight_bytes)
    assert plan.regime == "decode"
    floor = 2 * SMS if weight_bytes == 1 else SMS
    assert plan.blocks >= floor, f"{label}: {plan.blocks} blocks on {SMS} SMs"


def test_deepseek_projection_shapes():
    """The widths the DeepSeek-V2-Lite path gives the kernel: N = 64 (the
    shared RoPE key), 512 and 3072, swiglu N = 2816 over K = 2048, down
    K = 2816, the lm_head N = 102400, all multiples of the 64-wide tile."""
    assert [(k, n) for _, k, n, _ in DEEPSEEK_PROJECTIONS] == [
        (2048, 3072), (2048, 512), (2048, 64), (2048, 2048), (2048, 2816), (2816, 2048), (2048, 102400)]
    assert all(k % TILE == 0 and n % TILE == 0 for _, k, n, _ in DEEPSEEK_PROJECTIONS)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("label,k,n,dual", DEEPSEEK_PROJECTIONS, ids=[p[0] for p in DEEPSEEK_PROJECTIONS])
def test_deepseek_decode_grid_fills_the_card(label, k, n, dual, m):
    """At the DeepSeek decode shapes every projection streams its weights
    from every SM, 2 x SMs blocks where it has that many 64-deep tile
    columns to split; the narrow ones stop at one block per 32 x 64 tile of
    their weight (w_dkv: 8 column tiles x 32 K tiles, w_krope: 1 x 32), as
    K cannot be split finer than a tile."""
    plan = matmul_plan(m, n, k, dual, SMS)
    tiles, k_tiles = _cdiv(n, plan.bn), k // TILE
    assert plan.regime == "decode" and plan.bn == 64
    assert plan.blocks >= min(SMS, tiles * k_tiles), f"{label}: {plan.blocks} blocks on {SMS} SMs"
    if tiles * k_tiles < 2 * SMS:
        assert plan.splits == k_tiles, f"{label}: K split once per tile"
    if label in ("wq", "shared gate+up", "shared down", "lm_head"):
        assert plan.blocks >= 2 * SMS, f"{label}: {plan.blocks} blocks"


@pytest.mark.parametrize("m", [33, 256, 257])
def test_narrow_n_on_the_prefill_tile(m):
    """N = 64 (w_krope) is half of the 128-wide prefill tile: one column of
    blocks, whose loads past N are zero-filled and stores masked
    (dip_matmul.cu), with K split across the card."""
    plan = matmul_plan(m, 64, 2048, False, SMS)
    assert (plan.regime, plan.bm, plan.bn) == ("prefill", 128, 128)
    assert plan.grid[0] == 1 and plan.grid[1] == _cdiv(m, 128)
    assert plan.splits > 1 and plan.blocks <= 3 * SMS // 2


@WEIGHT_BYTES
@pytest.mark.parametrize("label,k,n,dual", LLAMA_PROJECTIONS, ids=[p[0] for p in LLAMA_PROJECTIONS])
def test_prefill_chunk_plan(label, k, n, dual, weight_bytes):
    """A 256-token prefill chunk runs the prefill tiles; where they fill
    fewer SMs than the card has, K is split into about one wave of blocks
    (the same for e4m3 weights: the products are the same bf16 ones)."""
    plan = matmul_plan(256, n, k, dual, SMS, weight_bytes)
    assert plan == matmul_plan(256, n, k, dual, SMS)
    assert plan.regime == "prefill"
    tiles = plan.grid[0] * plan.grid[1]
    assert plan.splits == 1 or tiles < SMS
    if tiles < SMS:
        assert SMS // 2 < plan.blocks <= 3 * SMS // 2


@pytest.mark.parametrize("weight_bytes,cases", [(2, CARD_CASES), (1, FP8_CARD_CASES), (1, INT8_CARD_CASES)],
                         ids=["bf16", "fp8", "int8"])
def test_card_cases_reach_every_path(weight_bytes, cases):
    """The card tests' bf16, fp8 and int8 cases cover both regimes, a
    split-K plan with a ragged last split, a block whose K range is longer
    than the ring of stages (4 or 5), and N not a multiple of the block's N
    (for one-byte weights also of the 128-column decode tile)."""
    plans = [(matmul_plan(m, n, k, dual, SMS, weight_bytes), m, n, k) for m, n, k in cases for dual in (False, True)]
    assert {p.regime for p, *_ in plans} == {"decode", "prefill"}
    assert any(p.splits > 1 and (k // TILE) % p.k_tiles_per_split for p, m, n, k in plans)
    assert any(p.k_tiles_per_split > (4 if weight_bytes == 2 else 5) for p, *_ in plans)
    assert any(n % p.bn for p, m, n, k in plans)
    assert weight_bytes == 2 or any(n % p.bn for p, m, n, k in plans if p.regime == "decode")
    assert {m for _, m, _, _ in plans} >= ({1, 4, 16, 100, 257} if weight_bytes == 2 else {1, 4, 32, 33, 257}
                                           if cases is FP8_CARD_CASES else {1, 4, 32, 33, 256, 4096})


@pytest.mark.parametrize("dual", [False, True], ids=["single", "swiglu"])
@pytest.mark.parametrize("m", [1, 4, 13, 16, 17, 32, 100, 256, 257, 4096])
@pytest.mark.parametrize("label,k,n", [(lab, k, n) for lab, k, n, _ in LLAMA_PROJECTIONS]
                         + [("ragged", 1088, 192), ("ragged", 1088, 320), ("short", 64, 64)])
def test_systolic_splits_cover_k_once_in_order(label, k, n, m, dual):
    """The wavefront's splits tile K exactly once, in 64-deep steps, in
    split order, with no empty split (dip_systolic.cu's own check of the
    plan included); within a split the kernel walks its tiles in ascending
    K, so each output's sum runs over K in order."""
    plan = systolic_plan(m, n, k, SMS, dual)
    step = plan.k_tiles_per_split * TILE
    ranges = [(s * step, min(k, (s + 1) * step)) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(e0 == b1 for (_, e0), (b1, _) in zip(ranges, ranges[1:]))
    assert all(e > b and b % TILE == 0 for b, e in ranges)
    k_tiles = k // TILE
    assert plan.splits * plan.k_tiles_per_split >= k_tiles > (plan.splits - 1) * plan.k_tiles_per_split


@pytest.mark.parametrize("dual", [False, True], ids=["single", "swiglu"])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 256, 4096])
@pytest.mark.parametrize("k,n", [(1088, 192), (4096, 14336), (14336, 4096), (4096, 129024)])
def test_systolic_plan_tiles_and_grid(k, n, m, dual):
    """Decode (M <= 16): 16-row blocks of 128 columns a weight; prefill:
    32-row blocks of 256 columns, 128 a weight for swiglu (a thread's 8 x 8
    or 8 x 4 registers of each weight)."""
    plan = systolic_plan(m, n, k, SMS, dual)
    if m <= SYSTOLIC_DECODE_MAX_M:
        assert (plan.regime, plan.bm, plan.bn) == ("decode", 16, 128)
    else:
        assert (plan.regime, plan.bm, plan.bn) == ("prefill", 32, 128 if dual else 256)
    assert plan.grid == (_cdiv(n, plan.bn), _cdiv(m, plan.bm), plan.splits)
    assert plan.blocks == plan.grid[0] * plan.grid[1] * plan.grid[2]


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("label,k,n,dual", LLAMA_PROJECTIONS, ids=[p[0] for p in LLAMA_PROJECTIONS])
def test_systolic_decode_grid_fills_the_card(label, k, n, dual, m):
    """At the llama3-8b decode shapes the wavefront's K split puts at least
    2 x SMs blocks on the card (two resident blocks an SM), so that every
    SM streams weights; the prefill chunk splits only where that cuts the
    waves of whole-K work by 5% or more, and never below the unsplit
    plan's."""
    plan = systolic_plan(m, n, k, SMS, dual)
    assert plan.regime == "decode" and plan.blocks >= 2 * SMS, f"{label}: {plan.blocks} blocks"
    chunk = systolic_plan(256, n, k, SMS, dual)
    tiles, slots = chunk.grid[0] * chunk.grid[1], 2 * SMS
    assert chunk.regime == "prefill"
    waves = lambda s: _cdiv(tiles * s, slots) / s  # noqa: E731
    assert chunk.splits == 1 or waves(chunk.splits) < 0.95 * waves(1)
    assert all(waves(chunk.splits) <= waves(s) / 0.95 for s in range(1, min(k // TILE, 32) + 1))


def test_systolic_card_cases_reach_every_path():
    """The card tests' wavefront cases cover both regimes, a decode split
    with a ragged last split, a block longer than its ring (2 or 3 stages),
    a decode warp whose rows all lie past M, and N not a multiple of the
    block's N."""
    plans = [(systolic_plan(m, n, k, SMS, dual), m, n, k) for m, n, k in SYSTOLIC_CARD_CASES for dual in (False, True)]
    assert {p.regime for p, *_ in plans} == {"decode", "prefill"}
    assert any(p.splits > 1 and (k // TILE) % p.k_tiles_per_split for p, m, n, k in plans)
    assert any(p.k_tiles_per_split > 3 for p, *_ in plans)
    assert any(p.regime == "decode" and m <= 12 for p, m, *_ in plans)
    assert any(n % p.bn for p, m, n, k in plans)


ROUTE_CASES = ([(torch.bfloat16, d, d, "tensor_cores") for d in TC_HEAD_DIMS]
               + [(torch.float32, d, d, "tensor_cores") for d in (64, 128)]
               + [(torch.bfloat16, 192, 128, "tensor_cores"), (torch.bfloat16, 128, 64, "cuda_cores"),
                  (torch.bfloat16, 48, 48, "tensor_cores"), (torch.bfloat16, 40, 40, "cuda_cores"),
                  (torch.bfloat16, 256, 256, "cuda_cores"), (torch.bfloat16, 32, 32, "tensor_cores"),
                  (torch.float16, 128, 128, "cuda_cores"), (torch.bfloat16, 48, 32, "tensor_cores"),
                  (torch.float32, 48, 32, "tensor_cores"), (torch.float32, 192, 128, "tensor_cores"),
                  (torch.float32, 32, 32, "tensor_cores"), (torch.float32, 128, 64, "cuda_cores"),
                  (torch.float32, 40, 40, "cuda_cores"), (torch.float32, 256, 256, "cuda_cores")])


@pytest.mark.parametrize("dtype,d,dv,route", ROUTE_CASES,
                         ids=[f"{str(c[0]).split('.')[-1]}-{c[1]}-{c[2]}" for c in ROUTE_CASES])
def test_flash_route(dtype, d, dv, route):
    assert flash_route(dtype, d, dv) == route


# (BH, Sq, Sk) of flash calls: Zamba2's prefill tail and chunk, llama3-8b's
# chunk and short last chunks, one head, long and short caches
FLASH_SHAPES = [(32, 1, 1024), (32, 256, 1024), (32, 29, 1024), (32, 64, 1024), (32, 65, 1024), (1, 1, 32768),
                (4, 16, 700), (8, 3, 640), (6, 1, 40), (2, 2, 900), (256, 1, 1024), (1, 1, 0), (64, 16, 4096)]


@pytest.mark.parametrize("bh,sq,sk", FLASH_SHAPES)
@pytest.mark.parametrize("d", TC_HEAD_DIMS)
def test_flash_plan_splits_cover_the_keys_once(bh, sq, sk, d):
    """The tensor-core head dims in bf16: Sq <= SPLIT_MAX_SQ takes
    split_kv with 16-row query tiles, and its splits are whole 64-key tiles
    that cover [0, Sk) once, in order, none empty, the grid no larger than
    one wave unless a single split already is; longer queries take the
    unsplit 64-row tiles."""
    route, q_tile, splits = flash_plan(bh, sq, sk, d, d, torch.bfloat16, SMS)
    if sq > SPLIT_MAX_SQ:
        assert (route, q_tile, splits) == ("tensor_cores", 64, 1)
        return
    assert (route, q_tile) == ("split_kv", 16) and 1 <= splits <= fa.MAX_SPLITS
    ranges = split_ranges(sk, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == sk
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges) or sk == 0
    assert all(lo % KV_TILE == 0 for lo, _ in ranges)
    blocks = bh * -(-sq // 16)
    assert splits == 1 or blocks * splits <= SMS


def test_flash_plan_at_zamba2_shapes():
    """Zamba2's shared block, 32 heads of 80: a tail token (Sq = 1) is
    split over the keys and fills one wave; a 256-token chunk is not
    split, 128 blocks of 64 rows; f32 takes the same plan."""
    route, q_tile, splits = flash_plan(32, 1, 1024, 80, 80, torch.bfloat16, SMS)
    assert (route, q_tile) == ("split_kv", 16) and splits > 1 and SMS - 32 < 32 * splits <= SMS
    assert flash_plan(32, 256, 1024, 80, 80, torch.bfloat16, SMS) == ("tensor_cores", 64, 1)
    for sq in (1, 256):
        assert flash_plan(32, sq, 1024, 80, 80, torch.float32, SMS) == flash_plan(32, sq, 1024, 80, 80,
                                                                                  torch.bfloat16, SMS)


@pytest.mark.parametrize("dtype,d,dv", [(torch.bfloat16, 128, 64), (torch.float16, 80, 80), (torch.bfloat16, 40, 40),
                                        (torch.bfloat16, 256, 256), (torch.float32, 128, 64), (torch.float32, 40, 40)])
@pytest.mark.parametrize("sq", [1, 16, 256])
def test_flash_plan_keeps_other_dtypes_and_head_dims_on_the_cuda_cores(dtype, d, dv, sq):
    """fp16, D not a multiple of 16, D above 128 but for (192, 128), and
    the pairs with Dv != D other than (48, 32) and (192, 128) take the
    CUDA-core kernel at every Sq, unsplit."""
    assert flash_plan(32, sq, 1024, d, dv, dtype, SMS) == ("cuda_cores", 64, 1)


@pytest.mark.parametrize("dtype,d,dv", [(torch.bfloat16, 32, 32), (torch.bfloat16, 48, 48), (torch.float32, 80, 80),
                                        (torch.float32, 128, 128), (torch.float32, 192, 128),
                                        (torch.bfloat16, 48, 32), (torch.float32, 32, 32), (torch.float32, 48, 32)])
@pytest.mark.parametrize("sq", [1, 16, 256])
def test_flash_plan_takes_f32_and_the_reduced_head_dims_to_the_tensor_cores(dtype, d, dv, sq):
    """The reduced models' head dims (D = 32, 48 and the MLA pair (48, 32))
    in bf16 and f32, and f32 at every tensor-core pair, which took the
    CUDA-core kernel before: split_kv at Sq <= SPLIT_MAX_SQ, the unsplit
    64-row tiles above, the same plan as bf16."""
    want = ("tensor_cores", 64, 1) if sq > SPLIT_MAX_SQ else ("split_kv", 16, split_count(32, sq, 1024, SMS))
    assert flash_plan(32, sq, 1024, d, dv, dtype, SMS) == want
    assert flash_plan(32, sq, 1024, d, dv, torch.bfloat16, SMS) == want


@pytest.mark.parametrize("bh,sq,sk", FLASH_SHAPES)
def test_flash_plan_takes_the_mla_pair_to_the_tensor_cores(bh, sq, sk):
    """DeepSeek-V2-Lite's whole-prompt MLA forward, bf16 with D = 192 (nope
    + rope) and Dv = 128: split_kv with 16-row query tiles at Sq <=
    SPLIT_MAX_SQ, its splits whole 64-key tiles covering [0, Sk) once, in
    order, none empty; the unsplit 64-row tiles above."""
    route, q_tile, splits = flash_plan(bh, sq, sk, 192, 128, torch.bfloat16, SMS)
    if sq > SPLIT_MAX_SQ:
        assert (route, q_tile, splits) == ("tensor_cores", 64, 1)
        return
    assert (route, q_tile) == ("split_kv", 16) and 1 <= splits <= fa.MAX_SPLITS
    assert splits == split_count(bh, sq, sk, SMS)
    ranges = split_ranges(sk, splits)
    assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == sk
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges) or sk == 0
    assert all(lo % KV_TILE == 0 for lo, _ in ranges)


def test_flash_plan_takes_only_host_integers():
    """The plan reads shapes, the dtype and the SM count: no argument can
    carry q_offset or kv_len, which live on the card, so planning a call
    never waits for the device."""
    params = inspect.signature(flash_plan).parameters
    assert list(params) == ["bh", "sq", "sk", "d", "dv", "dtype", "sms"]
    assert [p.annotation for p in params.values()] == ["int"] * 5 + ["torch.dtype", "int"]


def test_per_row_values_reach_the_kernels_without_a_launch():
    """q_offset and kv_len as the kernels take them, (tensor, step, value,
    wide): an integer by value, an int32 or int64 position tensor of the
    call's device as it is (one element: step 0), anything else converted
    to int32 once; a wrong element count is refused."""
    dev = torch.device("cpu")
    assert fa._per_row_arg(None, 4, 1024, dev) == (None, 0, 1024, 0)
    assert fa._per_row_arg(700, 4, 0, dev) == (None, 0, 700, 0)
    pos = torch.tensor(700)  # a 0-d int64 position, as the models pass q_offset
    t, step, value, wide = fa._per_row_arg(pos, 4, 0, dev)
    assert (step, value, wide) == (0, 0, 1) and t.data_ptr() == pos.data_ptr()
    rows = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    t, step, value, wide = fa._per_row_arg(rows, 4, 0, dev)
    assert (step, wide) == (1, 0) and t.data_ptr() == rows.data_ptr()
    t, step, _, wide = fa._per_row_arg(torch.tensor([5.0, 6.0, 7.0, 8.0]), 4, 0, dev)
    assert (t.dtype, step, wide) == (torch.int32, 1, 0) and t.tolist() == [5, 6, 7, 8]
    with pytest.raises(ValueError, match="per-row"):
        fa._per_row_arg(torch.tensor([1, 2]), 4, 0, dev)


def _split_merge_emulated(q, k, v, q_offset, kv_len, splits):
    """split_kv's arithmetic in f32 torch: each split's (m, l, unnormalised
    O) over its keys (m = -inf, l = 0 where a row sees none of them), then
    the merge in split order with weights exp(m_s - M), as the last block
    computes it."""
    bh, sq, d = q.shape
    s = torch.einsum("bqd,bkd->bqk", q * d ** -0.5, k)
    k_pos = torch.arange(k.shape[1])
    q_pos = torch.as_tensor(q_offset).view(-1, 1) + torch.arange(sq)
    live = (k_pos < torch.as_tensor(kv_len).view(-1, 1, 1)) & (q_pos[..., None] >= k_pos)
    live = live.expand(bh, sq, -1)
    parts = []
    for lo, hi in split_ranges(k.shape[1], splits):
        sl, lv = s[..., lo:hi], live[..., lo:hi]
        m = torch.where(lv, sl, torch.tensor(-torch.inf)).amax(-1, keepdim=True)
        p = torch.where(lv, torch.exp(sl - torch.where(torch.isinf(m), 0.0, m)), 0.0)
        parts.append((m, p.sum(-1, keepdim=True), p @ v[:, lo:hi]))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    acc, den = torch.zeros(bh, sq, v.shape[2]), torch.zeros(bh, sq, 1)
    for m, l, o in parts:
        w = torch.where(torch.isinf(m), 0.0, torch.exp(m - torch.where(torch.isinf(big_m), 0.0, big_m)))
        acc, den = acc + w * o, den + w * l
    return acc / den.clamp(min=1e-30)


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_split_kv_merge_arithmetic_matches_plain(splits):
    """The partials of whole-tile key ranges merged in split order give
    attention_plain's output (f32, 1e-5), with wholly dead splits and a
    kv_len 0 row (exactly 0) among them."""
    g = torch.Generator().manual_seed(splits)
    q, k, v = (torch.randn(3, s, 80, generator=g) for s in (4, 300, 300))
    q_offset, kv_len = torch.tensor([70, 200, 296]), torch.tensor([74, 0, 300])
    got = _split_merge_emulated(q, k, v, q_offset, kv_len, splits)
    want = attention_plain(q, k, v, q_offset=q_offset, kv_len=kv_len)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert (got[1] == 0).all()


def test_cpu_calls_launch_nothing():
    """CPU tensors take the plain versions: no launch is counted."""
    counters = lambda: (flash_attention.launches, flash_attention.launches_tc, flash_attention.launches_split,  # noqa: E731
                        dip_matmul.launches, dip_matmul_q.launches, dip_matmul_q.launches_tc,
                        dip_matmul_q.launches_quant, dip_systolic.launches)
    before = counters()
    q = torch.randn(2, 5, 64, dtype=torch.bfloat16)
    flash_attention(q, q, q)
    dip_matmul(torch.randn(3, 64, dtype=torch.bfloat16), torch.randn(64, 192, dtype=torch.bfloat16))
    dip_matmul_q(torch.randn(3, 64, dtype=torch.bfloat16), torch.randn(64, 64).to(torch.float8_e4m3fn),
                 torch.ones(1, 64))
    dip_matmul_q(torch.randn(3, 64), torch.ones(64, 64, dtype=torch.int8), torch.ones(1, 64))
    dip_systolic(torch.randn(3, 64), torch.randn(64, 64))
    assert counters() == before


Q_ROUTE_CASES = [(torch.bfloat16, torch.float8_e4m3fn, "tensor_cores"),
                 (torch.float32, torch.float8_e4m3fn, "tensor_cores"),
                 (torch.bfloat16, torch.int8, "tensor_cores"), (torch.float32, torch.int8, "tensor_cores")]


@pytest.mark.parametrize("x_dtype,q_dtype,route", Q_ROUTE_CASES, ids=["fp8-bf16", "fp8-f32", "int8-bf16", "int8-f32"])
def test_quantized_route(x_dtype, q_dtype, route):
    """Every call runs the tensor-core mainloops: bf16 x with e4m3 weights
    (the fp8 serving route), f32 x with e4m3 weights after its cast pass
    to bf16, and every int8 call after its quantizing pass (the codes do
    not depend on x's width)."""
    assert q_route(x_dtype, q_dtype) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("offset", [0, 1, 3, 8, 16])
def test_alignment_check_refuses_offset_views(dtype, offset):
    """Every wrapper (flash's tensor-core route on q, k, v; lm_head_ce on x
    and w; dip_matmul and dip_matmul_q on every operand) runs this check
    before a launch: a contiguous view whose storage offset is not a
    multiple of 16 bytes is refused (its 16-byte loads would fault on the
    card), with no launch and no card needed to decide it."""
    base = torch.zeros(4096, dtype=torch.float32).to(dtype)  # a fresh, aligned allocation
    view = base[offset:offset + 64]
    assert view.is_contiguous()
    if offset * base.element_size() % 16:
        with pytest.raises(ValueError, match="16-byte aligned"):
            _build.check_aligned(view, "x")
    else:
        _build.check_aligned(view, "x")
