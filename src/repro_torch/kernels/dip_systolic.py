"""DiP wavefront kernel: the array's dataflow, step by step (port of
``repro/kernels/dip_systolic.py::dip_systolic_pallas``).

For each 64-deep K tile, PE row r holds permutated weight row ``P[r, :]``
and the input arrives rotated left by r::

    acc[m, i] += x[m, (i + r) % 64] * P[r, i]        r = 0..63

``csrc/dip_systolic.cu`` runs that literally on the CUDA cores, consuming
the permutated storage without de-shearing it, with the rmsnorm prologue on
load and the epilogue at the flush.  It validates the dataflow; it is not
the fast path (that is ``dip_matmul``), and its yardstick is the f32
CUDA-core rate, not the tensor cores.  Each thread keeps a window of the
rotated input row in registers that slides one column per step, so a step
loads one new x value per row against a block of multiply-adds
(register blocking, the paper's Fig. 2a in registers); the tiles and K
splits come from :func:`systolic_plan`.  It computes the same function as
``dip_matmul`` — the reference pins both to one oracle — so its plain
version is :func:`~repro_torch.kernels.dip_matmul.dip_matmul_plain` and its
operands, dtypes and output dtype are the same: f32 and bf16 inputs
accumulate in f32, int8 in exact int32 (int32 out without an epilogue).

:func:`dip_systolic` launches the kernel for CUDA tensors and runs
:func:`dip_systolic_plain` for CPU tensors.  ``dip_systolic.launches``
counts wrapper calls that launched the kernel (a split-K call's second
pass included).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels import prologue as pro
from repro_torch.kernels.dip_matmul import (DTYPE_CODES, TILE, MatmulPlan, dip_matmul_plain, launch_operands,
                                            sm_count)

__all__ = ["SYSTOLIC_DECODE_MAX_M", "dip_systolic", "dip_systolic_plain", "systolic_plan"]

SYSTOLIC_DECODE_MAX_M = 16  # rows up to which the kernel runs its decode tile (16 rows)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def systolic_plan(m: int, n: int, k: int, sms: int, dual: bool = False) -> MatmulPlan:
    """The wavefront kernel's tiles and K splits for an (m, k) @ (k, n)
    call on a card with ``sms`` SMs (``dual``: swiglu, two weights over one
    x tile).  The kernel keeps two blocks on an SM.

    Prefill (m > 16) is bound by the multiply-adds: 32-row blocks, 256
    columns (128 per weight for swiglu), a thread 8 rows x 8 columns (x 4
    per weight).  The blocks run in waves of 2 x ``sms``, and a last wave
    that is partly filled leaves SMs idle (the llama3-8b gate+up chunk, 896
    tiles, takes 4 waves for 3.4 waves of work), so K is split into the
    count that minimizes the waves of whole-K work, ``cdiv(tiles * splits,
    2 sms) / splits``, where that saves at least 5% (2 splits: 3.5 waves).
    Decode (m <= 16) is bound by the weight bytes: 16-row blocks of 128
    columns (per weight), a thread 4 rows x 4 columns, and K split until
    there are at least 2 x ``sms`` blocks, so that every SM streams
    weights.  ``grid`` is (column tiles, row tiles, splits), as
    :class:`~repro_torch.kernels.dip_matmul.MatmulPlan` has it."""
    k_tiles = k // TILE
    if m <= SYSTOLIC_DECODE_MAX_M:
        regime, bm, bn = "decode", 16, 128
        tiles = _cdiv(n, bn)
        want = _cdiv(2 * sms, tiles)
    else:
        regime, bm, bn = "prefill", 32, 128 if dual else 256
        tiles = _cdiv(m, bm) * _cdiv(n, bn)
        want, waves = 1, _cdiv(tiles, 2 * sms)
        for s in range(2, min(k_tiles, 32) + 1):
            if _cdiv(tiles * s, 2 * sms) / s < 0.95 * waves:
                want, waves = s, _cdiv(tiles * s, 2 * sms) / s
    want = min(k_tiles, want)
    kps = _cdiv(k_tiles, want)
    while regime == "decode" and kps > 1 and tiles * _cdiv(k_tiles, kps) < 2 * sms:
        kps -= 1  # the rounding must not leave fewer blocks than 2 x sms
    splits = _cdiv(k_tiles, kps)  # no empty split
    return MatmulPlan(regime, bm, bn, splits, kps, (_cdiv(n, bn), _cdiv(m, bm), splits))


def dip_systolic_plain(x, p, *epilogue_operands, epilogue="none", prologue="none", prologue_operands=(),
                       prologue_k=None, prologue_eps=pro.DEFAULT_EPS) -> torch.Tensor:
    """The kernel's function in plain torch (``ref.dip_systolic_ref`` with
    the prologue and epilogue)."""
    return dip_matmul_plain(x, p, *epilogue_operands, epilogue=epilogue, prologue=prologue,
                            prologue_operands=prologue_operands, prologue_k=prologue_k,
                            prologue_eps=prologue_eps)


def _lib():
    lib = _build.load("dip_systolic")
    fn = lib.dip_systolic_launch
    if fn.argtypes is None:  # declare once: untyped ints would truncate the pointers
        # dtype; x, p, p_up, inv_rms, gain, bias, residual, out; M, N, K,
        # epilogue, bm, bn, splits, kps; workspace; stream
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def dip_systolic(x: torch.Tensor, p: torch.Tensor, *epilogue_operands: torch.Tensor,
                 epilogue: str = "none", prologue: str = "none",
                 prologue_operands: Sequence[torch.Tensor] = (), prologue_k: Optional[int] = None,
                 prologue_eps: float = pro.DEFAULT_EPS) -> torch.Tensor:
    """``epilogue(prologue(x) @ unpermute_tiled(p))`` by the wavefront, with
    the operands of :func:`~repro_torch.kernels.dip_matmul.dip_matmul`.
    CPU tensors take :func:`dip_systolic_plain`; CUDA tensors launch the
    kernel or raise."""
    if x.device.type == "cpu":
        return dip_systolic_plain(x, p, *epilogue_operands, epilogue=epilogue, prologue=prologue,
                                  prologue_operands=prologue_operands, prologue_k=prologue_k,
                                  prologue_eps=prologue_eps)
    if x.device.type != "cuda":
        raise ValueError(f"dip_systolic runs on cuda or cpu tensors, got {x.device}")
    out, ptrs, inv = launch_operands("dip_systolic", x, p, epilogue_operands, epilogue, prologue,
                                     prologue_operands, prologue_k, prologue_eps)
    (m, k), n = x.shape, p.shape[1]
    dual = epi.spec(epilogue).dual_weight
    plan = systolic_plan(m, n, k, sm_count(x.device), dual)
    work = None
    if plan.splits > 1:  # int8 partial sums stay int32, so the split sum is exact
        work = torch.empty((plan.splits, 2 if dual else 1, m, n), device=x.device,
                           dtype=torch.int32 if x.dtype == torch.int8 else torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib()(DTYPE_CODES[x.dtype], *ptrs, m, n, k, epi.code(epilogue), plan.bm, plan.bn, plan.splits,
                    plan.k_tiles_per_split, None if work is None else work.data_ptr(), stream)
    del inv  # read by the queued launch: held until here
    if rc != 0:
        raise RuntimeError(f"dip_systolic kernel launch failed: cudaError {rc}")
    dip_systolic.launches += 1
    return out


dip_systolic.launches = 0
