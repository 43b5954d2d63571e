"""DiP matmul: ``epilogue(prologue(x) @ deshear(P))`` from permutated storage.

Port of ``repro/kernels/dip_matmul.py::dip_matmul_pallas`` (and of
``ws_matmul.py::ws_matmul_pallas``, which is the same kernel with
``fuse_deshear=False``).  The kernel is ``csrc/dip_matmul.cu``.

bf16, the served and trained dtype, runs a tensor-core mainloop shaped by
:func:`matmul_plan`.  Prefill and training (M > 32) are bound by the
products: 128 x 128 block tiles (64 columns per weight for swiglu) on
``wgmma``, a ring of 4 shared-memory stages filled by cp.async copies, and a
pass that turns each stage's raw P tile into the de-sheared K-major operand
(and applies the rmsnorm prologue to the x tile) while the step before
multiplies.  Decode (M <= 32, the serving slots) is bound by the weight
bytes: 32 x 64 tiles on ``mma.sync``, with K split across blocks so that
every SM streams weights.  A split's f32 partial sums go to a workspace
allocated here and a second pass adds them in split order (no atomics)
before the epilogue.

f32 keeps IEEE FMAs on the CUDA cores (no TF32), and int8 x int8 exact
int32 sums (WMMA s8), in one block per 64x64 output tile; int8 with no
epilogue returns the int32 accumulator, as the reference's
``acc_dtype_for`` defines it, and any epilogue widens it to f32.

:func:`dip_matmul` launches the kernel for CUDA tensors and runs
:func:`dip_matmul_plain` — ``unpermute_tiled`` then the f32 composition —
for CPU tensors.  ``dip_matmul.launches`` counts wrapper calls that
launched the kernel (a split-K call's second pass included), and
``dip_matmul.launches_f32`` those of them with f32 x.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import permute
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels import prologue as pro
from repro_torch.kernels import ref

__all__ = ["TILE", "DTYPE_CODES", "DECODE_MAX_M", "MatmulPlan", "matmul_plan", "dip_matmul",
           "dip_matmul_plain", "launch_operands", "out_dtype_for", "require", "sm_count"]

TILE = 64  # output tile, K step and DiP permutation tile of the CUDA kernel
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_BF16_F32_OUT = 3  # bf16 x and weights, f32 out: the bf16 mainloops with an f32 store
DECODE_MAX_M = 32  # rows up to which the bf16 kernel runs its decode tile (32 x 64)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """How the bf16 kernel covers one call: ``bm`` x ``bn`` block tiles
    (``bn`` per weight), K cut into ``splits`` ranges of
    ``k_tiles_per_split`` 64-deep tiles (the last may be shorter), and the
    grid (column tiles, row tiles, splits)."""

    regime: str  # "decode" (bound by weight bytes) or "prefill" (by operations)
    bm: int
    bn: int
    splits: int
    k_tiles_per_split: int
    grid: Tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def matmul_plan(m: int, n: int, k: int, dual: bool, sms: int, weight_bytes: int = 2) -> MatmulPlan:
    """The tensor-core kernel's tiles and K splits for an (m, k) @ (k, n)
    call on a card with ``sms`` SMs (``dual``: swiglu, two weights over one
    x tile; ``weight_bytes``: 2 for bf16 weights, 1 for the e4m3 and int8
    codes of ``dip_matmul_q``'s fp8 and int8 routes).

    Decode (m <= DECODE_MAX_M) is bound by the weight bytes, so every SM
    must stream: 32 x 64 tiles (two blocks fit on an SM) and K split until
    there are at least 2 x ``sms`` blocks.  Prefill and training are bound
    by the products: 128 x 128 tiles (64 columns per weight for swiglu), one
    block an SM; where the tiles fill fewer SMs than the card has, K is
    split so that the blocks come closest to one full wave (a second,
    partly filled wave would cost more than the split saves).

    One byte a weight changes the decode plan.  A 64-column e4m3 tile reads
    64-byte row segments, which measured three times slower per byte than
    the bf16 tile's 128 (the llama3-8b lm_head, M = 4, at any split), so a
    single e4m3 weight takes 32 x 128 tiles (swiglu's two 64-column tiles
    make one 128-byte row already).  And the split is rounded so that the
    blocks never fall short of 2 x ``sms``: a split streams half the bytes
    of a bf16 one, so its partial sums cost relatively more, but an idle SM
    costs more still.  At prefill the products are the same bf16 ones."""
    k_tiles = k // TILE
    if m <= DECODE_MAX_M:
        regime, bm, bn = "decode", 32, 128 if weight_bytes == 1 and not dual else 64
        tiles = _cdiv(n, bn)
        want = _cdiv(2 * sms, tiles) if tiles < 2 * sms else 1
    else:
        regime, bm, bn = "prefill", 128, 64 if dual else 128
        tiles = _cdiv(m, bm) * _cdiv(n, bn)
        want = max(1, int(sms / tiles + 0.5)) if tiles < sms else 1
    want = min(k_tiles, want)
    kps = _cdiv(k_tiles, want)
    while weight_bytes == 1 and regime == "decode" and _cdiv(k_tiles, kps) < want:
        kps -= 1  # the rounding must not leave fewer splits than wanted
    splits = _cdiv(k_tiles, kps)  # no empty split
    return MatmulPlan(regime, bm, bn, splits, kps, (_cdiv(n, bn), _cdiv(m, bm), splits))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (cached)."""
    return _sms(device.index if device.index is not None else torch.cuda.current_device())


def out_dtype_for(x: torch.Tensor, epilogue: str = "none", out_dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """x's dtype for float x; for integer x the int32 accumulator with no
    epilogue, f32 with one (the epilogue arithmetic is f32).  ``out_dtype``
    f32 with bf16 x and no epilogue keeps the f32 sums unrounded (the
    row-parallel partial products of ``kernels/dip_matmul_sharded.py``,
    reduced across ranks before the one cast)."""
    if out_dtype is not None:
        if (x.dtype, out_dtype, epi.spec(epilogue).name) != (torch.bfloat16, torch.float32, "none"):
            raise ValueError(f"out_dtype={out_dtype} is the f32 store of bf16 x with no epilogue; got x "
                             f"{x.dtype}, epilogue {epilogue!r}")
        return out_dtype
    if x.dtype.is_floating_point:
        return x.dtype
    return torch.int32 if epi.spec(epilogue).name == "none" else torch.float32


def _check(x, p, epilogue_operands, epilogue, prologue, prologue_operands):
    if x.dim() != 2 or p.dim() != 2:
        raise ValueError(f"dip_matmul takes 2-D x and p, got {tuple(x.shape)} @ {tuple(p.shape)}")
    (m, k), (k2, n) = x.shape, p.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ {tuple(p.shape)}")
    if k % TILE or n % TILE:
        raise ValueError(
            f"K={k} and N={n} must be multiples of the permutation tile {TILE}; "
            "the registry shim pads them"
        )
    s = epi.spec(epilogue)
    if len(epilogue_operands) != s.n_operands:
        raise ValueError(f"epilogue {s.name!r} takes {s.n_operands} operand(s), got {len(epilogue_operands)}")
    if s.dual_weight and tuple(epilogue_operands[0].shape) != (k, n):
        raise ValueError(f"swiglu up-weight must be ({k}, {n}), got {tuple(epilogue_operands[0].shape)}")
    if s.bias and epilogue_operands[0].numel() != n:
        raise ValueError(f"bias must have {n} elements, got {tuple(epilogue_operands[0].shape)}")
    if s.residual and tuple(epilogue_operands[0].shape) != (m, n):
        raise ValueError(f"residual must be ({m}, {n}), got {tuple(epilogue_operands[0].shape)}")
    if len(prologue_operands) != pro.n_operands(prologue):
        raise ValueError(f"prologue {prologue!r} takes {pro.n_operands(prologue)} operand(s)")
    if pro.spec(prologue).normalize and prologue_operands[0].numel() != k:
        raise ValueError(f"rmsnorm gain must have {k} elements, got {tuple(prologue_operands[0].shape)}")


def dip_matmul_plain(x, p, *epilogue_operands, epilogue="none", prologue="none",
                     prologue_operands=(), prologue_k=None, prologue_eps=pro.DEFAULT_EPS,
                     fuse_deshear=True, out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain torch: de-shear, prologue (f32 scale,
    cast back), f32 product(s) (exact int32 for int8), f32 epilogue, one
    cast (to ``out_dtype`` where given, see :func:`out_dtype_for`)."""
    _check(x, p, epilogue_operands, epilogue, prologue, prologue_operands)
    s = epi.spec(epilogue)

    def product(w):
        wn = permute.unpermute_tiled(w, TILE) if fuse_deshear else w
        return torch.matmul(x.float(), wn.float()) if x.dtype.is_floating_point else ref.int_matmul(x, wn)

    if pro.spec(prologue).normalize:
        inv = pro.inv_rms(x, k_true=prologue_k, eps=prologue_eps)
        x = pro.kernel_load(prologue, x, (inv, prologue_operands[0]))
    out_dtype = out_dtype_for(x, epilogue, out_dtype)
    z = product(p)
    if s.name == "none":
        return z.to(out_dtype)
    if s.dual_weight:
        aux = (product(epilogue_operands[0]).float(),)
    else:
        aux = tuple(op.reshape(1, -1) if s.bias else op for op in epilogue_operands)
    return epi.apply(epilogue, z.float(), *aux).to(out_dtype)


def require(t: torch.Tensor, what: str, device, dtype=None) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    _build.check_aligned(t, what)


def _lib():
    lib = _build.load("dip_matmul")
    fn = lib.dip_matmul_launch
    if fn.argtypes is None:  # declare once: untyped ints would truncate the pointers
        # dtype; x, p, p_up, inv_rms, gain, bias, residual, out; M, N, K,
        # epilogue, deshear, bm, bn, splits, kps; workspace; stream
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def launch_operands(kernel, x, p, epilogue_operands, epilogue, prologue, prologue_operands,
                    prologue_k, prologue_eps, out_dtype=None):
    """Check a CUDA launch of ``kernel`` (``dip_matmul`` or ``dip_systolic``:
    the same operands) and allocate its output.  Returns ``(out, pointers,
    inv)`` with the pointers in the C entry points' order: x, p, p_up,
    inv_rms, gain, bias, residual, out.  ``inv`` is the prologue's inv_rms
    tensor made here (or None): the caller holds it until the launch is
    queued, or the caching allocator hands its memory to the next
    allocation (the split-K workspace, which the kernel then writes while
    other blocks still read inv_rms)."""
    _check(x, p, epilogue_operands, epilogue, prologue, prologue_operands)
    # gradients go through the registry's autograd function, which launches
    # the kernel with grad mode off
    _build.refuse_grad(kernel, x, p, *epilogue_operands, *prologue_operands)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel} kernel takes float32, bfloat16 or int8, got {x.dtype}")
    dev, dt = x.device, x.dtype
    m, n = x.shape[0], p.shape[1]
    if m > 65535 * TILE:
        raise ValueError(f"M={m} exceeds the kernel's grid limit {65535 * TILE}")
    require(x, "x", dev, dt)
    require(p, "p", dev, dt)
    s = epi.spec(epilogue)
    p_up = bias = residual = inv = gain = None
    if s.dual_weight:
        p_up = epilogue_operands[0]
        require(p_up, "p_up", dev, dt)
    elif s.bias:
        bias = epilogue_operands[0]
        require(bias, "bias", dev, torch.float32)
    elif s.residual:
        residual = epilogue_operands[0]
        require(residual, "residual", dev, dt)
    if pro.spec(prologue).normalize:
        gain = prologue_operands[0]
        require(gain, "gain", dev, torch.float32)
        inv = pro.inv_rms(x, k_true=prologue_k, eps=prologue_eps).reshape(m)
    out = torch.empty((m, n), dtype=out_dtype_for(x, epilogue, out_dtype), device=dev)
    ptrs = [None if t is None else t.data_ptr() for t in (x, p, p_up, inv, gain, bias, residual, out)]
    return out, ptrs, inv


def dip_matmul(x: torch.Tensor, p: torch.Tensor, *epilogue_operands: torch.Tensor,
               epilogue: str = "none", prologue: str = "none",
               prologue_operands: Sequence[torch.Tensor] = (),
               prologue_k: Optional[int] = None, prologue_eps: float = pro.DEFAULT_EPS,
               fuse_deshear: bool = True, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``epilogue(prologue(x) @ unpermute_tiled(p))`` with ``x`` (M, K) and
    ``p`` (K, N), K and N multiples of 64, M any (bf16 tiles past N are
    masked).  ``epilogue_operands``:
    ``(p_up,)`` for ``swiglu``, the N-element bias for the bias variants, the
    (M, N) residual for ``residual``.  ``prologue_operands`` is the
    K-element gain for ``rmsnorm``; ``prologue_k`` the un-padded K the mean
    divides by.  ``fuse_deshear=False`` reads ``p`` as natural storage (the
    ``ws`` baseline).  ``out_dtype=torch.float32`` with bf16 x and no
    epilogue stores the f32 sums (the bf16 mainloops' f32 store).  CPU
    tensors take :func:`dip_matmul_plain`; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return dip_matmul_plain(
            x, p, *epilogue_operands, epilogue=epilogue, prologue=prologue,
            prologue_operands=prologue_operands, prologue_k=prologue_k,
            prologue_eps=prologue_eps, fuse_deshear=fuse_deshear, out_dtype=out_dtype,
        )
    if x.device.type != "cuda":
        raise ValueError(f"dip_matmul runs on cuda or cpu tensors, got {x.device}")
    out, ptrs, inv = launch_operands("dip_matmul", x, p, epilogue_operands, epilogue, prologue,
                                     prologue_operands, prologue_k, prologue_eps, out_dtype)
    (m, k), n = x.shape, p.shape[1]
    plan_args, work = (0, 0, 0, 0), None
    if x.dtype == torch.bfloat16:
        dual = epi.spec(epilogue).dual_weight
        plan = matmul_plan(m, n, k, dual, sm_count(x.device))
        plan_args = (plan.bm, plan.bn, plan.splits, plan.k_tiles_per_split)
        if plan.splits > 1:
            work = torch.empty((plan.splits, 2 if dual else 1, m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _BF16_F32_OUT if out.dtype != x.dtype and x.dtype == torch.bfloat16 else DTYPE_CODES[x.dtype]
        rc = _lib()(code, *ptrs, m, n, k, epi.code(epilogue), int(fuse_deshear), *plan_args,
                    None if work is None else work.data_ptr(), stream)
    del inv  # read by the queued launch: held until here
    if rc != 0:
        raise RuntimeError(f"dip_matmul kernel launch failed: cudaError {rc}")
    dip_matmul.launches += 1
    if x.dtype == torch.float32:
        dip_matmul.launches_f32 += 1
    return out


dip_matmul.launches = 0
dip_matmul.launches_f32 = 0  # of them, f32 x: the first-design IEEE route on the CUDA cores
