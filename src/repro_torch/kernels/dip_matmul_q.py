"""Quantized DiP matmul: reduced-precision permutated weights with
per-output-channel scales (port of
``repro/kernels/dip_matmul_q.py::dip_matmul_q_pallas``).

    int8   W8A8-dynamic: ``epilogue(float(q8(prologue(x)) @ deshear(Q)) *
           x_scale[m] * w_scale[n])`` with an exact int32 accumulator
    fp8    weight-only e4m3: ``epilogue((x @ deshear(upcast(Q))) *
           w_scale[n])`` with f32 accumulation

fp8 storage is upcast to :func:`fp8_compute_dtype`: bf16 on a card (the
reference's GPU choice), f32 on the CPU (its emulated fallback), and x is
cast to the same width.  Bound on the card: at decode by the weight bytes
(one per weight), at prefill by tensor-core operations.

On the card every call runs the tensor-core mainloops of
``csrc/dip_matmul.cu`` under
:func:`~repro_torch.kernels.dip_matmul.matmul_plan` with one byte a weight
(128-column decode tiles for a single weight, so that a block reads 128
bytes of each weight row; ``wgmma`` at prefill):

* **fp8, bf16 x** (``dip_matmul_fp8_launch``): the raw e4m3 tile rides the
  cp.async ring at one byte a weight and the conversion pass upcasts it
  exactly to bf16 as it de-shears; the rmsnorm prologue is fused as on the
  bf16 route (``inv_rms`` from :func:`~repro_torch.kernels.prologue.inv_rms`,
  the gain through the ring); ``(x @ W) * w_scale[n]`` is formed before the
  epilogue, after the splits are added where K is split.
* **fp8, f32 x** (two launches a call): the cast pass of
  ``csrc/dip_matmul_q.cu`` (``dip_cast_bf16_launch``) writes
  ``bf16(prologue(x))`` (the prologue in f32 with the same ``inv_rms``, one
  rounding: byte-identical to :func:`cast_pass_plain`), then the same
  mainloops with an f32 output and residual, whose sums are carried in
  IEEE f32 across K (a running total of each K tile's products at decode,
  of every four K tiles' at prefill: the tensor cores' own f32 sums round
  toward zero).
* **int8, f32 or bf16 x** (two launches a call): the quantizing pass of
  ``csrc/dip_matmul_q.cu`` (``dip_quantize_int8_launch``) writes x's int8
  codes and per-row scales (the prologue with the same ``inv_rms``, then
  :func:`~repro_torch.kernels.ref.quantize_acts_int8`'s arithmetic, so the
  codes are byte-identical to the plain version's, whatever x's width); the
  int8 mainloops (``dip_matmul_int8q_launch``: ``mma.sync`` m16n8k32 at
  decode, ``wgmma`` m64n128k32 at prefill, s8 x s8 into exact int32)
  multiply them by the de-sheared weight, a split's int32 partial sums are
  added in split order, and only then ``float(acc) * x_scale[m] *
  w_scale[n]``, the epilogue and one cast; so with no epilogue the output
  equals the plain version bit for bit.

:func:`q_route` names the route.  ``dip_matmul_q.launches_tc`` counts the
launches on the tensor-core route, ``dip_matmul_q.launches_quant`` the
quantizing passes and ``dip_matmul_q.launches_cast`` the cast passes.

:func:`dip_matmul_q` launches the kernels for CUDA tensors and runs
:func:`dip_matmul_q_plain` for CPU tensors.  ``dip_matmul_q.launches``
counts calls that launched the product (a split-K call's second pass
included; the passes ahead of it are counted in ``launches_quant`` and
``launches_cast``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.core import permute
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels import prologue as pro
from repro_torch.kernels import ref
from repro_torch.kernels.dip_matmul import TILE, matmul_plan, out_dtype_for, require, sm_count

__all__ = ["cast_pass", "cast_pass_plain", "dip_matmul_q", "dip_matmul_q_plain", "fp8_compute_dtype", "q_route",
           "quantize_pass", "quantize_pass_plain"]

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STORAGE = (torch.int8, torch.float8_e4m3fn)


def fp8_compute_dtype(device) -> torch.dtype:
    """Width fp8 storage is upcast to: bf16 on a card, f32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def _route(q: torch.Tensor) -> str:
    """``"int8"`` or ``"fp8"`` from the storage dtype."""
    if q.dtype not in _STORAGE:
        raise TypeError(f"quantized storage must be int8 or float8_e4m3fn, got {q.dtype}")
    return "int8" if q.dtype == torch.int8 else "fp8"


def q_route(x_dtype: torch.dtype, q_dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes: ``"tensor_cores"``, the mainloops of
    ``csrc/dip_matmul.cu``, for every storage and x dtype (int8 after its
    quantizing pass, fp8 with f32 x after its cast pass)."""
    if q_dtype not in _STORAGE:
        raise TypeError(f"quantized storage must be int8 or float8_e4m3fn, got {q_dtype}")
    if x_dtype not in _OUT_CODES:
        raise TypeError(f"dip_matmul_q kernel takes float32 or bfloat16 activations, got {x_dtype}")
    return "tensor_cores"


def _check(x, q, w_scale, epilogue_operands, epilogue):
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"dip_matmul_q takes 2-D x and q, got {tuple(x.shape)} @ {tuple(q.shape)}")
    (m, k), (k2, n) = x.shape, q.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ {tuple(q.shape)}")
    if k % TILE or n % TILE:
        raise ValueError(f"K={k} and N={n} must be multiples of the permutation tile {TILE}; "
                         "the registry shim pads them")
    if not x.dtype.is_floating_point:
        raise TypeError(f"dip_matmul_q takes float activations, got {x.dtype}")
    _route(q)
    if w_scale.numel() != n:
        raise ValueError(f"w_scale must be (1, {n}) per-output-channel, got {tuple(w_scale.shape)}")
    s = epi.spec(epilogue)
    want = 2 if s.dual_weight else s.n_operands
    if len(epilogue_operands) != want:
        raise ValueError(f"epilogue {s.name!r} takes {want} operand(s), got {len(epilogue_operands)}")
    if s.dual_weight:
        q_up, s_up = epilogue_operands
        if tuple(q_up.shape) != (k, n) or q_up.dtype != q.dtype:
            raise ValueError(f"swiglu up-weight must match the gate weight ({k}, {n}):{q.dtype}, "
                             f"got {tuple(q_up.shape)}:{q_up.dtype}")
        if s_up.numel() != n:
            raise ValueError(f"up scales must be (1, {n}), got {tuple(s_up.shape)}")
    elif s.bias and epilogue_operands[0].numel() != n:
        raise ValueError(f"bias must have {n} elements, got {tuple(epilogue_operands[0].shape)}")
    elif s.residual and tuple(epilogue_operands[0].shape) != (m, n):
        raise ValueError(f"residual must be ({m}, {n}), got {tuple(epilogue_operands[0].shape)}")


def _prologue(x, prologue, prologue_operands, prologue_k, prologue_eps):
    """The wrapper-side prologue, as the reference applies it ahead of its
    quantized kernel."""
    if not pro.spec(prologue).normalize:
        return x
    if len(prologue_operands) != 1:
        raise ValueError(f"prologue {prologue!r} takes 1 operand, got {len(prologue_operands)}")
    return pro.apply(prologue, x, prologue_operands[0].reshape(-1), k_true=prologue_k, eps=prologue_eps)


def dip_matmul_q_plain(x, q, w_scale, *epilogue_operands, epilogue="none", prologue="none",
                       prologue_operands=(), prologue_k=None, prologue_eps=pro.DEFAULT_EPS,
                       out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain torch on x's device: prologue, int8
    activation codes (int8) or the cast to :func:`fp8_compute_dtype` (fp8),
    de-shear, exact int32 or f32 products, the scales, the f32 epilogue and
    one cast to x's dtype (or ``out_dtype``)."""
    _check(x, q, w_scale, epilogue_operands, epilogue)
    out_dtype = out_dtype_for(x, epilogue, out_dtype)
    x = _prologue(x, prologue, prologue_operands, prologue_k, prologue_eps)
    s = epi.spec(epilogue)
    if _route(q) == "int8":
        xq, x_scale = ref.quantize_acts_int8(x)

        def z_of(qq, ws):
            acc = ref.int_matmul(xq, permute.unpermute_tiled(qq, TILE))
            return acc.float() * x_scale * ws.reshape(1, -1).float()
    else:
        cd = fp8_compute_dtype(x.device)
        xk = x.to(cd).float()

        def z_of(qq, ws):
            w = permute.unpermute_tiled(qq, TILE).to(cd).float()
            return torch.matmul(xk, w) * ws.reshape(1, -1).float()

    z = z_of(q, w_scale)
    if s.dual_weight:
        aux = (z_of(*epilogue_operands),)
    else:
        aux = tuple(op.reshape(1, -1) if s.bias else op for op in epilogue_operands)
    return epi.apply(epilogue, z, *aux).to(out_dtype)


def _fn(source: str, name: str, argtypes):
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:  # declare once: untyped ints would truncate the pointers
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _lib_quant():
    # dtype; x, inv_rms, gain, codes, x_scale; M, K; stream
    return _fn("dip_matmul_q", "dip_quantize_int8_launch",
               [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _lib_cast():
    # x, inv_rms, gain, out; M, K; stream
    return _fn("dip_matmul_q", "dip_cast_bf16_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _lib_tc():
    # out dtype; x, q, q_up, w_scale, w_scale_up, inv_rms, gain, bias,
    # residual, out; M, N, K, epilogue, bm, bn, splits, kps; workspace; stream
    return _fn("dip_matmul", "dip_matmul_fp8_launch",
               [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)


def _lib_int8():
    # out dtype; codes, q, q_up, x_scale, w_scale, w_scale_up, bias, residual,
    # out; M, N, K, epilogue, bm, bn, splits, kps; workspace; stream
    return _fn("dip_matmul", "dip_matmul_int8q_launch",
               [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)


def quantize_pass_plain(x: torch.Tensor, inv: Optional[torch.Tensor] = None,
                        gain: Optional[torch.Tensor] = None):
    """The quantizing pass's function in plain torch: ``(codes, x_scale)``
    with codes int8 (M, K) and x_scale f32 (M,) of ``y = kernel_load(x)``
    (the rmsnorm scale by ``inv`` (M, 1) and ``gain`` (K,) in f32, cast back
    to x's dtype; ``y = x`` without them), by ``ref.quantize_acts_int8``."""
    y = x if gain is None else pro.kernel_load("rmsnorm", x, (inv.reshape(-1, 1), gain))
    codes, scale = ref.quantize_acts_int8(y)
    return codes, scale.reshape(-1)


def quantize_pass(x: torch.Tensor, inv: Optional[torch.Tensor] = None, gain: Optional[torch.Tensor] = None):
    """:func:`quantize_pass_plain` for CPU tensors; for CUDA tensors one
    launch of the quantizing pass (``dip_matmul_q.launches_quant``)."""
    if x.device.type == "cpu":
        return quantize_pass_plain(x, inv, gain)
    m, k = x.shape
    dev = x.device
    require(x, "x", dev)
    if x.dtype not in _OUT_CODES:
        raise TypeError(f"the quantizing pass takes float32 or bfloat16 x, got {x.dtype}")
    if gain is not None:
        inv = inv.reshape(m)
        require(inv, "inv_rms", dev, torch.float32)
        require(gain, "gain", dev, torch.float32)
    codes = torch.empty((m, k), dtype=torch.int8, device=dev)
    x_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    _build.check_aligned(codes, "codes")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib_quant()(_OUT_CODES[x.dtype], ptr(x), ptr(inv if gain is not None else None), ptr(gain),
                          ptr(codes), ptr(x_scale), m, k, stream)
    if rc != 0:
        raise RuntimeError(f"dip_matmul_q quantizing pass launch failed: cudaError {rc}")
    dip_matmul_q.launches_quant += 1
    return codes, x_scale


def cast_pass_plain(x: torch.Tensor, inv: Optional[torch.Tensor] = None,
                    gain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fp8 route's cast pass in plain torch: bf16 (M, K) of f32 x, or
    of ``(x * inv) * gain`` in f32 with the rmsnorm prologue (``inv`` (M,
    1) or (M,), ``gain`` (K,)), rounded to nearest once."""
    y = x if gain is None else pro.kernel_load("rmsnorm", x, (inv.reshape(-1, 1), gain))
    return y.to(torch.bfloat16)


def cast_pass(x: torch.Tensor, inv: Optional[torch.Tensor] = None, gain: Optional[torch.Tensor] = None):
    """:func:`cast_pass_plain` for CPU tensors; for CUDA tensors one launch
    of the cast pass (``dip_matmul_q.launches_cast``), f32 x only."""
    if x.device.type == "cpu":
        return cast_pass_plain(x, inv, gain)
    m, k = x.shape
    dev = x.device
    require(x, "x", dev, torch.float32)
    if gain is not None:
        inv = inv.reshape(m)
        require(inv, "inv_rms", dev, torch.float32)
        require(gain, "gain", dev, torch.float32)
    out = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib_cast()(ptr(x), ptr(inv if gain is not None else None), ptr(gain), ptr(out), m, k, stream)
    if rc != 0:
        raise RuntimeError(f"dip_matmul_q cast pass launch failed: cudaError {rc}")
    dip_matmul_q.launches_cast += 1
    return out


def dip_matmul_q(x: torch.Tensor, q: torch.Tensor, w_scale: torch.Tensor, *epilogue_operands: torch.Tensor,
                 epilogue: str = "none", prologue: str = "none",
                 prologue_operands: Sequence[torch.Tensor] = (), prologue_k: Optional[int] = None,
                 prologue_eps: float = pro.DEFAULT_EPS, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (M, K) float, ``q`` (K, N) int8 or float8_e4m3fn permutated
    storage, ``w_scale`` (1, N) f32; K and N multiples of 64, M any.
    ``epilogue_operands``: ``(q_up, w_scale_up)`` for ``swiglu``, the
    N-element f32 bias, or the (M, N) residual in x's dtype.  Returns
    (M, N) in x's dtype, or f32 for bf16 x with no epilogue under
    ``out_dtype=torch.float32``.  CPU tensors take
    :func:`dip_matmul_q_plain`; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return dip_matmul_q_plain(
            x, q, w_scale, *epilogue_operands, epilogue=epilogue, prologue=prologue,
            prologue_operands=prologue_operands, prologue_k=prologue_k, prologue_eps=prologue_eps,
            out_dtype=out_dtype,
        )
    if x.device.type != "cuda":
        raise ValueError(f"dip_matmul_q runs on cuda or cpu tensors, got {x.device}")
    _check(x, q, w_scale, epilogue_operands, epilogue)
    _build.refuse_grad("dip_matmul_q", x, w_scale, *epilogue_operands, *prologue_operands)
    if x.dtype not in _OUT_CODES:
        raise TypeError(f"dip_matmul_q kernel takes float32 or bfloat16 activations, got {x.dtype}")
    dev, dt = x.device, x.dtype
    out_dt = out_dtype_for(x, epilogue, out_dtype)  # x's width before a cast pass
    m, k = x.shape
    n = q.shape[1]
    if m > 65535 * TILE:
        raise ValueError(f"M={m} exceeds the kernel's grid limit {65535 * TILE}")
    s = epi.spec(epilogue)
    require(q, "q", dev)
    require(w_scale, "w_scale", dev, torch.float32)
    q_up = s_up = bias = residual = None
    if s.dual_weight:
        q_up, s_up = epilogue_operands
        require(q_up, "q_up", dev, q.dtype)
        require(s_up, "w_scale_up", dev, torch.float32)
    elif s.bias:
        bias = epilogue_operands[0]
        require(bias, "bias", dev, torch.float32)
    elif s.residual:
        residual = epilogue_operands[0]
        require(residual, "residual", dev, dt)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    require(x, "x", dev, dt)
    inv = gain = None
    if pro.spec(prologue).normalize:
        if len(prologue_operands) != 1:
            raise ValueError(f"prologue {prologue!r} takes 1 operand, got {len(prologue_operands)}")
        gain = prologue_operands[0].reshape(-1)
        if gain.numel() != k:
            raise ValueError(f"rmsnorm gain must have {k} elements, got {tuple(gain.shape)}")
        require(gain, "gain", dev, torch.float32)
        inv = pro.inv_rms(x, k_true=prologue_k, eps=prologue_eps).reshape(m)
    int8 = _route(q) == "int8"
    plan = matmul_plan(m, n, k, s.dual_weight, sm_count(dev), weight_bytes=1)
    work = (torch.empty((plan.splits, 2 if s.dual_weight else 1, m, n), device=dev,
                        dtype=torch.int32 if int8 else torch.float32) if plan.splits > 1 else None)
    if int8:  # the codes and scales first; the prologue is the pass's
        codes, x_scale = quantize_pass(x, inv, gain)
    elif dt == torch.float32:  # bf16 x first (the compute width); the prologue is the pass's
        x = cast_pass(x, inv, gain)
        inv = gain = None
    out = torch.empty((m, n), dtype=out_dt, device=dev)
    code = _OUT_CODES[out_dt]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan_args = (m, n, k, epi.code(epilogue), plan.bm, plan.bn, plan.splits, plan.k_tiles_per_split, ptr(work),
                     stream)
        if int8:
            rc = _lib_int8()(code, ptr(codes), ptr(q), ptr(q_up), ptr(x_scale), ptr(w_scale), ptr(s_up),
                             ptr(bias), ptr(residual), ptr(out), *plan_args)
        else:
            rc = _lib_tc()(code, ptr(x), ptr(q), ptr(q_up), ptr(w_scale), ptr(s_up), ptr(inv), ptr(gain),
                           ptr(bias), ptr(residual), ptr(out), *plan_args)
    if rc != 0:
        raise RuntimeError(f"dip_matmul_q kernel launch failed ({_route(q)}, tensor cores): cudaError {rc}")
    dip_matmul_q.launches += 1
    dip_matmul_q.launches_tc += 1
    return out


dip_matmul_q.launches = 0
dip_matmul_q.launches_tc = 0  # of them, the tensor-core route (every CUDA call)
dip_matmul_q.launches_quant = 0  # the int8 route's quantizing passes
dip_matmul_q.launches_cast = 0  # the fp8 route's cast passes (f32 x)
