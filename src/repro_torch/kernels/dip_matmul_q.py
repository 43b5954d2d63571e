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

Two kernels on the card:

* **fp8, bf16 x** (the served route) runs the bf16 tensor-core mainloops
  of ``csrc/dip_matmul.cu`` (``dip_matmul_fp8_launch``) under
  :func:`~repro_torch.kernels.dip_matmul.matmul_plan` with one byte a
  weight (128-column decode tiles for a single weight): the raw e4m3 tile
  rides the cp.async ring at one byte a weight and the conversion pass
  upcasts it exactly to bf16 as it de-shears; the rmsnorm prologue is fused
  as on the bf16 route (``inv_rms`` from :func:`~repro_torch.kernels.prologue.inv_rms`,
  the gain through the ring); ``(x @ W) * w_scale[n]`` is formed before the
  epilogue, after the splits are added where K is split.
  ``dip_matmul_q.launches_tc`` counts these launches.
* **int8, and fp8 with f32 x** run the first design
  (``csrc/dip_matmul_q.cu``, one 64x64 WMMA tile per block), with the
  prologue and the int8 activation quantization
  (:func:`~repro_torch.kernels.ref.quantize_acts_int8`) in torch ops ahead of
  the launch, as the reference applies them outside its kernel.

:func:`dip_matmul_q` launches a kernel for CUDA tensors and runs
:func:`dip_matmul_q_plain` for CPU tensors.  ``dip_matmul_q.launches``
counts kernel launches (a split-K call's second pass included).
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
from repro_torch.kernels.dip_matmul import TILE, matmul_plan, require, sm_count

__all__ = ["dip_matmul_q", "dip_matmul_q_plain", "fp8_compute_dtype", "q_route"]

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
    """The kernel a CUDA call takes: ``"tensor_cores"`` (fp8 storage with
    bf16 x, ``csrc/dip_matmul.cu``) or ``"first_design"`` (int8, and fp8
    with f32 x, ``csrc/dip_matmul_q.cu``)."""
    return "tensor_cores" if q_dtype == torch.float8_e4m3fn and x_dtype == torch.bfloat16 else "first_design"


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
                       prologue_operands=(), prologue_k=None, prologue_eps=pro.DEFAULT_EPS) -> torch.Tensor:
    """The kernel's function in plain torch on x's device: prologue, int8
    activation codes (int8) or the cast to :func:`fp8_compute_dtype` (fp8),
    de-shear, exact int32 or f32 products, the scales, the f32 epilogue and
    one cast to x's dtype."""
    _check(x, q, w_scale, epilogue_operands, epilogue)
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
    return epi.apply(epilogue, z, *aux).to(x.dtype)


def _lib():
    lib = _build.load("dip_matmul_q")
    fn = lib.dip_matmul_q_launch
    if fn.argtypes is None:  # declare once: untyped ints would truncate the pointers
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_tc():
    fn = _build.load("dip_matmul").dip_matmul_fp8_launch
    if fn.argtypes is None:
        # x, q, q_up, w_scale, w_scale_up, inv_rms, gain, bias, residual, out;
        # M, N, K, epilogue, bm, bn, splits, kps; workspace; stream
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def dip_matmul_q(x: torch.Tensor, q: torch.Tensor, w_scale: torch.Tensor, *epilogue_operands: torch.Tensor,
                 epilogue: str = "none", prologue: str = "none",
                 prologue_operands: Sequence[torch.Tensor] = (), prologue_k: Optional[int] = None,
                 prologue_eps: float = pro.DEFAULT_EPS) -> torch.Tensor:
    """``x`` (M, K) float, ``q`` (K, N) int8 or float8_e4m3fn permutated
    storage, ``w_scale`` (1, N) f32; K and N multiples of 64, M any.
    ``epilogue_operands``: ``(q_up, w_scale_up)`` for ``swiglu``, the
    N-element f32 bias, or the (M, N) residual in x's dtype.  Returns
    (M, N) in x's dtype.  CPU tensors take :func:`dip_matmul_q_plain`; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return dip_matmul_q_plain(
            x, q, w_scale, *epilogue_operands, epilogue=epilogue, prologue=prologue,
            prologue_operands=prologue_operands, prologue_k=prologue_k, prologue_eps=prologue_eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"dip_matmul_q runs on cuda or cpu tensors, got {x.device}")
    _check(x, q, w_scale, epilogue_operands, epilogue)
    _build.refuse_grad("dip_matmul_q", x, w_scale, *epilogue_operands, *prologue_operands)
    if x.dtype not in _OUT_CODES:
        raise TypeError(f"dip_matmul_q kernel takes float32 or bfloat16 activations, got {x.dtype}")
    dev, dt = x.device, x.dtype
    m, k = x.shape
    n = q.shape[1]
    if m > 65535 * TILE:
        raise ValueError(f"M={m} exceeds the kernel's grid limit {65535 * TILE}")
    route = q_route(dt, q.dtype)
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
    if route == "tensor_cores":
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
        plan = matmul_plan(m, n, k, s.dual_weight, sm_count(dev), weight_bytes=1)
        work = (torch.empty((plan.splits, 2 if s.dual_weight else 1, m, n), dtype=torch.float32, device=dev)
                if plan.splits > 1 else None)
        out = torch.empty((m, n), dtype=dt, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _lib_tc()(
                ptr(x), ptr(q), ptr(q_up), ptr(w_scale), ptr(s_up), ptr(inv), ptr(gain), ptr(bias),
                ptr(residual), ptr(out), m, n, k, epi.code(epilogue), plan.bm, plan.bn, plan.splits,
                plan.k_tiles_per_split, ptr(work), stream,
            )
        if rc != 0:
            raise RuntimeError(f"dip_matmul_q kernel launch failed (fp8, tensor cores): cudaError {rc}")
        dip_matmul_q.launches += 1
        dip_matmul_q.launches_tc += 1
        return out
    x = _prologue(x, prologue, prologue_operands, prologue_k, prologue_eps)
    x_scale = None
    if _route(q) == "int8":
        x, x_scale = ref.quantize_acts_int8(x)
        x_scale = x_scale.reshape(m)
    require(x, "x", dev)
    out = torch.empty((m, n), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(
            0 if x_scale is not None else 1, _OUT_CODES[dt], ptr(x), ptr(q), ptr(q_up), ptr(w_scale), ptr(s_up),
            ptr(x_scale), ptr(bias), ptr(residual), ptr(out), m, n, k, epi.code(epilogue), stream,
        )
    if rc != 0:
        raise RuntimeError(f"dip_matmul_q kernel launch failed: cudaError {rc}")
    dip_matmul_q.launches += 1
    return out


dip_matmul_q.launches = 0
dip_matmul_q.launches_tc = 0  # of them, the fp8 tensor-core route
