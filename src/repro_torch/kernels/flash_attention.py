"""Prefill flash attention: causal online-softmax attention, forward only.

Port of ``repro/kernels/flash_attention.py::flash_attention_pallas``.  The
kernels are in ``csrc/flash_attention.cu``: one block per (batch*head,
64-query tile) walks the KV tiles with an online softmax in f32, reads each
row's ``q_offset`` and ``kv_len`` on the device, stops at the last KV tile
the tile's rows can see (skipping tiles above the diagonal or past
``kv_len``), and gives exactly 0 for a fully masked row.

Bound on the card: by the operations at the prefill chunk (BH = 32, Sq =
256 against up to 1024 keys, D = 128).  :func:`flash_route` picks the
kernel: bf16 with D = Dv in (64, 128), the served shapes, runs both
products on the tensor cores (mma.sync, bf16 in and f32 sums, P rounded to
bf16 for the P V product) with the K and V tiles double-buffered by
cp.async copies; f32, Dv != D and other head dims up to 256 keep the
CUDA-core kernel (f32 FMAs).

:func:`flash_attention` launches a kernel for CUDA tensors and runs
:func:`attention_plain` — the dense form with the same masking — for CPU
tensors.  ``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_tc`` those of the tensor-core route.  The kernels
have no backward (the reference's Pallas call has no jvp rule either): for
inputs that require grad, with grad mode on, the CUDA path raises.

Layout (flat): q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv) -> (BH, Sq, Dv)
in q's dtype; ``q_offset`` / ``kv_len`` are None, an int, or a (BH,) or
one-element integer tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "TC_HEAD_DIMS", "flash_route", "flash_attention", "attention_plain",
           "per_row_i32"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128)  # head dims of the tensor-core route (D = Dv)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def per_row_i32(val, bh: int, default: int, device) -> torch.Tensor:
    """Broadcast None / int / (BH,) / one-element tensor to an int32 (BH,)
    tensor on ``device`` (no host sync for a device tensor)."""
    if val is None:
        val = default
    if isinstance(val, torch.Tensor):
        t = val.to(device=device, dtype=torch.int32).reshape(-1)
        if t.numel() == 1:
            t = t.expand(bh)
        if t.numel() != bh:
            raise ValueError(f"per-row value must have 1 or {bh} elements, got {t.numel()}")
        return t.contiguous()
    return torch.full((bh,), int(val), dtype=torch.int32, device=device)


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention takes flat (BH, S, D) q, k, v")
    bh, _, d = q.shape
    _, sk, _ = v.shape
    if tuple(k.shape) != (bh, sk, d) or v.shape[0] != bh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")


def attention_plain(q, k, v, *, q_offset=None, kv_len=None, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in dense torch, all in f32: scores of the
    scaled q against every key, the absolute-position causal mask and the
    ``kv_len`` mask, softmax, fully masked rows set to exactly 0."""
    _check(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    k_pos = torch.arange(sk, device=q.device, dtype=torch.int32).view(1, 1, sk)
    live = k_pos < per_row_i32(kv_len, bh, sk, q.device).view(bh, 1, 1)
    if causal:
        q_pos = per_row_i32(q_offset, bh, 0, q.device).view(bh, 1, 1) + torch.arange(
            sq, device=q.device, dtype=torch.int32).view(1, sq, 1)
        live = live & (q_pos >= k_pos)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(live.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_route(dtype: torch.dtype, d: int, dv: int) -> str:
    """``"tensor_cores"`` for bf16 with D = Dv in :data:`TC_HEAD_DIMS`, else
    ``"cuda_cores"`` (f32, Dv != D, other head dims)."""
    return "tensor_cores" if dtype == torch.bfloat16 and d == dv and d in TC_HEAD_DIMS else "cuda_cores"


def _lib(route: str):
    lib = _build.load("flash_attention")
    if route == "tensor_cores":
        fn = lib.flash_attention_tc_launch
        if fn.argtypes is None:  # q, k, v, out, q_offset, kv_len; BH, Sq, Sk, D; scale, causal; stream
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        return fn
    fn = lib.flash_attention_launch
    if fn.argtypes is None:  # declare once: untyped ints would truncate the pointers
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset=None,
                    kv_len=None, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal flash attention over flat (BH, S, D) tensors; ``scale``
    defaults to D^-1/2 (pass 1.0 for a pre-scaled q).  CPU tensors take
    :func:`attention_plain`; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, q_offset=q_offset, kv_len=kv_len, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v)
    _build.refuse_grad("flash_attention", q, k, v)  # forward-only, as the reference's Pallas call
    bh, sq, d = q.shape
    sk, dv = v.shape[1], v.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims D={d}, Dv={dv} exceed the kernel's {MAX_HEAD_DIM}")
    if sq > 65535 * 64:
        raise ValueError(f"Sq={sq} exceeds the kernel's grid limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} on {q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    route = flash_route(q.dtype, d, dv)
    if route == "tensor_cores":  # its rows land in shared memory by 16-byte cp.async copies
        for name, t in (("q", q), ("k", k), ("v", v)):
            _build.check_aligned(t, name)
    scale = d ** -0.5 if scale is None else float(scale)
    qo = per_row_i32(q_offset, bh, 0, q.device)
    kvl = per_row_i32(kv_len, bh, sk, q.device)
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), qo.data_ptr(), kvl.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "tensor_cores":
            rc = _lib(route)(*ptrs, bh, sq, sk, d, scale, int(causal), stream)
        else:
            rc = _lib(route)(_DTYPE_CODES[q.dtype], *ptrs, bh, sq, sk, d, dv, scale, int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed ({route}): cudaError {rc}")
    flash_attention.launches += 1
    if route == "tensor_cores":
        flash_attention.launches_tc += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
