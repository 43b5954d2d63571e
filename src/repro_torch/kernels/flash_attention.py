"""Prefill flash attention: causal online-softmax attention, forward only.

Port of ``repro/kernels/flash_attention.py::flash_attention_pallas``.  The
kernels are in ``csrc/flash_attention.cu``: a block per (batch*head, query
tile) walks the KV tiles with an online softmax in f32, reads each row's
``q_offset`` and ``kv_len`` on the device, stops at the last KV tile the
tile's rows can see (skipping tiles above the diagonal or past ``kv_len``),
and gives exactly 0 for a fully masked row.

:func:`flash_plan` picks the route and its grid from the shapes alone (it
reads no device value, so a call never syncs with the host):

* ``"tensor_cores"``: bf16 or f32 with (D, Dv) in :data:`TC_PAIRS` and Sq
  above :data:`SPLIT_MAX_SQ`: D = Dv in :data:`TC_HEAD_DIMS` (32 to 128 in
  steps of 16; the reduced models have D = 32, Zamba2's shared block D =
  80), the reduced MLA model's (48, 32), and (192, 128), DeepSeek-V2-Lite's
  whole-prompt MLA forward (q and k carry the nope + rope columns, 128 + 64;
  v 128).  Bound by the operations at a prefill chunk (BH = 32, Sq = 256
  against up to 1024 keys): both products on the tensor cores (mma.sync,
  bf16 in and f32 sums) in 64-row query tiles, the K and V tiles
  double-buffered by cp.async.  bf16 rounds P to bf16 for the P V product;
  f32 splits every operand, P included, into three bf16 parts
  (:func:`repro_torch.kernels._bf16_parts.bf16_parts`) and takes each
  product as the six exact part products i + j <= 2, so no operand is
  rounded to TF32.
* ``"split_kv"``: the same pairs with Sq <= :data:`SPLIT_MAX_SQ` (a
  token of Zamba2's single-token prefill tail).  Bound by the bytes of K
  and V: 16-row query tiles, and the keys split across blocks until the
  grid fills one wave (:func:`split_count`); each split's f32 partial goes
  to a workspace from the caching allocator and the last block of each
  query tile (an atomic ticket, :func:`_tickets`) merges them in split
  order in the same launch.
* ``"cuda_cores"``: every other (D, Dv) up to 256 (f32 FMAs): D not a
  multiple of 16, a pair above 128 other than (192, 128), the other Dv != D
  pairs.

:func:`flash_attention` launches the planned kernel for CUDA tensors and runs
:func:`attention_plain` — the dense form with the same masking — for CPU
tensors.  ``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_tc`` those on the tensor cores (both
``"tensor_cores"`` and ``"split_kv"``) and ``flash_attention.launches_split``
those of ``"split_kv"``.  The kernels have no backward (the reference's
Pallas call has no jvp rule either): for inputs that require grad, with
grad mode on, the CUDA path raises.

Layout (flat): q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv) -> (BH, Sq, Dv)
in q's dtype; ``q_offset`` / ``kv_len`` are None, an int, or a (BH,) or
one-element integer tensor.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dip_matmul import sm_count

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "TC_HEAD_DIMS", "TC_PAIRS", "SPLIT_MAX_SQ", "flash_route", "flash_plan",
           "split_count", "split_ranges", "flash_attention", "attention_plain", "per_row_i32"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (32, 48, 64, 80, 96, 112, 128)  # head dims of the tensor-core routes with D = Dv
# (D, Dv) pairs of the tensor-core routes: D = Dv above, the reduced MLA model's
# (nope 32 + rope 16, v 32) and DeepSeek-V2-Lite's MLA prefill
TC_PAIRS = frozenset([(d, d) for d in TC_HEAD_DIMS] + [(48, 32), (192, 128)])
SPLIT_MAX_SQ = 64  # query rows up to which the tensor-core head dims take "split_kv"
KV_TILE = 64  # keys per KV tile of the tensor-core kernels; splits are whole tiles
SPLIT_Q_TILE = 16  # query rows per block of the split route (one m16 fragment)
MAX_SPLITS = 256  # the split kernel's merge holds one weight per split and row in shared memory
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


def _per_row_arg(val, bh: int, default: int, device) -> Tuple[Optional[torch.Tensor], int, int, int]:
    """A per-row value as the kernels take it, ``(tensor, step, value,
    wide)``: an int32 or int64 tensor on ``device`` read at element ``step *
    bh`` (step 0 for one element; wide 1 for int64), or None and the plain
    integer ``value``.  Neither costs a launch: an integer goes by value and
    a position tensor of the call's device is read as it is."""
    if val is None:
        val = default
    if not isinstance(val, torch.Tensor):
        return None, 0, int(val), 0
    t = val.reshape(-1)
    if t.device != device or t.dtype not in (torch.int32, torch.int64) or not t.is_contiguous():
        t = t.to(device=device, dtype=torch.int32).contiguous()
    if t.numel() not in (1, bh):
        raise ValueError(f"per-row value must have 1 or {bh} elements, got {t.numel()}")
    return t, int(t.numel() > 1), 0, int(t.dtype == torch.int64)


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
    """``"tensor_cores"`` for bf16 or f32 with (D, Dv) in :data:`TC_PAIRS`,
    else ``"cuda_cores"`` (other head dims)."""
    return "tensor_cores" if dtype in _DTYPE_CODES and (d, dv) in TC_PAIRS else "cuda_cores"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_plan(bh: int, sq: int, sk: int, d: int, dv: int, dtype: torch.dtype, sms: int) -> Tuple[str, int, int]:
    """``(route, q_tile, splits)`` for a call of these shapes on a card with
    ``sms`` SMs.  Plain Python on the shapes: the plan never reads
    ``q_offset`` or ``kv_len``, which live on the card.

    The tensor-core pairs take ``"split_kv"`` when Sq <=
    :data:`SPLIT_MAX_SQ`: 16-row query tiles, the block's four warps
    splitting every KV tile's keys, and the ``ceil(Sk / 64)`` KV tiles cut
    across blocks as :func:`split_count` says (Zamba2's single-token tail:
    4 splits).  Longer queries keep one block per 64-row tile and no split
    (``"tensor_cores"``): Zamba2's 256-token chunk is 128 such blocks.
    Other pairs take ``"cuda_cores"``.  SPLIT_MAX_SQ = 64 is
    the longest query for which the 16-row tiles won at both D = 80 and 128
    on the H100 (``chip_smoke.py`` phase 7's sweep: at Sq = 128 only D = 80
    still gained, at 256 neither)."""
    if flash_route(dtype, d, dv) == "cuda_cores":
        return "cuda_cores", 64, 1
    if sq > SPLIT_MAX_SQ:
        return "tensor_cores", 64, 1
    return "split_kv", SPLIT_Q_TILE, split_count(bh, sq, sk, sms)


def split_count(bh: int, sq: int, sk: int, sms: int) -> int:
    """The splits of ``"split_kv"``: as many as fill one wave, ``sms //
    (bh x ceil(Sq / 16))`` (at least 1, at most one a KV tile and
    :data:`MAX_SPLITS`), evened out over the ``ceil(Sk / 64)`` KV tiles so
    that no split is empty.  Measured on the H100 (``chip_smoke.py`` phase
    7's sweep): at BH = 32, Sk = 1024 one wave (4 splits at Sq <= 16, 2 at
    Sq = 32, none at 64) beat or matched every other count, and the 16
    splits that 2 x SMs blocks would take lost, their merge costing more
    than the extra blocks hide."""
    kv_tiles = max(1, _cdiv(sk, KV_TILE))
    want = max(1, min(kv_tiles, MAX_SPLITS, sms // (bh * _cdiv(sq, SPLIT_Q_TILE))))
    return _cdiv(kv_tiles, _cdiv(kv_tiles, want))


def _tiles_per_split(sk: int, splits: int) -> int:
    return _cdiv(max(1, _cdiv(sk, KV_TILE)), splits)


def split_ranges(sk: int, splits: int) -> List[Tuple[int, int]]:
    """The key range ``[begin, end)`` of each split as the kernel walks it:
    ``ceil(ceil(Sk / 64) / splits)`` whole KV tiles each, the last cut at Sk."""
    per_split = _tiles_per_split(sk, splits)
    return [(min(sk, i * per_split * KV_TILE), min(sk, (i + 1) * per_split * KV_TILE)) for i in range(splits)]


_ticket_lock = threading.Lock()
_ticket_bufs: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split route's int32 tickets for ``device`` and ``stream``, at
    least ``n``.  Zeroed once, when allocated; the kernel's last block of
    each (bh, query tile) resets its ticket to 0, so no call clears them.
    A call needing more allocates a larger buffer (the old one stays valid
    for launches already queued on the stream).  A CUDA graph's capture
    must find its stream's buffer made (the step's first, eager call on
    that stream makes it): one allocated inside the capture would come
    from the graph's pool and outlive the graph here, so that raises."""
    with _ticket_lock:
        buf = _ticket_bufs.get((device.index, stream))
        if buf is None or buf.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("flash split_kv: no tickets for the capturing stream; "
                                   "run the step once on that stream before capturing it")
            buf = _ticket_bufs[(device.index, stream)] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                                                      device=device)
        return buf


# q, k, v, out; q_offset and kv_len as (pointer, step, value, wide) each; then per route
_HEAD = [ctypes.c_void_p] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int] * 2
_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, causal, stream
_ARGTYPES = {  # each takes the dtype code first
    "tensor_cores": ("flash_attention_tc_launch", [ctypes.c_int] + _HEAD + [ctypes.c_int] * 5 + _TAIL),  # BH, Sq, Sk, D, Dv
    # ws, tickets; BH, Sq, Sk, D, Dv, splits, tiles a split
    "split_kv": ("flash_attention_split_launch",
                 [ctypes.c_int] + _HEAD + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + _TAIL),
    "cuda_cores": ("flash_attention_launch", [ctypes.c_int] + _HEAD + [ctypes.c_int] * 5 + _TAIL),  # BH, Sq, Sk, D, Dv
}


def _lib(route: str):
    name, argtypes = _ARGTYPES[route]
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:  # declare once: untyped ints would truncate the pointers
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset=None,
                    kv_len=None, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal flash attention over flat (BH, S, D) tensors; ``scale``
    defaults to D^-1/2 (pass 1.0 for a pre-scaled q).  CPU tensors take
    :func:`attention_plain`; CUDA tensors launch the kernel of
    :func:`flash_plan` or raise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, q_offset=q_offset, kv_len=kv_len, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v)
    bh, sq, d = q.shape
    plan = flash_plan(bh, sq, v.shape[1], d, v.shape[2], q.dtype, sm_count(q.device))
    return _launch(q, k, v, plan, q_offset=q_offset, kv_len=kv_len, causal=causal, scale=scale)


def _launch(q, k, v, plan: Tuple[str, int, int], *, q_offset, kv_len, causal: bool,
            scale: Optional[float]) -> torch.Tensor:
    """Launch ``plan``'s kernel on CUDA tensors and count the launch."""
    _check(q, k, v)
    _build.refuse_grad("flash_attention", q, k, v)  # forward-only, as the reference's Pallas call
    bh, sq, d = q.shape
    sk, dv = v.shape[1], v.shape[2]
    route, _, splits = plan
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
    if route != "cuda_cores":  # the tensor-core kernels land rows in shared memory by 16-byte cp.async copies
        if flash_route(q.dtype, d, dv) != "tensor_cores":
            raise ValueError(f"route {route!r} takes (D, Dv) in {sorted(TC_PAIRS)}, got {d}/{dv}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            _build.check_aligned(t, name)
    scale = d ** -0.5 if scale is None else float(scale)
    per_row = []  # q_offset, kv_len as (pointer, step, value, wide); the tensors stay referenced until the launch
    for val, default in ((q_offset, 0), (kv_len, sk)):
        per_row += _per_row_arg(val, bh, default, q.device)
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(x.data_ptr() if isinstance(x, torch.Tensor) else x for x in per_row))
    code = _DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "split_kv":
            ws = tickets = None
            if splits > 1:  # f32 partials: O (BH, splits, Sq, Dv), then (m, l) (BH, splits, Sq, 2)
                ws = torch.empty(bh * splits * sq * (dv + 2), dtype=torch.float32, device=q.device)
                tickets = _tickets(q.device, stream, bh * _cdiv(sq, SPLIT_Q_TILE))
            rc = _lib(route)(code, *ptrs, None if ws is None else ws.data_ptr(),
                             None if tickets is None else tickets.data_ptr(), bh, sq, sk, d, dv, splits,
                             _tiles_per_split(sk, splits), scale, int(causal), stream)
        else:
            rc = _lib(route)(code, *ptrs, bh, sq, sk, d, dv, scale, int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed ({route}): cudaError {rc}")
    flash_attention.launches += 1
    if route != "cuda_cores":
        flash_attention.launches_tc += 1
    if route == "split_kv":
        flash_attention.launches_split += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0  # of them, on the tensor cores ("tensor_cores" and "split_kv")
flash_attention.launches_split = 0  # of them, "split_kv"
