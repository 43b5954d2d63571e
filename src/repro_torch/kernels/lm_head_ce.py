"""Fused lm_head + cross-entropy: the (T, V) logits never reach device memory.

Port of ``repro/kernels/lm_head_ce.py``.  Per token the forward keeps two
float32 numbers::

    logz_t = logsumexp_v(x_t @ W)        lab_t = (x_t @ W)[labels_t]

with vocab columns ``>= vocab_size`` masked to -1e30, and the caller builds
``loss_t = logz - lab + z_loss * logz^2``.  The kernel is
``csrc/lm_head_ce.cu``: each block walks the vocab tiles of one split of V
(:func:`split_plan`) with an online logsumexp and a second pass merges the
splits (the TPU kernel walks all of V on a sequential grid axis).  A split
that lies wholly in the vocab padding contributes l = 0.

Bound on the card: by the operations, 2 T D V.  Every pair runs on the
tensor cores (wgmma), and no operand is rounded to TF32.  bf16 x (the
training pair, with the f32 head, and bf16 x bf16): each f32 head element
is split into :data:`W_PARTS` bf16 parts (:func:`bf16_parts`, whose sum is
the element exactly) and x . w is the sum of the part products, each exact
in f32.  f32 x f32 (the first training step in f32 compute): x is split
too, and x . w is the sum of the :data:`F32_PRODUCTS` largest part
products x_i w_j, i + j <= 2 (:func:`repro_torch.kernels._bf16_parts.
split_matmul` is that arithmetic in plain torch).

* :func:`lm_head_ce` returns ``(logz, label_logit)`` through
  :class:`LogzAndLabel`: for a CUDA tensor the forward launches the kernel
  (``lm_head_ce.launches`` counts the launches) or raises; for a CPU tensor
  it runs :func:`lm_head_ce_plain`.  The backward is the reference's chunked
  recompute (``lm_head_ce.py:182-222``) in plain torch f32, chunk by chunk
  over V: ``dz_c = g_logz * softmax + g_lab * onehot``, ``dx += dz_c @ W_c^T``,
  ``dW_c = x^T @ dz_c`` — plain products, as the reference leaves them to XLA.
* :func:`fused_cross_entropy_loss` and :func:`reference_lm_head_ce` keep the
  masking contract of ``models/layers.cross_entropy_loss``: tokens whose label
  is ``ignore_index`` or whose ``mask`` is 0 count neither in the mean nor in
  the gradient; the mean divides by the number of valid tokens.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._bf16_parts import F32_PRODUCTS, bf16_parts

__all__ = [
    "NEG_INF",
    "IGNORE_INDEX",
    "DEFAULT_BLOCK_V",
    "LogzAndLabel",
    "lm_head_ce",
    "lm_head_ce_plain",
    "split_plan",
    "bf16_parts",
    "W_PARTS",
    "F32_PRODUCTS",
    "check_kernel_shape",
    "fused_cross_entropy_loss",
    "reference_lm_head_ce",
]

NEG_INF = -1e30
IGNORE_INDEX = -100
DEFAULT_BLOCK_V = 512  # vocab chunk of the plain version (the reference's block_v)
BWD_BLOCK_V = 4096     # vocab chunk of the backward's recompute
BLOCK_T, BLOCK_V, BLOCK_K = 128, 128, 64  # the CUDA kernel's tiles (BLOCK_K: its contraction step)
W_PARTS = 3  # bf16 parts of an f32 head element on the tensor cores (two miss f32 TOL at the label logit)
BLOCK_K_F32 = 32  # the f32 x f32 mainloop's contraction step
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16)}


def _check(x, w, labels, vocab_size):
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"lm_head_ce takes 2-D x and w, got {tuple(x.shape)} @ {tuple(w.shape)}")
    t, d = x.shape
    if w.shape[0] != d:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    if tuple(labels.shape) != (t,):
        raise ValueError(f"labels {tuple(labels.shape)} do not match x rows {t}")
    if not 1 <= vocab_size <= w.shape[1]:
        raise ValueError(f"vocab_size {vocab_size} must be in [1, {w.shape[1]}]")


def lm_head_ce_plain(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
                     vocab_size: Optional[int] = None,
                     block_v: int = DEFAULT_BLOCK_V) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: walk V in ``block_v`` chunks
    with the same online logsumexp, all in f32; masked columns add 0 to the
    sum (the kernel's guard against exp(0) in a padding-only chunk)."""
    vocab = w.shape[1] if vocab_size is None else int(vocab_size)
    _check(x, w, labels, vocab)
    t = x.shape[0]
    x32 = x.float()
    lab = labels.long().reshape(t, 1)
    m = torch.full((t,), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros((t,), dtype=torch.float32, device=x.device)
    a = torch.zeros((t,), dtype=torch.float32, device=x.device)
    for c0 in range(0, w.shape[1], block_v):
        z = x32 @ w[:, c0:c0 + block_v].float()
        col = torch.arange(c0, c0 + z.shape[1], device=x.device).reshape(1, -1)
        live = col < vocab
        z = torch.where(live, z, NEG_INF)
        m_new = torch.maximum(m, z.max(dim=1).values)
        p = torch.where(live, torch.exp(z - m_new[:, None]), 0.0)
        l = l * torch.exp(m - m_new) + p.sum(dim=1)
        m = m_new
        a = a + torch.where(col == lab, z, 0.0).sum(dim=1)
    return m + torch.log(l), a


def split_plan(t: int, vp: int, sms: int = 132, vocab: Optional[int] = None) -> Tuple[int, int]:
    """``(tiles_per_split, splits)`` of the kernel's vocab split for T rows
    and a Vp-wide head whose first ``vocab`` columns are real.

    The tensor-core kernel runs one block an SM (128 tokens by one split),
    and skips the tiles wholly past ``vocab``.  The splits cut the real
    tiles evenly: ``tiles_per_split`` divides their count, so the padding
    tiles begin a split of their own and never share one with real columns
    (those splits compute nothing and merge as l = 0).  Of the divisors, the
    one whose real blocks come closest to whole waves of ``sms`` blocks,
    the fewest splits on a tie: a last, partly filled wave costs as much as
    a full one."""
    n_t = -(-t // BLOCK_T)
    n_v = -(-vp // BLOCK_V)
    n_r = -(-(vp if vocab is None else vocab) // BLOCK_V)
    best = None
    for tiles in (d for d in range(1, n_r + 1) if n_r % d == 0):
        key = (-(-n_t * (n_r // tiles) // sms) * tiles, -tiles)
        best = key if best is None or key < best else best
    tiles = -best[1]
    splits = n_r // tiles + -(-(n_v - n_r) // tiles)
    if splits > 65535:
        raise ValueError(f"lm_head_ce: {splits} vocab splits exceed the grid limit 65535")
    return tiles, splits


def check_kernel_shape(d: int, vp: int) -> None:
    """The kernel steps D by ``BLOCK_K`` and the head's width by ``BLOCK_V``;
    every configuration's d_model and padded vocab are multiples of both."""
    if d % BLOCK_K or vp % BLOCK_V:
        raise ValueError(f"lm_head_ce kernel needs d_model % {BLOCK_K} == 0 and head width % {BLOCK_V} == 0, "
                         f"got {d} and {vp}")


def _lib():
    fn = _build.load("lm_head_ce").lm_head_ce_launch
    if fn.argtypes is None:  # declare once: untyped ints would truncate the pointers
        # x_dtype, w_dtype; x, w, labels, part, logz, lab; T, D, V, vocab,
        # tiles_per_split, splits; stream
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w, labels, vocab):
    """Launch the kernel on CUDA tensors; returns (logz, label_logit)."""
    _check(x, w, labels, vocab)
    if (x.dtype, w.dtype) not in _PAIRS:
        raise TypeError(f"lm_head_ce kernel takes x/w dtypes {sorted(map(str, _PAIRS))}, "
                        f"got {x.dtype} / {w.dtype}")
    dev = x.device
    if w.device != dev or labels.device != dev:
        raise ValueError(f"x, w and labels must share a device, got {x.device}, {w.device}, {labels.device}")
    t, d = x.shape
    vp = w.shape[1]
    check_kernel_shape(d, vp)
    x, w = x.contiguous(), w.contiguous()
    _build.check_aligned(x, "x")  # the mainloops copy x and w in 16-byte cp.async chunks
    _build.check_aligned(w, "w")
    labels = labels.to(torch.int32).contiguous()
    tiles, splits = split_plan(t, vp, torch.cuda.get_device_properties(dev).multi_processor_count, vocab)
    part = torch.empty((3, splits, t), dtype=torch.float32, device=dev)
    logz = torch.empty((t,), dtype=torch.float32, device=dev)
    lab = torch.empty((t,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib()(_DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype], x.data_ptr(), w.data_ptr(),
                    labels.data_ptr(), part.data_ptr(), logz.data_ptr(), lab.data_ptr(),
                    t, d, vp, vocab, tiles, splits, stream)
    if rc != 0:
        raise RuntimeError(f"lm_head_ce kernel launch failed: cudaError {rc}")
    lm_head_ce.launches += 1
    return logz, lab


class LogzAndLabel(torch.autograd.Function):
    """``(logz, label_logit)`` with the chunked-recompute backward: the
    (T, V) logits are formed neither forward (kernel) nor backward (one
    (T, ``BWD_BLOCK_V``) chunk at a time)."""

    @staticmethod
    def forward(ctx, x, w, labels, vocab):
        if x.device.type == "cpu":
            logz, lab = lm_head_ce_plain(x, w, labels, vocab_size=vocab)
        elif x.device.type == "cuda":
            logz, lab = _launch(x, w, labels, vocab)
        else:
            raise ValueError(f"lm_head_ce runs on cuda or cpu tensors, got {x.device}")
        ctx.save_for_backward(x, w, labels, logz)
        ctx.vocab = vocab
        return logz, lab

    @staticmethod
    def backward(ctx, g_logz, g_lab):
        x, w, labels, logz = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        t, d = x.shape
        vp = w.shape[1]
        x32 = x.float()
        gz, gl = g_logz.float().reshape(t, 1), g_lab.float().reshape(t, 1)
        lab, logz_col = labels.long().reshape(t, 1), logz.reshape(t, 1)
        dx = torch.zeros((t, d), dtype=torch.float32, device=x.device) if need_x else None
        dw = torch.empty((d, vp), dtype=torch.float32, device=x.device) if need_w else None
        for c0 in range(0, vp, BWD_BLOCK_V):
            w_c = w[:, c0:c0 + BWD_BLOCK_V].float()
            z_c = x32 @ w_c
            col = torch.arange(c0, c0 + w_c.shape[1], device=x.device).reshape(1, -1)
            p_c = torch.where(col < ctx.vocab, torch.exp(z_c - logz_col), 0.0)
            dz_c = gz * p_c + gl * (col == lab).float()
            if need_x:
                dx.addmm_(dz_c, w_c.T)
            if need_w:
                dw[:, c0:c0 + w_c.shape[1]] = x32.T @ dz_c
        return (None if dx is None else dx.to(x.dtype), None if dw is None else dw.to(w.dtype),
                None, None)


def lm_head_ce(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
               vocab_size: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token ``(logz, label_logit)``, both float32 (T,), for x (T, D),
    the natural head w (D, Vp) and int labels (T,) (``-100`` never matches a
    column).  Differentiable in x and w.  The kernel takes (x, w) dtype
    pairs (f32, f32), (bf16, f32) and (bf16, bf16)."""
    vocab = w.shape[1] if vocab_size is None else int(vocab_size)
    return LogzAndLabel.apply(x, w, labels, vocab)


lm_head_ce.launches = 0


def _masked_mean(loss_t, labels, mask, ignore_index):
    valid = labels != ignore_index
    if mask is not None:
        valid = valid & (mask.reshape(valid.shape) != 0)
    loss_t = torch.where(valid, loss_t, 0.0)
    return loss_t.sum() / torch.clamp(valid.float().sum(), min=1.0)


def fused_cross_entropy_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
                             z_loss: float = 1e-4, mask: Optional[torch.Tensor] = None,
                             ignore_index: int = IGNORE_INDEX,
                             vocab_size: Optional[int] = None) -> torch.Tensor:
    """Mean token cross entropy straight from hidden states x (..., D) and
    the natural head w (D, Vp): the same value and masking contract as
    ``layers.cross_entropy_loss(x @ w, labels, ...)`` with the padding lanes
    masked, without the logits."""
    d = x.shape[-1]
    lab = labels.reshape(-1)
    logz, lab_logit = lm_head_ce(x.reshape(-1, d), w, lab, vocab_size=vocab_size)
    loss_t = logz - lab_logit
    if z_loss:
        loss_t = loss_t + z_loss * torch.square(logz)
    return _masked_mean(loss_t, lab, mask, ignore_index)


def reference_lm_head_ce(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
                         z_loss: float = 1e-4, mask: Optional[torch.Tensor] = None,
                         ignore_index: int = IGNORE_INDEX,
                         vocab_size: Optional[int] = None) -> torch.Tensor:
    """Unfused oracle: materializes the f32 logits, same arithmetic contract."""
    vocab = w.shape[1] if vocab_size is None else int(vocab_size)
    logits = x.float() @ w.float()
    lane = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(lane < vocab, logits, NEG_INF)
    lab = labels.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, safe[..., None])[..., 0]
    loss_t = logz - label_logits
    if z_loss:
        loss_t = loss_t + z_loss * torch.square(logz)
    return _masked_mean(loss_t, lab, mask, ignore_index)
