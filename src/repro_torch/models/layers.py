"""Shared model layers: DiP-aware linear, RMSNorm, RoPE (port of
``repro/models/layers.py``).

``linear`` is where the paper's technique enters the model: every dense
projection goes through ``api.matmul`` with the configured backend, and a
``DipWeight`` carries its own logical width.  ``cross_entropy_loss`` is the
unfused loss over materialized logits; ``kernels/lm_head_ce.py`` keeps its
masking contract without them.  :class:`SeqRows` is the row layout of the
sequence-parallel (``sp``) model path, and :func:`sp_columns` the all-rows
output of one of its column projections.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import api
from repro_torch.distributed import comm

__all__ = ["linear", "rms_norm", "swiglu", "rope_frequencies", "rope_tables", "apply_rope",
           "cross_entropy_loss", "resolve_constrain", "SeqRows", "sp_columns"]

_BIAS_EPILOGUES = ("bias", "bias_gelu", "bias_silu")


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, *,
           backend: Optional[str] = None, compute_dtype: torch.dtype = torch.bfloat16,
           epilogue: Optional[str] = None, epilogue_operands=(), prologue: Optional[str] = None,
           prologue_operands=(), prologue_eps: float = 1e-5) -> torch.Tensor:
    """``epilogue(prologue(x) @ W)`` through the registered matmul backend,
    with x and W in ``compute_dtype``; a ``QuantizedDipWeight`` keeps its
    storage and scales as they are.  A bias always rides the epilogue;
    ``swiglu`` takes a ``(w_gate, w_up)`` pair; ``prologue="rmsnorm"``
    fuses the pre-projection norm (``prologue_operands=(gain,)``)."""
    x = x.to(compute_dtype)

    def adapt(wi):
        if isinstance(wi, api.QuantizedDipWeight):
            return wi
        return wi.astype(compute_dtype) if isinstance(wi, api.DipWeight) else wi.to(compute_dtype)

    w = tuple(adapt(wi) for wi in w) if isinstance(w, (tuple, list)) else adapt(w)
    operands = tuple(epilogue_operands)
    if b is not None:
        if epilogue is None:
            epilogue = "bias"
        elif epilogue not in _BIAS_EPILOGUES:
            raise ValueError(f"a bias only composes with the bias epilogues {_BIAS_EPILOGUES}, "
                             f"got epilogue={epilogue!r}")
        operands = (b,) + operands
    return api.matmul(x, w, backend=backend, epilogue=epilogue, epilogue_operands=operands,
                      prologue=prologue, prologue_operands=tuple(prologue_operands),
                      prologue_eps=prologue_eps)


class SeqRows:
    """The rows of a (B, S) batch under the ``sp`` model path: the B S rows
    flattened and padded to T m rows, m = ceil(B S / T); rank r holds rows
    r m .. (r + 1) m - 1 of the residual stream (a rank past the real rows
    holds pad rows, zeros at the embedding).  ``dip_sp``'s column
    projections return all T m rows of the rank's columns, its row
    projections the rank's m rows of every column."""

    def __init__(self, plan, batch: int, seq: int):
        self.plan, self.batch, self.seq = plan, int(batch), int(seq)
        self.rows = self.batch * self.seq
        self.local = -(-self.rows // plan.tp_size)

    def pad(self, y: torch.Tensor) -> torch.Tensor:
        """(B, S, n) or (B S, n) -> all T m rows (n), the pad rows zero."""
        y = y.reshape(self.rows, y.shape[-1])
        pad = self.local * self.plan.tp_size - self.rows
        return F.pad(y, (0, 0, 0, pad)) if pad else y

    def whole(self, y: torch.Tensor) -> torch.Tensor:
        """All T m rows -> the real ones as (B, S, n): no pad row reaches a
        cache, a state or the sampler."""
        return y[:self.rows].reshape(self.batch, self.seq, y.shape[-1])

    def own(self, y: torch.Tensor) -> torch.Tensor:
        """Every row (B, S, n), held whole on each rank -> this rank's m."""
        return self.pad(y).narrow(0, self.plan.tp_rank * self.local, self.local)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' rows (m, n) -> every real row (B, S, n) on each rank:
        one all-gather."""
        return self.whole(comm.all_gather(y, self.plan.mesh, self.plan.tp, dim=0))

    def scatter(self, y: torch.Tensor) -> torch.Tensor:
        """Each rank's partial (B, S, n) of every row -> this rank's m rows
        of their sum: one reduce-scatter."""
        return comm.psum_scatter(self.pad(y), self.plan.mesh, self.plan.tp, dim=0)


def sp_columns(y: torch.Tensor, w, rows: SeqRows) -> torch.Tensor:
    """A projection's output under ``sp`` as every real row (B, S, n): a
    column-parallel weight's ``dip_sp`` output (all rows, the rank's
    columns) cropped; a weight the plan leaves replicated (its width does
    not split over the axis) gives the rank's rows of every column, which
    one all-gather of rows completes (counted, ``comm.note_replicated``)."""
    if getattr(getattr(w, "plan", None), "kind", None) == "column":
        return rows.whole(y)
    comm.note_replicated()
    return rows.gather(y)


def resolve_constrain(plan, constrain=None):
    """The one plan -> activation-constraint resolution the model stack
    uses: a plan's ``constrain`` wins, then the bare ``constrain(x, tag)``
    hook, else the identity."""
    if plan is not None:
        return plan.constrain
    return constrain if constrain is not None else (lambda x, tag: x)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate) * up


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies for rotary embeddings (host constant)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


_INV_FREQ: Dict[Tuple[torch.device, int, float], torch.Tensor] = {}


def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` as f32 on ``device``, copied there once per
    (device, head dim, theta): a forward then copies no host data, so a
    CUDA graph can capture it (the reference traces them as a constant)."""
    key = (device, int(head_dim), float(theta))
    inv = _INV_FREQ.get(key)
    if inv is None:
        inv = _INV_FREQ[key] = torch.as_tensor(rope_frequencies(head_dim, theta), dtype=torch.float32,
                                               device=device)
    return inv


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """``(cos, sin)`` tables for the given absolute positions, computed once
    per forward; shapes (..., seq, 1, head_dim/2), float32."""
    angles = positions.float()[..., None] * _inv_freq(head_dim, theta, positions.device)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor], theta: float, *,
               tables=None) -> torch.Tensor:
    """Rotate channel halves; x: (..., seq, n_heads, head_dim)."""
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], theta)
    cos, sin = tables
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 1e-4,
                       mask: Optional[torch.Tensor] = None, ignore_index: int = -100) -> torch.Tensor:
    """Valid-token-mean cross entropy with the z-loss stabilizer, in f32.
    Tokens whose label is ``ignore_index`` and tokens zeroed by ``mask``
    count neither in the mean nor in the gradient; the divisor is the number
    of valid tokens."""
    logits = logits.float()
    labels = labels.long()
    valid = labels != ignore_index
    if mask is not None:
        valid = valid & (mask != 0)
    safe = torch.where(valid, labels, 0)  # ignore_index would be a bad gather
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, safe[..., None])[..., 0]
    loss = logz - label_logits
    if z_loss:
        loss = loss + z_loss * torch.square(logz)
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)
