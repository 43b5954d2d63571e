"""Mamba2 SSD (state-space duality) block: chunked scan and O(1) decode
(port of ``repro/models/ssm.py``).

The selective SSM of Mamba2 (arXiv:2405.21060),

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)
    y_t = C_t · h_t + D * x_t,

computed chunk-parallel: within a chunk of Q tokens the contribution is a
masked quadratic form; across chunks a Python loop passes the (H, P, N)
state, where the reference runs ``jax.lax.scan``.  One B/C group and a
scalar A per head, as in Mamba2's defaults:

    d_inner = expand * d_model,  H = d_inner / headdim (P), state N
    in_proj -> [z (d_inner) | x (d_inner) | B (N) | C (N) | dt (H)]
    causal depthwise conv (width ssm_conv) over [x | B | C]
    gated RMSNorm, then out_proj

The in and out projections go through ``layers.linear`` (the DiP kernel
under the ``dip`` backend), as in the reference; the einsums, the conv and
the state updates are plain torch, as they are plain ``jnp`` there.  The
recurrent state is float32 and the conv history stays in the compute dtype.
The f32 einsums need IEEE products on the card: they run as cuBLAS f32
GEMMs, which use TF32 only if ``torch.backends.cuda.matmul.allow_tf32`` is
set (off by default), and the conv is a shifted sum, not ``F.conv1d``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.models import attention, layers

__all__ = ["ssm_dims", "rank_dims", "init_ssm_cache", "ssd_block"]


def ssm_dims(cfg) -> Dict[str, int]:
    di, h, n = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
    return dict(d_inner=di, heads=h, headdim=cfg.ssm_headdim, state=n, conv_dim=di + 2 * n,
                in_dim=2 * di + 2 * n + h)


def _tp(plan):
    """The plan whose heads this block splits: a ``tp`` or ``sp`` plan
    (None under no plan and under ``fsdp``, whose ranks run whole blocks
    on their rows)."""
    return plan if plan is not None and plan.strategy in ("tp", "sp") else None


def rank_dims(cfg, plan=None) -> Dict[str, int]:
    """:func:`ssm_dims` as this rank runs the block: under a ``tp`` or
    ``sp`` plan its heads (``first_head``, ``heads``, of ``plan.ssm_heads()``), their
    ``d_inner`` channels and a conv of those plus the whole B and C."""
    dims = ssm_dims(cfg)
    h0, hl = (0, dims["heads"]) if _tp(plan) is None else plan.ssm_heads()
    di = hl * dims["headdim"]
    return dict(dims, first_head=h0, heads=hl, d_inner=di, conv_dim=di + 2 * dims["state"])


def init_ssm_cache(batch: int, cfg, dtype, *, device, plan=None) -> Dict:
    """conv history (B, ssm_conv - 1, conv_dim) in ``dtype``; state (B, H,
    P, N) in float32; ``pos`` a 0-dim int64 tensor on ``device``, as the
    reference's device scalar.  Under a ``tp`` plan the rank's heads and
    conv channels (:func:`rank_dims`)."""
    dims = rank_dims(cfg, plan)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, dims["conv_dim"]), dtype=dtype, device=device),
        "state": torch.zeros((batch, dims["heads"], cfg.ssm_headdim, dims["state"]), dtype=torch.float32,
                             device=device),
        "pos": attention.init_pos(device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width K as the reference's shifted sum, then
    SiLU.  xbc: (B, L, C), w: (K, C), b: (C,); ``history`` (B, K-1, C)
    stands in for the zero left padding."""
    k, length = w.shape[0], xbc.shape[1]
    if history is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = history.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                    # (B, L+K-1, C)
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + length, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def _chunked(dt, a, bmat, cmat, xh, init, q):
    """The chunked SSD over (B, L, ...) inputs, L a multiple of ``q``:
    returns y (B, L, H, P) in float32 and the last state (B, H, P, N)."""
    bsz, length, h, pdim = xh.shape
    n = bmat.shape[-1]
    nc = length // q

    def r(t, shape):  # (B, L, ...) -> (B, nc, Q, ...)
        return t.reshape((bsz, nc, q) + shape)

    dt_c = r(dt, (h,))
    b_c = r(bmat.float(), (n,))
    c_c = r(cmat.float(), (n,))
    x_c = r(xh.float(), (h, pdim))

    cum = torch.cumsum(dt_c * a, dim=2)                                  # (B,nc,Q,H) within-chunk decay
    total = cum[:, :, -1, :]                                             # (B,nc,H)
    # intra-chunk: L[t,s] = exp(cum[t] - cum[s]) for s <= t.  The mask
    # selects BEFORE the exp: for s > t the difference is positive and its
    # exp would overflow
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]                 # (B,nc,Q,Q,H)
    mask = torch.ones((q, q), dtype=torch.bool, device=dt.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, diff, torch.full_like(diff, float("-inf"))))
    cb = torch.einsum("bcqn,bcsn->bcqs", c_c, b_c)                       # (B,nc,Q,Q)
    att = cb[..., None] * decay * dt_c[:, :, None, :, :]                 # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", att, x_c)

    # each chunk's outgoing state: sum_s exp(total - cum[s]) dt_s B_s x_s
    w = dt_c * torch.exp(total[:, :, None, :] - cum)                     # (B,nc,Q,H)
    dbx = torch.einsum("bcqhn,bcqhp->bchpn", w[..., None] * b_c[:, :, :, None, :], x_c)

    # the scan across chunks (the only serial dependency)
    hprev, hprevs = init, []
    for c in range(nc):
        hprevs.append(hprev)
        hprev = hprev * torch.exp(total[:, c])[:, :, None, None] + dbx[:, c]
    hprevs = torch.stack(hprevs, dim=1)                                  # (B,nc,H,P,N)

    # inter-chunk: C_t · exp(cum[t]) h_prev
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", c_c, hprevs) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(bsz, length, h, pdim), hprev


def _in_proj(x, w, lk, tp, rows=None) -> torch.Tensor:
    """z | x | B | C | dt, all ``in_dim`` columns, on every rank: under a
    ``tp`` plan a column-parallel ``in_proj``'s shards (each padded to its
    storage width: the last ones hold the padding columns) are
    all-gathered (one ``all_gather``) and cropped; a replicated one gives
    them whole.  Under ``sp`` (``rows``) of every real row, as (B, L, .):
    a column-parallel ``in_proj`` (``dip_sp``) gives every row of the
    rank's columns, cropped to the real rows before the gather of columns;
    a replicated one the rank's rows of every column, then one all-gather
    of rows (``layers.sp_columns``)."""
    y = layers.linear(x, w, **lk)
    column = getattr(getattr(w, "plan", None), "kind", None) == "column"
    if rows is not None:
        y = layers.sp_columns(y, w, rows)
    if tp is None or not column:
        return y
    y = F.pad(y, (0, w.data.shape[-1] - y.shape[-1]))
    return comm.all_gather(y, tp.mesh, tp.tp, dim=-1)[..., :w.d_out]


def _gated_norm(y: torch.Tensor, gain: torch.Tensor, eps: float, d_inner: int, tp) -> torch.Tensor:
    """``layers.rms_norm`` over the whole ``d_inner`` row; under a ``tp``
    plan the rank holds ``d_inner / T`` channels of it, so the rows' sums
    of squares are summed over the ranks (one ``psum``) and the rank
    scales its own channels by the same f32 arithmetic."""
    if tp is None:
        return layers.rms_norm(y, gain, eps)
    y32 = y.float()
    ssq = comm.psum(torch.sum(y32 * y32, dim=-1, keepdim=True), tp.mesh, tp.tp)
    return (y32 * torch.rsqrt(ssq / d_inner + eps) * gain.float()).to(y.dtype)


def ssd_block(x: torch.Tensor, p: Dict, cfg, *, cache: Optional[Dict] = None,
              residual: Optional[torch.Tensor] = None, plan=None,
              rows=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Mamba2 block on x (B, L, d): the chunked SSD, or with a cache and
    L = 1 the O(1) decode update.  ``cache`` (``init_ssm_cache``, one
    layer's) is read, not written: the returned cache holds the new conv
    history and state, and ``pos`` advanced by L.  ``residual`` fuses the
    block's skip connection into the out projection's epilogue (the result
    is then the updated residual stream).

    Under a ``tp`` plan (on ``ShardingPlan.shard_params`` leaves; the port
    of the reference's ``ssd_block(plan=)``) the rank runs its H / T heads:
    the whole z | x | B | C | dt on every rank (:func:`_in_proj`), of which
    it takes its heads' z, x and dt and the whole B and C; the conv on its
    x channels and B and C, whose history its cache holds; the scan or the
    O(1) update on its heads, whose state its cache holds; the gated norm
    with one psum (:func:`_gated_norm`); ``out_proj`` row-parallel over its
    ``d_inner / T`` channels (one all-reduce, the residual added once): 3
    collectives a block with a column-parallel ``in_proj``, 2 with a
    replicated one.  Under ``fsdp`` the block runs whole on the rank's rows
    and its projections gather their storage (``dip_fsdp``).

    Under ``sp`` (``rows``, a ``layers.SeqRows``: x and the residual the
    rank's rows (m, d) of the stream) the scan needs every row of a
    sequence in order, so the rank runs its heads over every row as under
    ``tp``: ``in_proj`` gives them (:func:`_in_proj`: one ring hop and the
    gather of columns where column-parallel, one all-gather of rows where
    replicated), and ``out_proj`` is ``dip_sp``'s row path on the T m rows
    padded back (one reduce-scatter), returning the rank's rows with the
    residual added: 4 collectives a block with a column-parallel
    ``in_proj`` on 2 ranks, 3 with a replicated one.  The pad rows never
    reach the conv history or the state."""
    bsz, seqlen = (rows.batch, rows.seq) if rows is not None else x.shape[:2]
    tp = _tp(plan)
    dims = rank_dims(cfg, plan)
    di, h, pdim, n = dims["d_inner"], dims["heads"], dims["headdim"], dims["state"]
    lk = dict(backend=cfg.matmul_backend, compute_dtype=x.dtype)

    zxbcdt = _in_proj(x, p["in_proj"], lk, tp, rows)    # cropped to in_dim
    z, xin, bmat, cmat, dt = torch.split(zxbcdt, [cfg.d_inner, cfg.d_inner, n, n, cfg.n_ssm_heads], dim=-1)
    if tp is not None:  # the rank's heads of z, x and dt
        c0, h0 = dims["first_head"] * pdim, dims["first_head"]
        z, xin, dt = z[..., c0:c0 + di], xin[..., c0:c0 + di], dt[..., h0:h0 + h]

    xbc = torch.cat([xin, bmat, cmat], dim=-1)          # (B, L, conv_dim)
    if cache is not None:
        hist = cache["conv"]
        new_conv = torch.cat([hist, xbc.to(hist.dtype)], dim=1)[:, -(cfg.ssm_conv - 1):, :]
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"], history=hist)
    else:
        new_conv = None
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xin, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B, L, H)
    a = -torch.exp(p["A_log"].float())                  # (H,) < 0
    xh = xin.reshape(bsz, seqlen, h, pdim)
    d_skip = p["D"].float()

    if cache is not None and seqlen == 1:
        # O(1) decode
        x0 = xh[:, 0].float()                                             # (B, H, P)
        da = torch.exp(dt[:, 0] * a[None, :])                            # (B, H)
        dbx = (dt[:, 0, :, None] * x0)[..., None] * bmat[:, 0].float()[:, None, None, :]
        state = cache["state"] * da[:, :, None, None] + dbx
        y = torch.einsum("bhpn,bn->bhp", state, cmat[:, 0].float()) + d_skip[None, :, None] * x0
        y = y.reshape(bsz, 1, di)
        new_cache = {"conv": new_conv, "state": state, "pos": cache["pos"] + 1}
    else:
        # chunked SSD, padded to a chunk multiple with inert steps: dt = 0
        # makes the state update an exact identity (exp(0 * A) = 1, dB x =
        # 0), so the carried state and the real positions are unaffected
        q = min(cfg.ssm_chunk, seqlen)
        pad = (-seqlen) % q
        if pad:
            dt, bmat, cmat, xh = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (dt, bmat, cmat, xh))
        init = cache["state"] if cache is not None else torch.zeros(
            (bsz, h, pdim, n), dtype=torch.float32, device=x.device)
        y, hlast = _chunked(dt, a, bmat, cmat, xh, init, q)
        y = y + d_skip[None, None, :, None] * xh.float()
        y = y.reshape(bsz, seqlen + pad, di)[:, :seqlen]
        new_cache = None if cache is None else {"conv": new_conv, "state": hlast, "pos": cache["pos"] + seqlen}

    # gated RMSNorm, then the out projection (skip connection in its epilogue)
    y = y.to(x.dtype) * F.silu(z)
    y = _gated_norm(y, p["norm"], cfg.norm_eps, cfg.d_inner, tp)
    if rows is not None:
        y = rows.pad(y)
    if residual is not None:
        out = layers.linear(y, p["out_proj"], epilogue="residual", epilogue_operands=(residual,), **lk)
    else:
        out = layers.linear(y, p["out_proj"], **lk)
    return out, new_cache
