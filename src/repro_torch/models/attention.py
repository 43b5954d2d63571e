"""GQA attention with a dense KV cache, flash-routed chunked prefill, and
paged decode; DeepSeek-style multi-head latent attention (MLA) with its
latent caches (port of ``repro/models/attention.py``).

``attention_core`` keeps the reference's GQA broadcast (KV heads expanded to
the query heads) and its three routes: the dense f32 path (the training
forward's), the KV-chunked online-softmax path (``kv_chunk > 0``, exact
against the dense one), and the ``api.attention`` route
(``backend="flash"``) that serving prefill takes; the flash kernel is
forward-only.  The paged functions are plain torch, as they are plain
``jnp`` in the reference; they update the block pool in place.  An int8
pool (``kv_quant="int8"``) stores each (token, head) row as int8 codes plus
one f32 scale (``api.quant.quantize_rows``) and dequantizes on read.

MLA caches the compressed latent ``c_kv`` (``kv_lora_rank`` wide) and the
single shared RoPE key ``k_rope`` per token, with no head axis: without a
cache it computes the naive form (per-head K and V expanded from the
latent, through ``attention_core``), with one the absorbed form (scores
against the latent itself, ``W_uk`` absorbed into q, ``W_uv`` applied after
the weighted sum).  Its int8 latent pools store each token's c_kv and
k_rope rows as codes with one f32 scale per token (no head axis).

Under a ``ShardingPlan`` (``plan=``, the ``tp`` and ``ep`` strategies) the
GQA functions run on this rank's heads: q/k/v come from column-parallel
projections (a replicated K/V projection, whose width does not split over
the axis, gives every head and the rank takes its block), the cache holds
the rank's KV heads, and ``wo`` is row-parallel over the heads.  MLA runs
on the rank's heads too: q from ``wq``, and the natural ``w_uk`` / ``w_uv``
of the rank's shard, (r, H/T, .) (each column-parallel, or replicated by
the width fallback, the rank then taking its block); the latent is whole on
every rank: ``w_dkv``'s column-parallel output (the reference's plan splits
it) is all-gathered, one all-gather a layer, and ``w_krope`` (replicated
where 64 / T columns are no 64-tile shard) gives the whole RoPE key; the
latent caches and pools are whole on every rank; ``wo`` is row-parallel.

Under ``sp`` (``rows=``, a ``layers.SeqRows``) the GQA functions take the
rank's rows of the stream (2-D, (m, d)) and convert at their boundary: each
column projection (``dip_sp``) gives every row of the rank's heads, cropped
to the real rows and viewed as (B, S, ...) (``layers.sp_columns``; a
replicated K/V projection gives the rank's rows of every head, then one
all-gather of rows); RoPE, the cache write and attention run as under
``tp``; the output is padded back to T m rows for ``wo``'s row-parallel
``dip_sp`` (one reduce-scatter), which returns the rank's rows with the
residual added.  Under ``fsdp`` (model axis 1) every function runs whole on
the rank's rows: the projections gather their storage in ``dip_fsdp``, and
MLA gathers ``w_uk`` / ``w_uv`` before de-shearing them (one all-gather
each).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import api
from repro_torch.distributed import comm
from repro_torch.models import layers

__all__ = [
    "attention_core",
    "init_pos",
    "gqa_attention",
    "mla_attention",
    "init_gqa_cache",
    "init_mla_cache",
    "init_paged_gqa_cache",
    "init_paged_mla_cache",
    "paged_write",
    "paged_read",
    "paged_gqa_attention",
    "paged_mla_attention",
]

NEG_INF = -1e30


def _natural(w, plan=None):
    """Natural-layout view of a weight (de-shears a ``DipWeight``): MLA's
    absorbed form contracts ``w_uk`` / ``w_uv`` per head, so the permutated
    storage cannot be consumed directly.  De-sheared on every call, as the
    reference does; under ``fsdp`` the rank's K rows of the storage are
    all-gathered first (one all-gather)."""
    if not isinstance(w, (api.DipWeight, api.QuantizedDipWeight)):
        return w
    if plan is not None and plan.strategy == "fsdp" and getattr(w.plan, "fsdp", None):
        data = comm.all_gather(w.data, plan.mesh, plan.fsdp, dim=-2)
        w = w.with_data(data, w.scale) if isinstance(w, api.QuantizedDipWeight) else w.with_data(data)
    return w.to_natural()


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(..., Sq, Sk) additive mask from absolute positions."""
    live = q_pos[..., :, None] >= k_pos[..., None, :]
    return torch.where(live, 0.0, NEG_INF).float()


def _expand_kv(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*groups, D): each KV head repeated for its
    query-head group, as the reference broadcasts it."""
    if groups == 1:
        return t
    b, s, kv, d = t.shape
    return t[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(b, s, kv * groups, d)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                   k_pos: torch.Tensor, *, kv_valid_len: Union[int, torch.Tensor, None] = None,
                   kv_chunk: int = 0, backend: Optional[str] = None) -> torch.Tensor:
    """Scaled-dot-product GQA attention: q (B, Sq, H, D), k (B, Sk, KV, D),
    v (B, Sk, KV, Dv) -> (B, Sq, H, Dv).  ``backend`` routes through
    ``api.attention`` (contiguous positions: the query block sits at key
    offset ``q_pos[0] - k_pos[0]``) and subsumes ``kv_chunk``; None takes
    the dense path, or with ``kv_chunk > 0`` (dividing Sk) streams KV in
    chunks with an online softmax: O(Sq * chunk) live scores, exact."""
    b, sq, h, d = q.shape
    _, sk, kv, dv = v.shape
    q = (q * d ** -0.5).to(q.dtype)
    k = _expand_kv(k, h // kv)
    v = _expand_kv(v, h // kv)

    if backend is not None:
        q_f = q.transpose(1, 2).reshape(b * h, sq, d)
        k_f = k.transpose(1, 2).reshape(b * h, sk, d)
        v_f = v.transpose(1, 2).reshape(b * h, sk, dv)
        out = api.attention(q_f, k_f, v_f, backend=backend, causal=True,
                            q_offset=(q_pos[0] - k_pos[0]), kv_len=kv_valid_len,
                            scale=1.0)  # q pre-scaled above
        return out.reshape(b, h, sq, dv).transpose(1, 2).to(v.dtype)

    def masked_scores(kc, kpc):
        s = torch.einsum("bqhd,bshd->bhqs", q.float(), kc.float())
        s = s + _causal_mask(q_pos, kpc)[None, None]
        if kv_valid_len is not None:
            live = (kpc < kv_valid_len)[None, None, None, :]
            s = torch.where(live, s, torch.full_like(s, NEG_INF))
        return s

    if kv_chunk <= 0 or sk <= kv_chunk:
        probs = torch.softmax(masked_scores(k, k_pos), dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)

    # online softmax over KV chunks (the flash-attention recurrence)
    if sk % kv_chunk:
        raise ValueError(f"kv_chunk={kv_chunk} must divide Sk={sk}: pad KV to a chunk multiple")
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, kv_chunk):
        s = masked_scores(k[:, c0:c0 + kv_chunk], k_pos[c0:c0 + kv_chunk])
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqs,bshd->bhqd", p, v[:, c0:c0 + kv_chunk].float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(v.dtype)


def init_pos(device) -> torch.Tensor:
    """A dense cache's write position: a 0-dim int64 tensor on the cache's
    device, as the reference's ``pos`` is a device scalar, so that a step
    reads and advances it without the host (a CUDA graph of the step then
    serves every chunk of every prompt)."""
    return torch.zeros((), dtype=torch.int64, device=device)


def init_gqa_cache(batch: int, kv_heads: int, max_seq: int, head_dim: int, dtype,
                   device) -> Dict:
    return {
        "k": torch.zeros((batch, max_seq, kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, kv_heads, head_dim), dtype=dtype, device=device),
        "pos": init_pos(device),
    }


def _write_rows(cache: torch.Tensor, positions: torch.Tensor, vals: torch.Tensor) -> None:
    """Write a chunk's rows (B, S, ...) into a dense cache (B, max_seq, ...)
    in place at its tokens' positions (S,), pos .. pos + S - 1: the
    reference's ``dynamic_update_slice`` at the device position."""
    cache.index_copy_(1, positions, vals.to(cache.dtype))


def _heads(cfg, plan) -> Tuple[int, int]:
    """(query heads, KV heads) this rank attends with."""
    if plan is None:
        return cfg.n_heads, cfg.n_kv_heads
    return cfg.n_heads // plan.tp_size, cfg.n_kv_heads // plan.tp_size


def _own_heads(y: torch.Tensor, w, n: int, hd: int, plan) -> torch.Tensor:
    """A projection's columns of this rank's ``n`` heads: a column-parallel
    weight gives just those; a replicated one gives every head, of which the
    rank takes its block."""
    if plan is None or getattr(getattr(w, "plan", None), "kind", None) == "column":
        return y
    r = plan.tp_rank
    return y[..., r * n * hd:(r + 1) * n * hd]


def _whole_columns(y: torch.Tensor, w, plan) -> torch.Tensor:
    """A projection's whole output on every rank: a column-parallel
    weight's shards all-gathered (one ``all_gather``; none over a model
    axis of 1), any other as it is."""
    if plan is None or plan.tp_size == 1 or getattr(getattr(w, "plan", None), "kind", None) != "column":
        return y
    return comm.all_gather(y, plan.mesh, plan.tp, dim=-1)


def _batch(x, rows) -> Tuple[int, int]:
    """(B, S) of the block's input: x's leading dims, or under ``sp`` the
    row layout's."""
    return (rows.batch, rows.seq) if rows is not None else tuple(x.shape[:2])


def _qkv(x, p, cfg, nk, plan, rows=None):
    """q (B, S, H, hd), k and v (B, S, KV, hd) on this rank's heads (under
    ``sp`` every real row of them, from the rank's rows of x)."""
    b, s = _batch(x, rows)
    (h, kv), hd = _heads(cfg, plan), cfg.resolved_head_dim

    def proj(name, bias, n):
        y = layers.linear(x, p[name], p.get(bias), **nk)
        if rows is not None:
            y = layers.sp_columns(y, p[name], rows)
        return _own_heads(y, p[name], n, hd, plan).reshape(b, s, n, hd)

    return proj("wq", "bq", h), proj("wk", "bk", kv), proj("wv", "bv", kv)


def _proj_kwargs(cfg, x, norm):
    lk = dict(backend=cfg.matmul_backend, compute_dtype=x.dtype)
    nk = dict(lk) if norm is None else dict(lk, prologue="rmsnorm", prologue_operands=(norm,),
                                            prologue_eps=cfg.norm_eps)
    return lk, nk


def _out_proj(out, p, lk, residual, rows=None):
    """``wo`` on the attention output (B, S, heads), the residual fused;
    under ``sp`` on all T m rows, returning the rank's m."""
    if rows is not None:
        out = rows.pad(out)
    if residual is not None:
        return layers.linear(out, p["wo"], epilogue="residual", epilogue_operands=(residual,), **lk)
    return layers.linear(out, p["wo"], **lk)


def gqa_attention(x: torch.Tensor, p: Dict, cfg, *, positions: torch.Tensor,
                  cache: Optional[Dict] = None, rope=None,
                  residual: Optional[torch.Tensor] = None, norm: Optional[torch.Tensor] = None,
                  kv_chunk: int = 0, attn_backend: Optional[str] = None,
                  plan=None, rows=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Projections + RoPE + cache update + attention + out projection.

    ``cache`` is one layer's dense cache (``init_gqa_cache``); this chunk's
    K/V are written into it in place at its ``positions`` (``cache["pos"]``
    onward; an int or a device scalar) and the returned cache has ``pos``
    advanced.  ``residual`` fuses the block's skip
    connection into the out projection; ``norm`` is the attention-norm gain
    when the backend fuses prologues (x then arrives un-normalized).
    ``plan``: this rank's heads; ``rows``: the ``sp`` layout, x and the
    residual the rank's rows (module doc)."""
    b, s = _batch(x, rows)
    (h, _), hd = _heads(cfg, plan), cfg.resolved_head_dim
    lk, nk = _proj_kwargs(cfg, x, norm)
    q, k, v = _qkv(x, p, cfg, nk, plan, rows)
    q = layers.apply_rope(q, positions, cfg.rope_theta, tables=rope)
    k = layers.apply_rope(k, positions, cfg.rope_theta, tables=rope)

    if cache is None:
        out = attention_core(q, k, v, positions, positions, kv_chunk=kv_chunk, backend=attn_backend)
        new_cache = None
    else:
        end = cache["pos"] + s
        ck, cv = cache["k"], cache["v"]
        _write_rows(ck, positions, k)
        _write_rows(cv, positions, v)
        k_pos = torch.arange(ck.shape[1], device=x.device)
        out = attention_core(q, ck, cv, positions, k_pos, kv_valid_len=end,
                             kv_chunk=kv_chunk, backend=attn_backend)
        new_cache = {"k": ck, "v": cv, "pos": end}
    return _out_proj(out.reshape(b, s, h * hd), p, lk, residual, rows), new_cache


# ------------------------------------------------------------------- paged --
# K/V live in a pool of fixed-size blocks shared by every sequence; a
# per-slot block table maps logical position t to flat physical row
# table[t // block_size] * block_size + t % block_size.  Block 0 is the null
# block that free slots write into (see serving/kv_cache.py).

def init_paged_gqa_cache(num_blocks: int, block_size: int, kv_heads: int, head_dim: int,
                         dtype, kv_quant: str = "none", *, device) -> Dict:
    """GQA block pool: k/v (num_blocks, block_size, kv_heads, head_dim); a
    quantized pool stores the scheme's codes and adds per-(token, head) f32
    scales k_scale/v_scale (num_blocks, block_size, kv_heads)."""
    shape = (num_blocks, block_size, kv_heads, head_dim)
    if kv_quant == "none":
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    sdt = api.quant.scheme_info(kv_quant).storage_dtype
    return {"k": torch.zeros(shape, dtype=sdt, device=device),
            "v": torch.zeros(shape, dtype=sdt, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}


def _rows(pool: torch.Tensor) -> torch.Tensor:
    """The pool as flat token rows (num_blocks * block_size, ...); float8
    codes move as bytes (torch has no float8 ``index_copy_``)."""
    nb, bs = pool.shape[:2]
    flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
    return flat.view(torch.uint8) if flat.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else flat


def paged_write(pool: torch.Tensor, phys: torch.Tensor, vals: torch.Tensor, *,
                scale_pool: Optional[torch.Tensor] = None, kv_quant: str = "none") -> torch.Tensor:
    """Write per-token rows ``vals`` (N, ...) into the block pool at flat
    physical rows ``phys`` (N,), in place; a quantized pool takes each row's
    codes and its scale (into ``scale_pool``).  Every index must be in
    range: callers drop padding rows themselves (the reference's
    out-of-range sentinel)."""
    if kv_quant != "none":
        q, scale = api.quant.quantize_rows(vals, kv_quant)
        rows = _rows(pool)
        rows.index_copy_(0, phys, q.view(rows.dtype))
        _rows(scale_pool).index_copy_(0, phys, scale[..., 0])
        return pool
    _rows(pool).index_copy_(0, phys, vals.to(pool.dtype))
    return pool


def paged_read(pool: torch.Tensor, idx: torch.Tensor, *, scale_pool: Optional[torch.Tensor] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Gather token rows at flat physical indices ``idx`` (any shape),
    dequantized against ``scale_pool`` when the pool is quantized."""
    nb, bs = pool.shape[:2]
    vals = pool.view((nb * bs,) + tuple(pool.shape[2:]))[idx]
    if scale_pool is not None:
        return api.quant.dequantize_rows(vals, _rows(scale_pool)[idx][..., None], dtype)
    return vals.to(dtype)


def _gather_indices(block_tables: torch.Tensor, block_size: int) -> torch.Tensor:
    """(B, n_blocks) block tables -> (B, n_blocks * block_size) flat rows."""
    b, nblk = block_tables.shape
    idx = block_tables[:, :, None] * block_size + torch.arange(
        block_size, device=block_tables.device, dtype=block_tables.dtype)[None, None, :]
    return idx.reshape(b, nblk * block_size)


def paged_gqa_attention(x: torch.Tensor, p: Dict, cfg, *, positions: torch.Tensor, cache: Dict,
                        block_tables: torch.Tensor, kv_quant: str = "none", rope=None,
                        residual: Optional[torch.Tensor] = None,
                        norm: Optional[torch.Tensor] = None, plan=None,
                        rows=None) -> Tuple[torch.Tensor, Dict]:
    """GQA decode against the paged pool: x (B, 1, d), one token per slot at
    ``positions`` (B,).  Writes this token's K/V into its slot's block (in
    place), gathers the slot's context and attends to positions <= its own.
    Free slots point at the null block; their rows are ignored.  A quantized
    pool (``kv_quant``) stores the rows as codes and scales.  ``plan``: this
    rank's heads; ``rows``: the ``sp`` layout (module doc)."""
    b, s = _batch(x, rows)
    (h, kv), hd = _heads(cfg, plan), cfg.resolved_head_dim
    bs = cache["k"].shape[1]
    lk, nk = _proj_kwargs(cfg, x, norm)
    q, k, v = _qkv(x, p, cfg, nk, plan, rows)
    pos2 = positions[:, None]
    q = layers.apply_rope(q, pos2, cfg.rope_theta, tables=rope)
    k = layers.apply_rope(k, pos2, cfg.rope_theta, tables=rope)

    slot_ids = torch.arange(b, device=x.device)
    phys = block_tables[slot_ids, positions // bs] * bs + positions % bs
    cks, cvs = cache.get("k_scale"), cache.get("v_scale")
    ck = paged_write(cache["k"], phys, k[:, 0], scale_pool=cks, kv_quant=kv_quant)
    cv = paged_write(cache["v"], phys, v[:, 0], scale_pool=cvs, kv_quant=kv_quant)

    idx = _gather_indices(block_tables, bs)
    k_all = _expand_kv(paged_read(ck, idx, scale_pool=cks, dtype=x.dtype), h // kv)
    v_all = _expand_kv(paged_read(cv, idx, scale_pool=cvs, dtype=x.dtype), h // kv)
    smax = k_all.shape[1]
    scores = torch.einsum("bqhd,bshd->bhqs", (q * hd ** -0.5).float(), k_all.float())
    live = torch.arange(smax, device=x.device)[None, :] <= positions[:, None]
    scores = torch.where(live[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(v_all.dtype), v_all)
    new_cache = {"k": ck, "v": cv}
    if kv_quant != "none":
        new_cache.update(k_scale=cks, v_scale=cvs)
    return _out_proj(out.reshape(b, s, h * hd), p, lk, residual, rows), new_cache


# --------------------------------------------------------------------- MLA --
def init_mla_cache(batch: int, max_seq: int, cfg, dtype, device) -> Dict:
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": init_pos(device),
    }


def _mla_heads(cfg, plan) -> int:
    return cfg.n_heads if plan is None else cfg.n_heads // plan.tp_size


def _mla_projections(x, p, cfg, nk, rope, pos, plan=None):
    """q split into its no-RoPE and RoPE parts (RoPE applied), the latent
    c_kv and the shared RoPE key (whole on every rank), and the natural
    w_uk / w_uv per head, on this rank's heads under a plan."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h, r = _mla_heads(cfg, plan), cfg.kv_lora_rank
    q = _own_heads(layers.linear(x, p["wq"], **nk), p["wq"], h, dn + dr, plan).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], layers.apply_rope(q[..., dn:], pos, cfg.rope_theta, tables=rope)
    c_kv = _whole_columns(layers.linear(x, p["w_dkv"], **nk), p["w_dkv"], plan)        # (B, S, r)
    k_rope = _whole_columns(layers.linear(x, p["w_krope"], **nk), p["w_krope"], plan)  # (B, S, dr) shared
    k_rope = layers.apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta, tables=rope)[:, :, 0, :]
    w_uk = _own_heads(_natural(p["w_uk"], plan), p["w_uk"], h, dn, plan).to(x.dtype).reshape(r, h, dn)
    w_uv = _own_heads(_natural(p["w_uv"], plan), p["w_uv"], h, dv, plan).to(x.dtype).reshape(r, h, dv)
    return q_nope, q_rope, c_kv, k_rope, w_uk, w_uv


def _absorbed(q_nope, q_rope, cc, cr, w_uk, w_uv, live, cfg):
    """Scores against the latent cache itself (q_nope @ W_uk . c_kv +
    q_rope . k_rope), f32 softmax over the live positions, then
    (probs @ c_kv) @ W_uv.  ``live``: (B or 1, S, T) bool."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)                      # (B, S, H, r)
    s_lat = torch.einsum("bshr,btr->bhst", q_lat.float(), cc.float())
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(), cr.float())
    scores = (s_lat + s_rope) * (dn + dr) ** -0.5
    scores = torch.where(live[:, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhst,btr->bshr", probs.to(cc.dtype), cc)         # (B, S, H, r)
    return torch.einsum("bshr,rhd->bshd", out_lat, w_uv)


def mla_attention(x: torch.Tensor, p: Dict, cfg, *, positions: torch.Tensor,
                  cache: Optional[Dict] = None, rope=None, residual: Optional[torch.Tensor] = None,
                  norm: Optional[torch.Tensor] = None, kv_chunk: int = 0,
                  attn_backend: Optional[str] = None, plan=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """DeepSeek-V2 multi-head latent attention.

    Params: wq (d, H*(nope+rope)); w_dkv (d, kv_lora); w_krope (d, rope);
    w_uk (kv_lora, H*nope); w_uv (kv_lora, H*v_dim); wo (H*v_dim, d).
    Without a cache the naive form materializes per-head K and V and runs
    ``attention_core`` (``attn_backend``, ``kv_chunk``); with one
    (``init_mla_cache``, written in place at its ``positions``) the absorbed
    form attends in latent space and ignores ``attn_backend``, as the
    reference does.  ``residual`` / ``norm`` as in ``gqa_attention``;
    ``plan``: this rank's heads (module doc)."""
    b, s, _ = x.shape
    h, dr, dv = _mla_heads(cfg, plan), cfg.qk_rope_head_dim, cfg.v_head_dim
    lk, nk = _proj_kwargs(cfg, x, norm)
    q_nope, q_rope, c_kv, k_rope, w_uk, w_uv = _mla_projections(x, p, cfg, nk, rope, positions, plan)

    if cache is None:
        k_nope = torch.einsum("bsr,rhd->bshd", c_kv, w_uk)
        v = torch.einsum("bsr,rhd->bshd", c_kv, w_uv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], -1)
        qc = torch.cat([q_nope, q_rope], -1)
        out = attention_core(qc, k, v, positions, positions, kv_chunk=kv_chunk, backend=attn_backend)
        new_cache = None
    else:
        end = cache["pos"] + s
        cc, cr = cache["c_kv"], cache["k_rope"]
        _write_rows(cc, positions, c_kv)
        _write_rows(cr, positions, k_rope)
        k_pos = torch.arange(cc.shape[1], device=x.device)
        live = (positions[:, None] >= k_pos[None, :]) & (k_pos < end)[None, :]
        out = _absorbed(q_nope, q_rope, cc, cr, w_uk, w_uv, live[None], cfg)
        new_cache = {"c_kv": cc, "k_rope": cr, "pos": end}
    return _out_proj(out.reshape(b, s, h * dv), p, lk, residual), new_cache


def init_paged_mla_cache(num_blocks: int, block_size: int, cfg, dtype, kv_quant: str = "none", *,
                         device) -> Dict:
    """MLA block pool: the latent c_kv (num_blocks, block_size, kv_lora_rank)
    and the shared k_rope (num_blocks, block_size, rope), paged like K/V; a
    quantized pool stores the scheme's codes and adds one f32 scale per
    token for each, c_kv_scale/k_rope_scale (num_blocks, block_size)."""
    shapes = {"c_kv": (num_blocks, block_size, cfg.kv_lora_rank),
              "k_rope": (num_blocks, block_size, cfg.qk_rope_head_dim)}
    if kv_quant == "none":
        return {nm: torch.zeros(sh, dtype=dtype, device=device) for nm, sh in shapes.items()}
    sdt = api.quant.scheme_info(kv_quant).storage_dtype
    pool = {nm: torch.zeros(sh, dtype=sdt, device=device) for nm, sh in shapes.items()}
    pool.update({f"{nm}_scale": torch.zeros(sh[:2], dtype=torch.float32, device=device)
                 for nm, sh in shapes.items()})
    return pool


def paged_mla_attention(x: torch.Tensor, p: Dict, cfg, *, positions: torch.Tensor, cache: Dict,
                        block_tables: torch.Tensor, kv_quant: str = "none", rope=None,
                        residual: Optional[torch.Tensor] = None,
                        norm: Optional[torch.Tensor] = None, plan=None) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form MLA decode against the paged latent pool: x (B, 1, d),
    one token per slot at ``positions`` (B,); this token's c_kv and k_rope
    rows are written in place (a quantized pool takes each row's codes and
    its scale), the slot's context gathered (dequantized into x's dtype),
    and positions <= its own attended.  ``plan``: this rank's heads over
    the whole latent pool (module doc)."""
    b, s, _ = x.shape
    h, dv = _mla_heads(cfg, plan), cfg.v_head_dim
    bs = cache["c_kv"].shape[1]
    lk, nk = _proj_kwargs(cfg, x, norm)
    q_nope, q_rope, c_kv, k_rope, w_uk, w_uv = _mla_projections(x, p, cfg, nk, rope, positions[:, None], plan)

    rows = torch.arange(b, device=x.device)
    phys = block_tables[rows, positions // bs] * bs + positions % bs
    ccs, crs = cache.get("c_kv_scale"), cache.get("k_rope_scale")
    cc = paged_write(cache["c_kv"], phys, c_kv[:, 0], scale_pool=ccs, kv_quant=kv_quant)
    cr = paged_write(cache["k_rope"], phys, k_rope[:, 0], scale_pool=crs, kv_quant=kv_quant)
    idx = _gather_indices(block_tables, bs)
    cc_all = paged_read(cc, idx, scale_pool=ccs, dtype=x.dtype)                # (B, Smax, r)
    cr_all = paged_read(cr, idx, scale_pool=crs, dtype=x.dtype)                # (B, Smax, dr)
    live = torch.arange(cc_all.shape[1], device=x.device)[None, :] <= positions[:, None]
    out = _absorbed(q_nope, q_rope, cc_all, cr_all, w_uk, w_uv, live[:, None, :], cfg)
    new_cache = {"c_kv": cc, "k_rope": cr}
    if kv_quant != "none":
        new_cache.update(c_kv_scale=ccs, k_rope_scale=crs)
    return _out_proj(out.reshape(b, s, h * dv), p, lk, residual), new_cache
