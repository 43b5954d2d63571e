"""The dense SwiGLU MLP and the routed Mixture-of-Experts layer (port of
``repro/models/moe.py``).

``moe_ffn`` is the reference's dense-style path: token-choice top-k routing
in f32, grouped by sequence (each batch row is one group), a per-group
capacity ``C = moe_capacity(S)`` per expert, tokens past it dropped and
counted, the experts run as batched products over a (G, E, C, d) buffer, and
the outputs gathered back and combined with the renormalized gates.  The
expert banks are plain (E, d, ffe) / (E, ffe, d) tensors multiplied with
``torch.einsum``, as the reference multiplies them with ``jnp.einsum``
outside any Pallas kernel; the shared experts go through ``dense_ffn``, and
so through the DiP kernel.  The expert-parallel path (explicit all-to-all
dispatch) comes with ROADMAP.md Queue 1 "Distributed".
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import layers

__all__ = ["dense_ffn", "moe_capacity", "moe_ffn"]

_DISTRIBUTED = 'ROADMAP.md Queue 1 "Distributed"'


def dense_ffn(x: torch.Tensor, p: Dict, cfg, *, residual: Optional[torch.Tensor] = None,
              norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SwiGLU MLP: the gate and up projections run as ONE dual-weight
    ``swiglu`` dispatch (one kernel launch on the ``dip`` backend), then the
    down projection with the block's skip connection fused as the
    ``residual`` epilogue.  ``norm`` is the pre-FFN RMSNorm gain when the
    backend fuses prologues (x then arrives un-normalized)."""
    lk = dict(backend=cfg.matmul_backend, compute_dtype=x.dtype)
    gk = dict(lk) if norm is None else dict(lk, prologue="rmsnorm", prologue_operands=(norm,),
                                            prologue_eps=cfg.norm_eps)
    h = layers.linear(x, (p["w_gate"], p["w_up"]), epilogue="swiglu", **gk)
    if residual is not None:
        return layers.linear(h, p["w_down"], epilogue="residual", epilogue_operands=(residual,), **lk)
    return layers.linear(h, p["w_down"], **lk)


def moe_capacity(tokens: int, cfg) -> int:
    """Per-group expert capacity: ceil(tokens * k * cf / E), rounded up to a
    multiple of 8, at least 8 (it decides which tokens are dropped)."""
    cap = math.ceil(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def _route(x: torch.Tensor, router: torch.Tensor, cfg, cap: int,
           ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Group-local routing state for ``x`` (G groups of S tokens each): f32
    softmax over the router logits, top-k with renormalized gates (a tie
    goes to the lower expert id, as ``jax.lax.top_k`` breaks it), the
    Switch load-balance + z-loss aux, and the stable sort-by-expert dispatch
    order.  ``dropped`` counts (token, slot) pairs past an expert's
    capacity.  ``ids`` (G, S, k), if given, replaces the top-k choice (the
    gates are then the probabilities at those ids, renormalized)."""
    g, sl, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())       # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k by a stable ascending sort of -probs: equal probabilities keep
    # their expert order, so the lower id wins a tie
    if ids is None:
        neg, ids = torch.sort(-probs, dim=-1, stable=True)
        gates, ids = -neg[..., :k], ids[..., :k]                           # (G, S, k)
    else:
        gates = torch.gather(probs, -1, ids)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance loss (Switch): E * mean(frac_tokens_e * mean_prob_e)
    # (one_hot's exact 0/1 rows as a comparison: on the CPU one_hot reads
    # its input's range back to the host)
    top1 = ids[..., 0, None] == torch.arange(e, device=ids.device, dtype=ids.dtype)
    load = top1.float().mean((0, 1))
    importance = probs.mean((0, 1))
    aux = cfg.router_aux_loss * e * torch.sum(load * importance)
    aux = aux + 1e-4 * torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    flat_ids = ids.reshape(g, sl * k)                                      # slot-major
    gates_flat = gates.reshape(g, sl * k).to(x.dtype)
    order = torch.argsort(flat_ids, dim=1, stable=True)
    inv_order = torch.argsort(order, dim=1)
    sorted_ids = torch.gather(flat_ids, 1, order)
    src = torch.repeat_interleave(x, k, dim=1)                             # (G, S*k, d)
    sorted_src = torch.gather(src, 1, order[..., None].expand(g, sl * k, d))

    # expert run boundaries within each group
    erange = torch.arange(e, device=x.device, dtype=sorted_ids.dtype).expand(g, e).contiguous()
    start = torch.searchsorted(sorted_ids, erange, right=False)
    end = torch.searchsorted(sorted_ids, erange, right=True)
    counts = end - start                                                   # (G, E)
    dropped = torch.clamp(counts - cap, min=0).sum().to(torch.int32)
    return dict(gates_flat=gates_flat, order=order, inv_order=inv_order, sorted_ids=sorted_ids,
                sorted_src=sorted_src, start=start, counts=counts, aux=aux, dropped=dropped, ids=ids)


def _fill_buffer(r: Dict[str, torch.Tensor], cap: int) -> torch.Tensor:
    """Gather each expert's first C tokens into the (G, E, C, d) buffer."""
    sorted_src, start, counts = r["sorted_src"], r["start"], r["counts"]
    g, sk, d = sorted_src.shape
    e = counts.shape[1]
    c_iota = torch.arange(cap, device=start.device, dtype=start.dtype)
    gidx = start[:, :, None] + c_iota[None, None, :]                       # (G, E, C)
    valid = c_iota[None, None, :] < torch.clamp(counts, max=cap)[:, :, None]
    gidx = torch.clamp(gidx, 0, sk - 1).reshape(g, e * cap)
    buf = torch.gather(sorted_src, 1, gidx[..., None].expand(g, e * cap, d)).reshape(g, e, cap, d)
    return buf * valid[..., None].to(sorted_src.dtype)


def _combine(y: torch.Tensor, r: Dict[str, torch.Tensor], cap: int, k: int) -> torch.Tensor:
    """Gather expert outputs back per sorted slot, unsort, gate, sum k."""
    g, e, _, d = y.shape
    sorted_ids = r["sorted_ids"]
    sk = sorted_ids.shape[1]
    j_iota = torch.arange(sk, device=y.device, dtype=sorted_ids.dtype)[None, :]
    pos_sorted = j_iota - torch.gather(r["start"], 1, sorted_ids)
    keep_sorted = pos_sorted < cap
    slot = sorted_ids * cap + torch.where(keep_sorted, pos_sorted, 0)
    out_sorted = torch.gather(y.reshape(g, e * cap, d), 1, slot[..., None].expand(g, sk, d))
    out_sorted = out_sorted * keep_sorted[..., None].to(y.dtype)
    out = torch.gather(out_sorted, 1, r["inv_order"][..., None].expand(g, sk, d))
    return (out * r["gates_flat"][..., None]).reshape(g, sk // k, k, d).sum(dim=2)


def _shared_params(p: Dict) -> Optional[Dict]:
    return {"w_gate": p["shared_w_gate"], "w_up": p["shared_w_up"],
            "w_down": p["shared_w_down"]} if "shared_w_gate" in p else None


def _moe_ffn_ep(x, p, cfg, plan):
    """The expert-parallel layer (one all-to-all dispatch and one combine
    per layer) is not ported."""
    raise NotImplementedError(f"expert parallelism (dip_ep) and sharding plans are not ported yet ({_DISTRIBUTED})")


def moe_ffn(x: torch.Tensor, p: Dict, cfg, *, plan=None, return_routing: bool = False,
            route_ids: Optional[torch.Tensor] = None,
            on_route: Optional[Callable[[torch.Tensor], None]] = None) -> Tuple[torch.Tensor, ...]:
    """Routed expert FFN on x (B, S, d).  Returns ``(out, aux, dropped)``:
    ``aux`` the load-balance + z-loss (f32 scalar), ``dropped`` the number
    of (token, slot) pairs past capacity in this layer (int32 scalar).
    ``return_routing=True`` appends the (B, S, k) expert ids, so that two
    runs can be checked to route alike; ``route_ids`` replays such ids in
    place of this run's top-k (the rest of the layer unchanged), so that two
    runs can be compared with their discrete choices held equal;
    ``on_route`` is called with the ids as soon as they are chosen (a
    rerun under ``torch.utils.checkpoint`` may stop before the layer
    returns).  A sharding ``plan`` raises: the expert-parallel path is not
    ported.

    Gradients reach x, the router and the banks through the gates (the
    top-k probabilities, renormalized), the aux loss and the gathers; the
    ids, the sort, the capacity mask and the counts carry none, as
    ``jax.lax.top_k`` and the argsort carry none in the reference."""
    if plan is not None:
        return _moe_ffn_ep(x, p, cfg, plan)
    b, s, d = x.shape
    cd = x.dtype
    cap = moe_capacity(s, cfg)                                             # per-group capacity

    r = _route(x, p["router"], cfg, cap, route_ids)
    if on_route is not None:
        on_route(r["ids"])
    buf = _fill_buffer(r, cap)

    # batched per-expert SwiGLU: weights (E, d, ffe) / (E, ffe, d)
    gate_h = torch.einsum("becd,edf->becf", buf, p["w_gate"].to(cd))
    up_h = torch.einsum("becd,edf->becf", buf, p["w_up"].to(cd))
    h = layers.swiglu(gate_h, up_h)
    y = torch.einsum("becf,efd->becd", h, p["w_down"].to(cd))             # (B, E, C, d)

    out = _combine(y, r, cap, cfg.moe_top_k)

    # shared experts (DeepSeek-style), computed densely for every token
    shared = _shared_params(p)
    if cfg.n_shared_experts and shared is not None:
        out = out + dense_ffn(x, shared, cfg)
    res = (out, r["aux"], r["dropped"])
    return res + (r["ids"],) if return_routing else res
