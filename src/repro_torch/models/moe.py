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
so through the DiP kernel.

Under a ``ShardingPlan`` (``plan=``; one process per rank, local view) every
rank enters the layer holding every token (the attention's row all-reduce
gave them all) and its slice of the banks, E / T consecutive experts
(``plan.experts_local``):

* **Expert parallel** (``plan.expert_plan`` set: strategy ``ep``; the port
  of the reference's ``_moe_ffn_ep`` shard_map body).  The rank takes its
  own tokens: by batch when B divides the axis (the groups stay the
  single-rank ones), else by sequence (groups of S / T tokens, each at its
  own ``moe_capacity``).  It routes them, issues the dispatch
  ``all_to_all`` (experts split over the axis, the ranks' tokens
  concatenated) BEFORE the shared-expert launches it overlaps, runs the
  shared experts plan-free on its tokens, its experts over every rank's
  tokens, the combine ``all_to_all``, ONE psum of the routing stats (drops
  summed; aux the single-rank layer's under the batch split, the ranks'
  mean under the sequence split) and ONE ``all_gather`` of the
  tokens back (in the reference GSPMD's implicit reshard of the
  shard_map's output).  Each rank holds the shared experts whole (their
  storage keeps its column / row plan, unused: ``ShardingPlan.shard_leaf``),
  so that no call gathers them.  ``return_routing`` and ``on_route`` give
  the rank's own tokens' expert ids; ``route_ids`` is the whole (B, S, k)
  replay, of which the rank takes its tokens' part.
* **Expert-split dense style** (strategy ``tp``, and the ``ep`` fallback
  when neither B nor S divides the axis).  Every rank routes every token
  exactly as the single-rank path does, fills only its experts' part of the
  buffer and combines only their outputs; ONE psum (in f32) adds the ranks'
  partial outputs, which equals the single-rank layer with its capacity and
  drops.  The shared experts follow their plans under ``tp`` (column gate
  and up, row down with its all-reduce, or replicated where their width
  does not split) and run plan-free under ``ep``.

Each plan-free shared-expert launch is logged (``comm.note_launch``), so
``comm.schedule()`` shows the dispatch before them.

* **ZeRO-3** (strategy ``fsdp``, a (data = T, model = 1) mesh; the port of
  the reference's ``expert_bank`` / ``router`` specs under ``fsdp``).  The
  rank holds its block of each bank's contraction dim (d of the gate / up
  banks, ffe of the down bank) and of the router's d
  (``ShardingPlan.shard_leaf``), and enters the layer with its rows
  (``transformer._row_split``: a decode step's slots split over the axis,
  a batch-1 prefill whole on every rank).  It all-gathers the router and
  each bank (one all-gather a leaf), routes its rows exactly as the
  single-rank layer routes them (routing is per sequence and the rows
  split by whole sequences, so each group's capacity and drops are the
  single-rank layer's), runs every expert, and runs the shared experts
  through ``dense_ffn`` on ``dip_fsdp`` (one all-gather of storage a
  weight).  ``aux``, ``dropped`` and the ids are the rank's rows' (no
  collective sums them: the ranks' drops add up to the single-rank
  layer's), except in training (x differentiated), where one psum of the
  routing sums makes ``aux`` the whole batch's, as the loss needs it.

In training every collective above is differentiable (``distributed.comm``)
and the router, the banks and the shared experts take their gradients
through them; under ``ep``'s batch split ``aux`` is the single-rank layer's
(the sums behind its means psummed), so the loss is too.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed import comm
from repro_torch.kernels.dip_matmul_sharded import _inner_backend
from repro_torch.models import layers

__all__ = ["dense_ffn", "moe_capacity", "moe_ffn"]


def dense_ffn(x: torch.Tensor, p: Dict, cfg, *, residual: Optional[torch.Tensor] = None,
              norm: Optional[torch.Tensor] = None, backend: Optional[str] = None) -> torch.Tensor:
    """SwiGLU MLP: the gate and up projections run as ONE dual-weight
    ``swiglu`` dispatch (one kernel launch on the ``dip`` backend), then the
    down projection with the block's skip connection fused as the
    ``residual`` epilogue.  ``norm`` is the pre-FFN RMSNorm gain when the
    backend fuses prologues (x then arrives un-normalized).  ``backend``
    overrides ``cfg.matmul_backend`` (the expert-parallel layer runs the
    shared experts on the single-device kernel)."""
    lk = dict(backend=backend or cfg.matmul_backend, compute_dtype=x.dtype)
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
    z = torch.square(torch.logsumexp(logits, dim=-1))
    aux = aux + 1e-4 * torch.mean(z)
    # the sums behind aux's means (and the token count), so that ranks
    # holding different tokens can add theirs and take the aux of them all
    stats = torch.cat([top1.float().sum((0, 1)), probs.sum((0, 1)), z.sum()[None], torch.ones_like(z).sum()[None]])

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
                sorted_src=sorted_src, start=start, counts=counts, aux=aux, dropped=dropped, ids=ids, stats=stats)


def _aux_of(cfg, stats: torch.Tensor) -> torch.Tensor:
    """The aux loss of :func:`_route`'s ``stats`` (summed over ranks): the
    Switch load-balance term of the tokens' mean load and importance, and
    the z-loss's mean, over every token the sums hold."""
    e = cfg.n_experts
    n = stats[2 * e + 1]
    load, importance = stats[:e] / n, stats[e:2 * e] / n
    return (cfg.router_aux_loss * e * torch.sum(load * importance) + 1e-4 * (stats[2 * e] / n)).float()


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


def _combine(y: torch.Tensor, r: Dict[str, torch.Tensor], cap: int, k: int, e0: int = 0) -> torch.Tensor:
    """Gather expert outputs back per sorted slot, unsort, gate, sum k.
    ``y`` may hold only experts ``e0 .. e0 + y.shape[1] - 1``: the slots of
    the others then contribute zeros (a rank's partial output)."""
    g, e_loc, _, d = y.shape
    sorted_ids = r["sorted_ids"]
    sk = sorted_ids.shape[1]
    j_iota = torch.arange(sk, device=y.device, dtype=sorted_ids.dtype)[None, :]
    pos_sorted = j_iota - torch.gather(r["start"], 1, sorted_ids)
    keep_sorted = pos_sorted < cap
    local = sorted_ids
    if e_loc != r["counts"].shape[1]:
        local = sorted_ids - e0
        keep_sorted = keep_sorted & (local >= 0) & (local < e_loc)
        local = local.clamp(0, e_loc - 1)
    slot = local * cap + torch.where(keep_sorted, pos_sorted, 0)
    out_sorted = torch.gather(y.reshape(g, e_loc * cap, d), 1, slot[..., None].expand(g, sk, d))
    out_sorted = out_sorted * keep_sorted[..., None].to(y.dtype)
    out = torch.gather(out_sorted, 1, r["inv_order"][..., None].expand(g, sk, d))
    return (out * r["gates_flat"][..., None]).reshape(g, sk // k, k, d).sum(dim=2)


def _run_banks(buf: torch.Tensor, p: Dict, cd) -> torch.Tensor:
    """The batched per-expert SwiGLU of a (G, E', C, d) buffer through the
    banks (E', d, ffe) / (E', ffe, d) that ``p`` holds."""
    gate_h = torch.einsum("becd,edf->becf", buf, p["w_gate"].to(cd))
    up_h = torch.einsum("becd,edf->becf", buf, p["w_up"].to(cd))
    return torch.einsum("becf,efd->becd", layers.swiglu(gate_h, up_h), p["w_down"].to(cd))


def _shared_params(p: Dict) -> Optional[Dict]:
    return {"w_gate": p["shared_w_gate"], "w_up": p["shared_w_up"],
            "w_down": p["shared_w_down"]} if "shared_w_gate" in p else None


def _plan_free_ffn(x: torch.Tensor, shared: Dict, cfg) -> torch.Tensor:
    """The shared experts, whole on this rank, on its tokens, rebuilt
    plan-free (the reference's ``_ep_payload`` / ``_local_weight``): the
    single-device kernel's gate+up launch and down launch, logged."""
    sw = {n: w.with_plan(None) for n, w in shared.items()}
    comm.note_launch()
    comm.note_launch()
    return dense_ffn(x, sw, cfg, backend=_inner_backend(sw["w_gate"]))


def _experts(x, p, cfg, route_ids, on_route, e0=0, n=None):
    """The dense-style layer's routed part: every token routed at
    ``moe_capacity(S)``, experts ``e0 .. e0 + n - 1`` (all by default) run
    on their part of the buffer and combined (the others' slots give
    zeros).  Returns ``(out, routing state)``."""
    cap = moe_capacity(x.shape[1], cfg)                                    # per-group capacity
    r = _route(x, p["router"], cfg, cap, route_ids)
    if on_route is not None:
        on_route(r["ids"])
    n = cfg.n_experts if n is None else n
    y = _run_banks(_fill_buffer(r, cap)[:, e0:e0 + n], p, x.dtype)         # (B, n, C, d)
    return _combine(y, r, cap, cfg.moe_top_k, e0), r


def _moe_ffn_ep(x, p, cfg, plan, dim, route_ids, on_route):
    """The expert-parallel layer on this rank (module doc): its tokens
    along ``dim``, two all-to-alls, one psum, one all-gather."""
    mesh, ax = plan.mesh, plan.tp
    t, me = plan.tp_size, plan.tp_rank
    e, k = cfg.n_experts, cfg.moe_top_k
    d, cd = x.shape[-1], x.dtype
    if p["w_gate"].shape[0] != e // t:
        raise ValueError(f"expert parallelism over {ax}={t} needs E/T = {e // t} experts a rank, the banks hold "
                         f"{p['w_gate'].shape[0]} (ShardingPlan.shard_params)")
    n = x.shape[dim] // t
    xl = x.narrow(dim, me * n, n)
    ids = None if route_ids is None else route_ids.narrow(dim, me * n, n)
    g = xl.shape[0]
    cap = moe_capacity(xl.shape[1], cfg)
    r = _route(xl, p["router"], cfg, cap, ids)
    if on_route is not None:
        on_route(r["ids"])
    buf = _fill_buffer(r, cap)                                             # (G, E, C, d)
    # experts split over the axis, the ranks' tokens concatenated: this rank
    # receives every token routed to its E / T experts; issued before the
    # shared experts' launches, which it overlaps
    disp = comm.all_to_all(buf.transpose(0, 1).reshape(e, g * cap, d), mesh, ax, split_dim=0, concat_dim=1)
    shared = _shared_params(p)
    shared_out = _plan_free_ffn(xl, shared, cfg) if cfg.n_shared_experts and shared is not None else None
    y = _run_banks(disp[None], p, cd)[0]                                   # (E/T, T*G*C, d)
    comb = comm.all_to_all(y, mesh, ax, split_dim=1, concat_dim=0)          # (E, G*C, d)
    out = _combine(comb.reshape(e, g, cap, d).transpose(0, 1), r, cap, k)
    if shared_out is not None:
        out = out + shared_out
    # ONE psum for the stats: drops summed; under the batch split aux is the
    # single-rank layer's (the sums behind its means added, _aux_of), under
    # the sequence split the mean of the ranks' (each half routed alone)
    stats = comm.psum(torch.cat([r["stats"].double(), r["aux"].double()[None], r["dropped"].double()[None]]),
                      mesh, ax)
    aux = _aux_of(cfg, stats[:-2]) if dim == 0 else (stats[-2] / t).float()
    dropped = stats[-1].round().to(torch.int32)
    return comm.all_gather(out, mesh, ax, dim=dim), aux, dropped, r["ids"]


def _moe_ffn_split(x, p, cfg, plan, route_ids, on_route):
    """The expert-split dense-style layer on this rank (module doc)."""
    e0, n = plan.experts_local(cfg.n_experts)
    if p["w_gate"].shape[0] != n:
        raise ValueError(f"this rank's expert slice holds {n} experts, the banks {p['w_gate'].shape[0]} "
                         "(ShardingPlan.shard_params)")
    out, r = _experts(x, p, cfg, route_ids, on_route, e0, n)
    if n != cfg.n_experts:
        out = comm.psum(out.float(), plan.mesh, plan.tp).to(x.dtype)
    shared = _shared_params(p)
    if cfg.n_shared_experts and shared is not None:
        out = out + (_plan_free_ffn(x, shared, cfg) if plan.expert_plan is not None else dense_ffn(x, shared, cfg))
    return out, r["aux"], r["dropped"], r["ids"]


def _moe_ffn_fsdp(x, p, cfg, plan, route_ids, on_route):
    """The ZeRO-3 layer on this rank's rows (module doc): the router and
    the banks gathered whole, one all-gather a leaf that the plan cut."""
    full = dict(p)
    for name, dim in (("router", 0), ("w_gate", 1), ("w_up", 1), ("w_down", 1)):
        if p[name].shape[dim] != plan.fsdp_whole(name):
            full[name] = comm.all_gather(p[name], plan.mesh, plan.fsdp, dim=dim)
    out, r = _experts(x, full, cfg, route_ids, on_route)
    shared = _shared_params(p)
    if cfg.n_shared_experts and shared is not None:
        out = out + dense_ffn(x, shared, cfg)
    aux = r["aux"]
    if comm.differentiated(x):
        # training: the loss's aux is the whole batch's, as the single-rank
        # layer's (one psum of the routing sums; ranks running the same rows
        # add the same sums and counts alike)
        aux = _aux_of(cfg, comm.psum(r["stats"], plan.mesh, plan.fsdp))
    return out, aux, r["dropped"], r["ids"]


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
    returns).  Under a sharding ``plan`` this rank's part of the
    expert-parallel or expert-split layer (module doc); every rank returns
    the whole ``out``, ``aux`` and ``dropped``.  Under ``fsdp`` x is the
    rank's rows, and so are ``out``, ``aux``, ``dropped`` and the ids.

    Gradients reach x, the router and the banks through the gates (the
    top-k probabilities, renormalized), the aux loss and the gathers; the
    ids, the sort, the capacity mask and the counts carry none, as
    ``jax.lax.top_k`` and the argsort carry none in the reference."""
    if plan is not None:
        b, s, _ = x.shape
        t = plan.tp_size
        # the rank's tokens: by batch when B divides the axis, else by sequence
        dim = 0 if b % t == 0 else (1 if s % t == 0 else None)
        if plan.strategy == "fsdp":
            res = _moe_ffn_fsdp(x, p, cfg, plan, route_ids, on_route)
        elif plan.expert_plan is not None and t > 1 and cfg.n_experts % t == 0 and dim is not None:
            res = _moe_ffn_ep(x, p, cfg, plan, dim, route_ids, on_route)
        else:
            res = _moe_ffn_split(x, p, cfg, plan, route_ids, on_route)
        return res if return_routing else res[:3]
    out, r = _experts(x, p, cfg, route_ids, on_route)

    # shared experts (DeepSeek-style), computed densely for every token
    shared = _shared_params(p)
    if cfg.n_shared_experts and shared is not None:
        out = out + dense_ffn(x, shared, cfg)
    res = (out, r["aux"], r["dropped"])
    return res + (r["ids"],) if return_routing else res
