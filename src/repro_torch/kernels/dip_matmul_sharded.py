"""The explicit multi-rank DiP matmul backends (port of
``repro/kernels/dip_matmul_sharded.py``): ``dip_tp``, ``dip_fsdp`` and
``dip_sp`` over the existing per-shard kernels, every collective placed by
hand.

The reference writes each as a ``shard_map`` body over global arrays; the
port runs that body as it stands on every rank (one process per rank,
Megatron-style local view), on the rank's shard of the weight
(``distributed.shard_weight``) and the collectives of
``distributed.comm``.  The per-shard product is ``dip_matmul`` (float DiP
storage) or ``dip_matmul_q`` (quantized storage) at the shard's shape.

What each rank passes and gets (``x`` / the output flattened to rows):

    dip_tp column  x whole (M, d_in); out (M, this rank's columns of
                   d_out).  One fused launch per shard (prologue, epilogue,
                   the bias's and residual's columns of the shard); zero
                   collectives.
    dip_tp row     x this rank's K slice (M, its columns of d_in); out the
                   whole (M, d_out).  The prologue decomposes first (one
                   psum of the rows' sums of squares: no rank sees a whole
                   row); one launch per weight with no epilogue, storing f32
                   sums for bf16 x (the bf16 mainloops' f32 store) or int32
                   for int8 x; ONE psum even for the swiglu pair (stacked);
                   the epilogue once, on the reduced value; one cast.
    dip_fsdp       x this rank's rows; out the same rows.  One all_gather
                   per weight at storage width (int8 / fp8 stay one byte),
                   one fused launch, zero psums.
    dip_sp column  x this rank's m rows (the same m on every rank); out all
                   T m rows, this rank's columns.  T launches and T - 1 ring
                   hops, each hop issued before the launch it overlaps; no
                   all_gather.
    dip_sp row     x (T m' rows, this rank's K slice); out this rank's
                   block of the rows (M padded to a multiple of T), whole
                   d_out.  One reduce_scatter per weight; the epilogue on
                   the local rows.

Operands: the bias is always the whole (d_out,) row; the residual has the
output's rows on this rank and all d_out columns (the backend takes the
shard's columns); the rmsnorm gain is the whole (d_in,) row.  Each
per-shard product dispatch is logged (``comm.note_launch``) beside the
collectives, so ``comm.counts()`` / ``comm.schedule()`` give the
reference's ``count_collectives`` / ``collective_schedule`` contract.
Gradients: every collective here is differentiable (``distributed.comm``:
each one's backward is its transpose), every fused per-shard launch goes
through the registry's ``FusedDispatch`` (``api.matmul``), and so does each
row partial (:func:`_partial`: the kernel's f32 store forward, the f32
recompute backward), so the backward of each path is the chain of those:
``dip_tp`` column the shard's f32 recompute; ``dip_tp`` row the psum's
transpose, the partials' recompute and the prologue's psum of sums of
squares; ``dip_fsdp`` the gathered storage's gradient reduce-scattered back
to the rank's K shard; ``dip_sp`` the ring's hops the other way round
(``comm.hop_grad``) and the reduce-scatter's all-gather.  The padding of a
shard's storage takes an exactly zero gradient (zero x columns, cropped
output columns).  Quantized storage takes none (``_require_trainable``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.kernels import epilogue as epilogue_lib
from repro_torch.kernels import prologue as prologue_lib
from repro_torch.kernels.dip_matmul import dip_matmul
from repro_torch.kernels.dip_matmul_q import dip_matmul_q

__all__ = ["dip_tp_matmul", "dip_fsdp_matmul", "dip_sp_matmul", "local_width"]


def _pad_last(a: torch.Tensor, width: int) -> torch.Tensor:
    pad = width - a.shape[-1]
    return F.pad(a, (0, pad)) if pad else a


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    pad = rows - a.shape[0]
    return F.pad(a, (0, 0, 0, pad)) if pad else a


def local_width(total: int, index: int, part: int) -> int:
    """The logical columns of shard ``index`` (``part`` storage columns
    each) of a dim of ``total``: the last shards hold the padding."""
    return max(0, min(part, total - index * part))


def _quantized(w) -> bool:
    from repro_torch.api.quant import QuantizedDipWeight

    return isinstance(w, QuantizedDipWeight)


def _local_weight(w, data, scale, d_in: int, d_out: int):
    """A plan-free weight around local payloads (so the inner dispatch
    cannot come back here)."""
    from repro_torch import api

    if _quantized(w):
        return api.QuantizedDipWeight(data, scale, d_in, d_out, w.perm_tile, w.scheme)
    return api.DipWeight(data, d_in, d_out, w.perm_tile)


def _inner_backend(w) -> Optional[str]:
    """The per-shard launch: the DiP kernel for float storage, the scheme's
    kernel (``backend=None``) for quantized storage."""
    return None if _quantized(w) else "dip"


def _validate(weights, plan, backend: str) -> None:
    if any(type(w) is not type(weights[0]) for w in weights):
        raise ValueError(f"{backend}: weight pair must share a type")
    if any(getattr(w, "plan", None) != plan for w in weights):
        raise ValueError(f"{backend}: weight pair must share one WeightPlan, got "
                         f"{[getattr(w, 'plan', None) for w in weights]}")
    if plan is None or plan.mesh is None:
        raise ValueError(f"{backend} needs a WeightPlan with a mesh on the weight (ShardingPlan.shard_params); "
                         "plan-free weights decompose to the single-device path through api.matmul")
    if weights[0].data.dim() != 2:
        raise ValueError(f"sharded matmul weight must be 2-D (got storage {tuple(weights[0].data.shape)}); "
                         "index the stacked axis first")


def _storage(w) -> Tuple[int, int]:
    from repro_torch.api.weights import DipWeight

    return DipWeight.storage_dims(w.d_in, w.d_out, w.perm_tile)


def _check_shard(w, want: Tuple[int, int], backend: str, what: str) -> None:
    if tuple(w.data.shape) != tuple(want):
        raise ValueError(f"{backend} {what}: storage {tuple(w.data.shape)} is not this plan's shard {want} of "
                         f"the ({w.d_in}, {w.d_out}) weight (distributed.shard_weight)")


def _payloads(weights):
    return tuple(w.data for w in weights), tuple(w.scale if _quantized(w) else None for w in weights)


def _resolve_prologue(prologue, pro_operands, eps, x, d_in: int, kp: int):
    """Fuse the prologue into the per-shard launch where the shard holds
    whole, unpadded rows (``d_in == Kp``); else normalize once here, the
    same arithmetic unfused.  Returns (x, fuse)."""
    if prologue == "none":
        return x, False
    if d_in == kp:
        return x, True
    return prologue_lib.apply(prologue, x, pro_operands[0].reshape(-1), eps=eps), False


def _row_prologue(prologue, pro_operands, eps, x2, d_in: int, k0: int, mesh, axis):
    """The rmsnorm of a K-sliced x: each rank's sum of squares, one psum for
    the whole rows', then its own columns scaled by the same f32 arithmetic
    as ``prologue.apply`` and cast back once."""
    if prologue == "none":
        return x2
    x32 = x2.float()
    ssq = comm.psum(torch.sum(x32 * x32, dim=-1, keepdim=True), mesh, axis)
    inv = torch.rsqrt(ssq / d_in + eps)
    g = pro_operands[0].reshape(-1)
    g = _pad_last(g, max(g.shape[0], k0 + x2.shape[1]))[k0:k0 + x2.shape[1]]
    return prologue_lib.kernel_load(prologue, x2, (inv, g))


def _column_operands(spec, operands, d_out: int, np_: int, c0: int, n_loc: int, rows=None):
    """The shard's columns of the bias row or of the residual (whose rows are
    ``rows`` of the whole residual, when given)."""
    if spec.bias:
        return (_pad_last(operands[0].reshape(-1), np_)[c0:c0 + n_loc],)
    if spec.residual:
        r = operands[0].reshape(-1, d_out)
        if rows is not None:
            r = r[rows]
        return (_pad_last(r, np_)[:, c0:c0 + n_loc].contiguous(),)
    return ()


def _fused_launch(x2, wl, spec, epilogue, eops, prologue, pops, eps):
    """ONE per-shard dispatch of the fused kernel (prologue and epilogue
    included), logged as a launch."""
    from repro_torch import api

    comm.note_launch()
    w = wl if spec.dual_weight else wl[0]
    return api.matmul(x2, w, backend=_inner_backend(wl[0]), epilogue=epilogue if epilogue != "none" else None,
                      epilogue_operands=eops, prologue=prologue if pops else None, prologue_operands=pops,
                      prologue_eps=eps)


def _f32_store(x2, p, **_):
    """The row partial's launch (no prologue, no epilogue): bf16 x stores
    its f32 sums unrounded."""
    return dip_matmul(x2, p, out_dtype=torch.float32 if x2.dtype == torch.bfloat16 else None)


def _partial(x2, w, data, scale) -> torch.Tensor:
    """One row-parallel partial product, no epilogue, logged as a launch: f32
    sums for float x (bf16 x stores them unrounded), int32 for int8 x.
    Float storage goes through the registry's ``FusedDispatch``: the kernel
    forward with grad off, the f32 recompute backward."""
    from repro_torch.api.registry import FusedDispatch

    comm.note_launch()
    if _quantized(w):
        f32 = torch.float32 if x2.dtype == torch.bfloat16 else None
        return dip_matmul_q(x2, data, scale, out_dtype=f32)
    return FusedDispatch.apply(_f32_store, "dip", ("none", "none", x2.shape[1], prologue_lib.DEFAULT_EPS), 1, 0,
                               x2, data)


def _epilogue_after(spec, epilogue, zs, eops, x_dtype, partial_dtype):
    """The epilogue on the reduced value(s) and the one cast: x's dtype for
    float x (and for the int32 sums of int8 x with no epilogue), else f32."""
    floating = x_dtype.is_floating_point
    if epilogue == "none":
        return zs[0].to(x_dtype if floating else partial_dtype)
    aux = (zs[1],) if spec.dual_weight else tuple(e.float() for e in eops)
    return epilogue_lib.apply(epilogue, zs[0], *aux).to(x_dtype if floating else torch.float32)


def _row_partials(x2, weights, datas, scales, mesh, axis, reduce, epilogue):
    """The per-weight partials and their reduction: ``comm.psum`` (ONE call,
    the swiglu pair stacked) or ``comm.psum_scatter`` (one per weight).
    int32 partials reduce exactly with no epilogue, as f32 with one."""
    parts = [_partial(x2, w, d, s) for w, d, s in zip(weights, datas, scales)]
    if epilogue != "none":
        parts = [p.float() for p in parts]
    if reduce is comm.psum_scatter:
        return [reduce(p, mesh, axis) for p in parts]
    if len(parts) == 1:
        return [reduce(parts[0], mesh, axis)]
    return list(reduce(torch.stack(parts), mesh, axis).unbind(0))


# --------------------------------------------------------------------------
def dip_tp_matmul(x: torch.Tensor, weights: Sequence, operands: Sequence[torch.Tensor], *, plan,
                  epilogue: str = "none", prologue: str = "none",
                  prologue_operands: Sequence[torch.Tensor] = (),
                  prologue_eps: float = prologue_lib.DEFAULT_EPS) -> torch.Tensor:
    """Tensor-parallel ``epilogue(prologue(x) @ w)`` on this rank's shard,
    column or row by the plan's kind (module doc)."""
    _validate(weights, plan, "dip_tp")
    if plan.kind not in ("column", "row"):
        raise ValueError(f"dip_tp consumes column/row WeightPlans, got kind={plan.kind!r}")
    mesh, ax = plan.mesh, plan.axis
    tp, me = mesh.shape[ax], mesh.coord(ax)
    w0 = weights[0]
    kp, np_ = _storage(w0)
    spec = epilogue_lib.spec(epilogue)
    datas, scales = _payloads(weights)
    lead = tuple(x.shape[:-1])

    if plan.kind == "column":
        _check_shard(w0, (kp, np_ // tp), "dip_tp", "column")
        if x.shape[-1] != w0.d_in:
            raise ValueError(f"x contraction {x.shape[-1]} does not match d_in={w0.d_in}")
        n_loc = np_ // tp
        x, fuse = _resolve_prologue(prologue, prologue_operands, prologue_eps, x, w0.d_in, kp)
        pops = (prologue_operands[0].reshape(-1),) if fuse else ()
        x2 = _pad_last(x.reshape(-1, x.shape[-1]), kp)
        wl = tuple(_local_weight(w, d, s, kp, n_loc) for w, d, s in zip(weights, datas, scales))
        eops = _column_operands(spec, operands, w0.d_out, np_, me * n_loc, n_loc)
        out = _fused_launch(x2, wl, spec, epilogue, eops, prologue, pops, prologue_eps)
        n_log = local_width(w0.d_out, me, n_loc)
        return out[:, :n_log].reshape(lead + (n_log,))

    # ---- row: K sliced, ONE psum, the epilogue after it ----
    k_loc = kp // tp
    _check_shard(w0, (k_loc, np_), "dip_tp", "row")
    k_log = local_width(w0.d_in, me, k_loc)
    if x.shape[-1] != k_log:
        raise ValueError(f"dip_tp row: x holds {x.shape[-1]} columns, this rank's K slice of d_in={w0.d_in} "
                         f"is {k_log}")
    x2 = _pad_last(x.reshape(-1, k_log), k_loc)
    x2 = _row_prologue(prologue, prologue_operands, prologue_eps, x2, w0.d_in, me * k_loc, mesh, ax).contiguous()
    zs = _row_partials(x2, weights, datas, scales, mesh, ax, comm.psum, epilogue)
    eops = ()
    if spec.bias:
        eops = (_pad_last(operands[0].reshape(1, -1), np_),)
    elif spec.residual:
        eops = (_pad_last(operands[0].reshape(-1, w0.d_out), np_),)
    out = _epilogue_after(spec, epilogue, zs, eops, x.dtype, zs[0].dtype)
    return out[:, :w0.d_out].reshape(lead + (w0.d_out,))


def dip_fsdp_matmul(x: torch.Tensor, weights: Sequence, operands: Sequence[torch.Tensor], *, plan,
                    epilogue: str = "none", prologue: str = "none",
                    prologue_operands: Sequence[torch.Tensor] = (),
                    prologue_eps: float = prologue_lib.DEFAULT_EPS) -> torch.Tensor:
    """ZeRO-3 ``epilogue(prologue(x) @ w)``: this rank's rows of x, the
    weight gathered whole from its K shards (one all_gather per weight at
    storage width), one fused launch."""
    _validate(weights, plan, "dip_fsdp")
    if plan.fsdp is None:
        raise ValueError("dip_fsdp needs a WeightPlan with an fsdp axis (a mesh with a 'data' axis)")
    mesh, ax = plan.mesh, plan.fsdp
    n_sh = mesh.shape[ax]
    w0 = weights[0]
    kp, np_ = _storage(w0)
    if kp % n_sh:
        raise ValueError(f"dip_fsdp: storage K={kp} must divide the fsdp axis {ax!r}={n_sh}")
    _check_shard(w0, (kp // n_sh, np_), "dip_fsdp", "K shard")
    if x.shape[-1] != w0.d_in:
        raise ValueError(f"x contraction {x.shape[-1]} does not match d_in={w0.d_in}")
    spec = epilogue_lib.spec(epilogue)
    lead = tuple(x.shape[:-1])
    x, fuse = _resolve_prologue(prologue, prologue_operands, prologue_eps, x, w0.d_in, kp)
    pops = (prologue_operands[0].reshape(-1),) if fuse else ()
    x2 = _pad_last(x.reshape(-1, x.shape[-1]), kp)
    datas, scales = _payloads(weights)
    full = tuple(comm.all_gather(d, mesh, ax, dim=0) for d in datas)
    wl = tuple(_local_weight(w, d, s, kp, w0.d_out) for w, d, s in zip(weights, full, scales))
    eops = ()
    if spec.bias:
        eops = (operands[0].reshape(-1),)
    elif spec.residual:
        eops = (operands[0].reshape(-1, w0.d_out),)
    out = _fused_launch(x2, wl, spec, epilogue, eops, prologue, pops, prologue_eps)
    return out.reshape(lead + (w0.d_out,))


def dip_sp_matmul(x: torch.Tensor, weights: Sequence, operands: Sequence[torch.Tensor], *, plan,
                  epilogue: str = "none", prologue: str = "none",
                  prologue_operands: Sequence[torch.Tensor] = (),
                  prologue_eps: float = prologue_lib.DEFAULT_EPS) -> torch.Tensor:
    """Sequence-parallel ``epilogue(prologue(x) @ w)`` (module doc): the
    column path rings the rows through the launches, the row path ends in a
    reduce_scatter.  Returns 2-D rows."""
    _validate(weights, plan, "dip_sp")
    if plan.kind not in ("column", "row"):
        raise ValueError(f"dip_sp consumes column/row WeightPlans, got kind={plan.kind!r}")
    mesh, ax = plan.mesh, plan.axis
    tp, me = mesh.shape[ax], mesh.coord(ax)
    w0 = weights[0]
    kp, np_ = _storage(w0)
    spec = epilogue_lib.spec(epilogue)
    datas, scales = _payloads(weights)

    if plan.kind == "column":
        _check_shard(w0, (kp, np_ // tp), "dip_sp", "column")
        if x.shape[-1] != w0.d_in:
            raise ValueError(f"x contraction {x.shape[-1]} does not match d_in={w0.d_in}")
        n_loc = np_ // tp
        x, fuse = _resolve_prologue(prologue, prologue_operands, prologue_eps, x, w0.d_in, kp)
        pops = (prologue_operands[0].reshape(-1),) if fuse else ()
        cur = _pad_last(x.reshape(-1, x.shape[-1]), kp).contiguous()
        m_loc = cur.shape[0]
        wl = tuple(_local_weight(w, d, s, kp, n_loc) for w, d, s in zip(weights, datas, scales))
        blocks = [None] * tp
        for s in range(tp):
            # the forward of the held block to the next rank goes first: the
            # launch below overlaps it
            hop = comm.ppermute_start(cur, mesh, ax) if s < tp - 1 else None
            src = (me - s) % tp
            rows = slice(src * m_loc, (src + 1) * m_loc)
            eops = _column_operands(spec, operands, w0.d_out, np_, me * n_loc, n_loc,
                                    rows=rows if spec.residual else None)
            blocks[src] = _fused_launch(cur, wl, spec, epilogue, eops, prologue, pops, prologue_eps)
            cur = comm.hop_grad(cur, hop.wait(), mesh, ax) if hop is not None else None
        return torch.cat(blocks, dim=0)[:, :local_width(w0.d_out, me, n_loc)]

    # ---- row: K sliced, one reduce_scatter per weight, rows this rank's ----
    k_loc = kp // tp
    _check_shard(w0, (k_loc, np_), "dip_sp", "row")
    k_log = local_width(w0.d_in, me, k_loc)
    if x.shape[-1] != k_log:
        raise ValueError(f"dip_sp row: x holds {x.shape[-1]} columns, this rank's K slice of d_in={w0.d_in} "
                         f"is {k_log}")
    x2 = x.reshape(-1, k_log)
    m = x2.shape[0]
    m_loc = -(-m // tp)
    x2 = _pad_rows(_pad_last(x2, k_loc), tp * m_loc)
    x2 = _row_prologue(prologue, prologue_operands, prologue_eps, x2, w0.d_in, me * k_loc, mesh, ax).contiguous()
    zs = _row_partials(x2, weights, datas, scales, mesh, ax, comm.psum_scatter, epilogue)
    eops = ()
    if spec.bias:
        eops = (_pad_last(operands[0].reshape(1, -1), np_),)
    elif spec.residual:
        eops = (_pad_rows(_pad_last(operands[0].reshape(-1, w0.d_out), np_), m_loc),)
    out = _epilogue_after(spec, epilogue, zs, eops, x.dtype, zs[0].dtype)
    return out[:max(0, min(m_loc, m - me * m_loc)), :w0.d_out]
