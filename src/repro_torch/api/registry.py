"""Matmul-backend registry and the one dispatching entry point (port of the
serving part of ``repro/api/registry.py``).

``matmul(x, w, backend=, epilogue=, epilogue_operands=, prologue=,
prologue_operands=, prologue_eps=)`` computes ``epilogue(prologue(x) @ W)``.
Backends declare the weight layout they consume and what they fuse:

    torch   plain ``torch.matmul`` on natural weights (the peer of ``xla``);
            fuses nothing, so ``matmul`` decomposes every prologue/epilogue
    ws      the CUDA kernel (``kernels/dip_matmul.py``) on natural storage,
            ``fuse_deshear=False`` (the peer of ``ws``)
    dip     the CUDA kernel on DiP-permutated storage (the peer of
            ``pallas_dip``): de-shear, rmsnorm prologue and the six
            epilogues fused in one launch
    systolic  the wavefront CUDA kernel (``kernels/dip_systolic.py``, the
            peer of ``pallas_systolic``): the dataflow-faithful validation
            path, same layout and fusions as ``dip``
    dip_int8w / dip_fp8   layout ``dip_q``: the quantized CUDA kernel
            (``kernels/dip_matmul_q.py``) on a ``QuantizedDipWeight`` of the
            backend's scheme (int8 W8A8-dynamic, fp8-e4m3 weight-only)

The reference's names ``xla``, ``pallas_dip`` and ``pallas_systolic``
resolve to ``torch``, ``dip`` and ``systolic``, so a configuration copied
from the reference selects the same path.

Quantized weights (port of the reference's weight-type-aware dispatch): a
``QuantizedDipWeight`` with ``backend=None`` goes to its scheme's backend;
a ``dip_q`` backend given a float weight quantizes it on the fly, and given
another scheme raises; any other backend receives the weight dequantized at
the activation dtype (how the ``torch`` backend serves a quantized model).
The quantized dispatch pads x's K to the storage and crops the output; the
storage is already padded to the 64-tile grid with padding columns at scale
1.0 (``quant.quantize``).

Tiled backends share one shim: x is flattened to (M, K) and its K padded to
the weight's 64-padded storage, the gain row and bias row are padded with
zeros, the residual is padded on N, and the output is cropped to the
logical width.  M is not padded: the kernel masks ragged rows itself.
Backends without a fusion get the decomposition rule: the prologue runs as
the same f32 normalize-and-cast ahead of the product, the epilogue as the
same f32 arithmetic after it, so results agree across backends.

Gradients (port of the reference's ``_build_tiled_caller`` custom VJP):
every tiled dispatch, ``dip`` and ``ws`` alike, goes through one
``torch.autograd.Function``, :class:`FusedDispatch`.  Its forward launches
the kernel (the plain version for CPU tensors); its backward un-permutes the
weight storage to natural f32, recomputes ``epilogue(prologue(x) @ W)`` in
f32 with torch autograd through :func:`fused_recompute`, and returns the x,
gain and bias/residual cotangents and the weight cotangent re-permuted with
``permute_tiled`` (the permutation is orthogonal, so
``d/dP f(unperm(P)) = perm(d/dW f(W))``) and cast to the storage dtype.
The ``torch`` backend keeps plain autograd.  The ``dip_q`` backends go
through :class:`QuantizedDispatch` (the reference's
``_build_quantized_caller``): its forward launches the quantized kernel, and
its backward is straight-through: the same f32 recompute against the
dequantized, de-sheared weight ``unpermute_tiled(q) * scale``, giving the x,
gain and bias/residual cotangents; the storage and its scales are frozen
calibration artifacts and take none (the reference's float0 and zeros).

Verification (port of the reference's ``verify=``): ``matmul(...,
verify=True | "auto" | "probe" | "storage")`` runs the same dispatch, so its
output is bit-identical to the unverified call's, then audits it with
``reliability.abft.verify_matmul`` against the weight's checksum, and
returns ``(out, report)``.  Every built-in backend computes an exact
product, so each declares ``abft=True``.

Sharded backends (port of the reference's ``"sharded"`` layout): ``dip_tp``,
``dip_fsdp``, ``dip_sp`` (``kernels/dip_matmul_sharded.py``) and ``dip_ep``
(the expert-parallel strategy's dense projections: ``dip_tp``'s placement;
the MoE layer's all-to-all dispatch lives in ``models/moe.py``) dispatch on
the ``WeightPlan`` the weight carries (``distributed.plan``), as ``fn(x,
weights, operands, plan=, epilogue=, prologue=, prologue_operands=,
prologue_eps=)`` on this rank's shard; they fuse every prologue and
epilogue (per shard or once past the reduction).  A weight with no plan, or
one whose split is absent (a replicated plan; no fsdp axis for
``dip_fsdp``), decomposes to the single-device path: the ``dip`` kernel for
a ``DipWeight``, its scheme's kernel for a ``QuantizedDipWeight``, the
default backend for a natural tensor.  Any other backend refuses a weight
that holds one rank's shard of its storage.  The block-size tuning table
is not ported yet (ROADMAP.md Queue 1 "Tooling"; the kernel's tile is fixed
at 64).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.api import quant
from repro_torch.api.quant import QuantizedDipWeight
from repro_torch.api.weights import PERM_TILE, DipWeight, as_dip_weight
from repro_torch.core import permute
from repro_torch.kernels import epilogue as epilogue_lib
from repro_torch.kernels import prologue as prologue_lib
from repro_torch.kernels.dip_matmul import dip_matmul
from repro_torch.kernels.dip_matmul_q import dip_matmul_q
from repro_torch.kernels.dip_systolic import dip_systolic
from repro_torch.kernels.dip_matmul_sharded import dip_fsdp_matmul, dip_sp_matmul, dip_tp_matmul

__all__ = [
    "MatmulBackend",
    "DEFAULT_BACKEND",
    "EPILOGUES",
    "PROLOGUES",
    "get_backend",
    "list_backends",
    "backend_layout",
    "matmul",
    "fused_recompute",
    "FusedDispatch",
    "QuantizedDispatch",
]

DEFAULT_BACKEND = "torch"
EPILOGUES = epilogue_lib.EPILOGUES
PROLOGUES = prologue_lib.PROLOGUES


@dataclasses.dataclass(frozen=True)
class MatmulBackend:
    """One registered matmul implementation.

    Tiled backends are called as ``fn(x2, w2, *weights_and_operands,
    epilogue=, prologue=, prologue_operands=, prologue_k=, prologue_eps=)``
    on 2-D operands already padded by the shim; non-tiled ones as
    ``fn(x, w_natural)`` and never fuse.  ``dip_q`` backends take the scale
    after the storage, ``fn(x2, q2, w_scale, *operands, ...)``, with
    ``(q_up, w_scale_up)`` as the operands of ``swiglu``, and consume the
    quantization ``scheme``.
    """

    name: str
    layout: str  # "natural" | "dip" | "dip_q" | "sharded"
    fn: Callable
    tiled: bool = True
    epilogues: FrozenSet[str] = frozenset({"none"})
    prologues: FrozenSet[str] = frozenset({"none"})
    description: str = ""
    scheme: Optional[str] = None
    # computes an exact product, so the row-sum probe of ``verify=`` holds
    abft: bool = True


def _torch_fn(x, wn):
    return torch.matmul(x, wn)


def _ws_fn(x2, w2, *eops, **kw):
    return dip_matmul(x2, w2, *eops, fuse_deshear=False, **kw)


def _dip_fn(x2, p2, *eops, **kw):
    return dip_matmul(x2, p2, *eops, fuse_deshear=True, **kw)


_ALL = frozenset(EPILOGUES)
_ALL_PRO = frozenset(PROLOGUES)
_REGISTRY: Dict[str, MatmulBackend] = {
    b.name: b for b in (
        MatmulBackend("torch", "natural", _torch_fn, tiled=False,
                      description="plain torch.matmul (de-shears a DipWeight first)"),
        MatmulBackend("ws", "natural", _ws_fn, epilogues=_ALL, prologues=_ALL_PRO,
                      description="CUDA tiled kernel on natural storage (baseline)"),
        MatmulBackend("dip", "dip", _dip_fn, epilogues=_ALL, prologues=_ALL_PRO,
                      description="CUDA kernel: de-shear in shared memory, fused prologue/epilogue"),
        MatmulBackend("systolic", "dip", dip_systolic, epilogues=_ALL, prologues=_ALL_PRO,
                      description="CUDA wavefront kernel on the CUDA cores (validation path)"),
        MatmulBackend("dip_int8w", "dip_q", dip_matmul_q, epilogues=_ALL, prologues=_ALL_PRO,
                      scheme="int8",
                      description="CUDA W8A8-dynamic kernel: per-row int8 x, per-column int8 "
                                  "weights, int32 accumulation, fused scale on output"),
        MatmulBackend("dip_fp8", "dip_q", dip_matmul_q, epilogues=_ALL, prologues=_ALL_PRO,
                      scheme="fp8_e4m3",
                      description="CUDA fp8-e4m3-weight kernel: bf16 compute on a card, f32 on "
                                  "the CPU, fused scale on output"),
        MatmulBackend("dip_tp", "sharded", dip_tp_matmul, tiled=False, epilogues=_ALL, prologues=_ALL_PRO,
                      description="tensor parallel: column shards with no collective, row shards with "
                                  "one all-reduce and the epilogue after it"),
        MatmulBackend("dip_fsdp", "sharded", dip_fsdp_matmul, tiled=False, epilogues=_ALL,
                      prologues=_ALL_PRO,
                      description="ZeRO-3: one all-gather of the K-sharded storage per weight, one "
                                  "launch on the local rows"),
        MatmulBackend("dip_sp", "sharded", dip_sp_matmul, tiled=False, epilogues=_ALL, prologues=_ALL_PRO,
                      description="sequence parallel: the rows ring through the column launches, "
                                  "row shards end in one reduce-scatter"),
        MatmulBackend("dip_ep", "sharded", dip_tp_matmul, tiled=False, epilogues=_ALL, prologues=_ALL_PRO,
                      description="expert parallel: dip_tp's placement for the dense projections; the MoE "
                                  "expert banks dispatch tokens over the model axis with paired all-to-alls"),
    )
}
# the reference's backend names, so its configurations resolve here
_ALIASES = {"xla": "torch", "pallas_dip": "dip", "pallas_systolic": "systolic"}
_DIST = 'ROADMAP.md Queue 1 "Distributed"'


def get_backend(name: Optional[str] = None) -> MatmulBackend:
    name = name or DEFAULT_BACKEND
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(f"unknown matmul backend {name!r}; registered: {sorted(_REGISTRY)}") from None


def list_backends() -> List[str]:
    return sorted(_REGISTRY)


def backend_layout(name: Optional[str] = None) -> str:
    """Weight layout the named backend consumes ("natural" | "dip" | "dip_q"
    | "sharded")."""
    return get_backend(name).layout


def _is_shard(w) -> bool:
    """Whether a DiP weight's storage is one rank's shard of its logical
    dims (``distributed.shard_weight``)."""
    if not isinstance(w, (DipWeight, QuantizedDipWeight)):
        return False
    return tuple(w.data.shape[-2:]) != DipWeight.storage_dims(w.d_in, w.d_out, w.perm_tile)


def _sharded_dispatch(be, x, w, weights, epilogue, operands, prologue, pro_operands, eps, verify):
    """The plan-aware dispatch on (weight.plan, backend, epilogue), or the
    decomposition of a weight whose split is absent."""
    plan = getattr(weights[0], "plan", None)
    needs_fsdp = be.name == "dip_fsdp"
    if (plan is None or plan.mesh is None or (not needs_fsdp and plan.kind == "replicated")
            or (needs_fsdp and plan.fsdp is None)):
        if any(_is_shard(wi) for wi in weights):
            raise ValueError(f"{be.name}: the weight holds one rank's shard but its plan {plan!r} splits nothing")
        inner = "dip" if isinstance(weights[0], DipWeight) else None
        return matmul(x, w, backend=inner, epilogue=epilogue, epilogue_operands=operands, prologue=prologue,
                      prologue_operands=pro_operands, prologue_eps=eps, verify=verify)
    if verify:
        raise NotImplementedError(f"verify= on the sharded backend {be.name!r} is not ported yet ({_DIST})")
    if prologue != "none":
        _check_prologue_inputs(weights, prologue, pro_operands)
    return be.fn(x, weights, operands, plan=plan, epilogue=epilogue, prologue=prologue,
                 prologue_operands=pro_operands, prologue_eps=eps)


# ------------------------------------------------------------------ shim ---
def _pad_last2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    pr, pc = rows - t.shape[-2], cols - t.shape[-1]
    return F.pad(t, (0, pc, 0, pr)) if (pr or pc) else t


def _logical_dims(w) -> Tuple[int, int]:
    if isinstance(w, (DipWeight, QuantizedDipWeight)):
        return w.d_in, w.d_out
    if w.dim() != 2:
        raise ValueError(f"matmul weight must be 2-D, got shape {tuple(w.shape)}")
    return int(w.shape[0]), int(w.shape[1])


def fused_recompute(prologue, epilogue, k_true, eps, x32, pops32, wns32, eops32) -> torch.Tensor:
    """``epilogue(prologue(x) @ W ...)`` in f32 from natural f32 weights:
    the one definition the backward differentiates (the reference's
    ``_fused_recompute``), built from the same ``prologue.apply`` and
    ``epilogue.apply`` as the plain versions (an f32 x makes the prologue's
    cast back a no-op)."""
    if prologue_lib.spec(prologue).normalize:
        x32 = prologue_lib.apply(prologue, x32, pops32[0], k_true=k_true, eps=eps)
    zs = [torch.matmul(x32, wn) for wn in wns32]
    if epilogue_lib.spec(epilogue).dual_weight:
        return epilogue_lib.apply(epilogue, zs[0], zs[1])
    return epilogue_lib.apply(epilogue, zs[0], *eops32)


class FusedDispatch(torch.autograd.Function):
    """One padded 2-D launch of a tiled backend with the f32-recompute
    backward.  ``tensors`` is ``(x2, *ws, *pops, *eops)``: the weight
    storages (two for ``swiglu``), the padded gain row and the padded bias
    row or residual block."""

    @staticmethod
    def forward(ctx, fn, layout, opts, n_w, n_p, *tensors):
        epilogue, prologue, k_true, eps = opts
        x2, ws = tensors[0], tensors[1:1 + n_w]
        pops, eops = tensors[1 + n_w:1 + n_w + n_p], tensors[1 + n_w + n_p:]
        kw = dict(epilogue=epilogue, prologue=prologue, prologue_k=k_true, prologue_eps=eps)
        if pops:
            kw["prologue_operands"] = pops
        ctx.save_for_backward(*tensors)
        ctx.meta = (layout, opts, n_w, n_p)
        return fn(x2, ws[0], *ws[1:], *eops, **kw)

    @staticmethod
    def backward(ctx, g):
        layout, (epilogue, prologue, k_true, eps), n_w, n_p = ctx.meta
        saved = ctx.saved_tensors

        def natural(i, t):
            return permute.unpermute_tiled(t, PERM_TILE) if layout == "dip" and 1 <= i <= n_w else t

        with torch.enable_grad():
            leaves = [natural(i, t).detach().float().requires_grad_() for i, t in enumerate(saved)]
            x32, wns32 = leaves[0], leaves[1:1 + n_w]
            pops32, eops32 = leaves[1 + n_w:1 + n_w + n_p], leaves[1 + n_w + n_p:]
            out = fused_recompute(prologue, epilogue, k_true, eps, x32, pops32, wns32, eops32)
            grads = list(torch.autograd.grad(out, leaves, g.float()))
        for i in range(1, 1 + n_w):
            if layout == "dip":
                grads[i] = permute.permute_tiled(grads[i], PERM_TILE)
        return (None,) * 5 + tuple(d.to(t.dtype) for d, t in zip(grads, saved))


class QuantizedDispatch(torch.autograd.Function):
    """One padded 2-D launch of a ``dip_q`` backend with the straight-through
    backward.  ``tensors`` is ``(x2, q0, s0, [q1, s1,] *pops, *eops)``: the
    quantized storages with their scales (two pairs for ``swiglu``), the
    padded gain row and the padded bias row or residual block."""

    @staticmethod
    def forward(ctx, fn, opts, n_w, n_p, *tensors):
        epilogue, prologue, k_true, eps = opts
        x2, qs = tensors[0], tensors[1:1 + 2 * n_w]
        pops, eops = tensors[1 + 2 * n_w:1 + 2 * n_w + n_p], tensors[1 + 2 * n_w + n_p:]
        ctx.save_for_backward(*tensors)
        ctx.meta = (opts, n_w, n_p)
        return fn(x2, *qs, *eops, epilogue=epilogue, prologue=prologue, prologue_operands=pops,
                  prologue_k=k_true, prologue_eps=eps)

    @staticmethod
    def backward(ctx, g):
        (epilogue, prologue, k_true, eps), n_w, n_p = ctx.meta
        saved = ctx.saved_tensors
        x2, qs = saved[0], saved[1:1 + 2 * n_w]
        pops, eops = saved[1 + 2 * n_w:1 + 2 * n_w + n_p], saved[1 + 2 * n_w + n_p:]
        wns32 = [permute.unpermute_tiled(q.float(), PERM_TILE) * sc.float() for q, sc in zip(qs[::2], qs[1::2])]
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in (x2,) + pops + eops]
            out = fused_recompute(prologue, epilogue, k_true, eps, leaves[0], leaves[1:1 + n_p], wns32,
                                  leaves[1 + n_p:])
            grads = torch.autograd.grad(out, leaves, g.float())
        dx, dpops, deops = grads[0], grads[1:1 + n_p], grads[1 + n_p:]
        return ((None,) * 4 + (dx.to(x2.dtype),) + (None,) * (2 * n_w)
                + tuple(d.to(t.dtype) for d, t in zip(dpops + deops, pops + eops)))


def _tiled_dispatch(be, x, ws, out_cols, k_true, epilogue, operands, prologue, pro_operands, eps, scales=()):
    """One padded 2-D launch: x flattened to (M, Kp), the gain and bias rows
    and the residual padded to the storage ``ws`` (two for ``swiglu``), the
    output cropped to ``out_cols``.  ``dip_q`` backends take the storages'
    ``scales`` and go through :class:`QuantizedDispatch`; the others
    through :class:`FusedDispatch`."""
    lead = tuple(x.shape[:-1])
    kp, np_ = ws[0].shape
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[1] != kp:
        x2 = F.pad(x2, (0, kp - x2.shape[1]))
    x2 = x2.contiguous()
    pops: Tuple[torch.Tensor, ...] = ()
    if prologue_lib.spec(prologue).normalize:
        g = pro_operands[0].reshape(-1).float()
        pops = (F.pad(g, (0, kp - g.shape[0])).contiguous(),)
    spec = epilogue_lib.spec(epilogue)
    eops: Tuple[torch.Tensor, ...] = ()
    if spec.bias:
        b = operands[0].reshape(-1).float()
        eops = (F.pad(b, (0, np_ - b.shape[0])).contiguous(),)
    elif spec.residual:
        r = operands[0].reshape(-1, out_cols)
        eops = (_pad_last2(r, r.shape[0], np_).contiguous(),)
    if be.layout == "dip_q":
        pairs = tuple(t for w, sc in zip(ws, scales) for t in (w, sc))
        out = QuantizedDispatch.apply(be.fn, (epilogue, prologue, k_true, eps), len(ws), len(pops),
                                      x2, *pairs, *pops, *eops)
    else:
        out = FusedDispatch.apply(be.fn, be.layout, (epilogue, prologue, k_true, eps), len(ws), len(pops),
                                  x2, *ws, *pops, *eops)
    if np_ != out_cols:
        out = out[:, :out_cols]
    return out.reshape(lead + (out_cols,))


def _validated_dip_x(x: torch.Tensor, dw) -> torch.Tensor:
    if dw.data.dim() != 2:
        raise ValueError(
            f"matmul weight must be 2-D (got storage {tuple(dw.data.shape)}); index the stacked axis first"
        )
    if dw.perm_tile != PERM_TILE:
        raise ValueError(f"the dip kernel de-shears {PERM_TILE}-tiles, got perm_tile={dw.perm_tile}")
    if x.shape[-1] != dw.d_in:
        raise ValueError(
            f"x contraction {x.shape[-1]} does not match {type(dw).__name__} d_in={dw.d_in} "
            f"(storage {tuple(dw.data.shape)})"
        )
    return x


def _check_epilogue_inputs(x, weights, epilogue, operands) -> None:
    spec = epilogue_lib.spec(epilogue)
    if spec.dual_weight:
        wg, wu = weights
        if type(wg) is not type(wu):
            raise ValueError(f"epilogue {epilogue!r} weight pair must share a type")
        if _logical_dims(wg) != _logical_dims(wu):
            raise ValueError(f"epilogue {epilogue!r} weight pair must share logical dims")
        if isinstance(wg, QuantizedDipWeight) and wg.scheme != wu.scheme:
            raise ValueError(f"epilogue {epilogue!r} weight pair must share a quantization scheme, "
                             f"got {wg.scheme!r} / {wu.scheme!r}")
    d_out = _logical_dims(weights[0])[1]
    if spec.bias and tuple(operands[0].shape) not in ((d_out,), (1, d_out)):
        raise ValueError(f"epilogue {epilogue!r} bias must be ({d_out},) or (1, {d_out}), "
                         f"got {tuple(operands[0].shape)}")
    if spec.residual:
        want = tuple(x.shape[:-1]) + (d_out,)
        if tuple(operands[0].shape) != want:
            raise ValueError(f"epilogue {epilogue!r} residual must match the output shape {want}, "
                             f"got {tuple(operands[0].shape)}")
        if operands[0].dtype != x.dtype:
            raise TypeError(f"residual must be {x.dtype} like x, got {operands[0].dtype}")


def _check_prologue_inputs(weights, prologue, pro_operands) -> None:
    spec = prologue_lib.spec(prologue)
    if len(pro_operands) != spec.n_operands:
        raise ValueError(f"prologue {prologue!r} takes {spec.n_operands} prologue_operands, "
                         f"got {len(pro_operands)}")
    if spec.normalize:
        d_in = _logical_dims(weights[0])[0]
        if tuple(pro_operands[0].shape) not in ((d_in,), (1, d_in)):
            raise ValueError(f"prologue {prologue!r} gain must be ({d_in},) or (1, {d_in}), "
                             f"got {tuple(pro_operands[0].shape)}")


# -------------------------------------------------------------- dispatch ---
def matmul(
    x: torch.Tensor,
    w,
    *,
    backend: Optional[str] = None,
    epilogue: Optional[str] = None,
    epilogue_operands: Sequence[torch.Tensor] = (),
    prologue: Optional[str] = None,
    prologue_operands: Sequence[torch.Tensor] = (),
    prologue_eps: float = prologue_lib.DEFAULT_EPS,
    verify: Union[bool, str] = False,
):
    """``epilogue(prologue(x) @ w)`` through a registered backend.

    ``x``: (..., d_in); ``w``: a natural (d_in, d_out) tensor, a
    ``DipWeight`` or a ``QuantizedDipWeight`` — or a ``(w_gate, w_up)``
    pair for ``swiglu``.  Returns (..., d_out).  A ``QuantizedDipWeight``
    with no backend goes to its scheme's backend; other backends receive it
    dequantized at x's dtype.  ``bias``/``bias_gelu``/``bias_silu`` take
    ``epilogue_operands=(b,)``, ``residual`` takes ``(r,)`` of the output's
    shape and x's dtype; ``rmsnorm`` takes ``prologue_operands=(g,)``.

    ``verify`` (default off) adds the ABFT audit (``reliability.abft``):
    ``True`` / ``"auto"`` picks the strongest valid mode, ``"probe"``
    demands the row-sum audit and raises where it does not hold (a
    nonlinear epilogue, a fused prologue, two weights, an ``abft=False``
    backend), ``"storage"`` pins the weight-integrity rung.  Then the call
    returns ``(out, report)``, ``out`` bit-identical to the unverified
    call's.
    """
    epilogue = epilogue or "none"
    prologue = prologue or "none"
    spec = epilogue_lib.spec(epilogue)
    prologue_lib.spec(prologue)
    operands = tuple(epilogue_operands)
    pro_operands = tuple(prologue_operands)
    if spec.dual_weight:
        if not (isinstance(w, (tuple, list)) and len(w) == 2):
            raise ValueError(f"epilogue {epilogue!r} consumes a (w_gate, w_up) weight pair")
        weights = tuple(w)
    else:
        if isinstance(w, (tuple, list)):
            raise ValueError(f"a weight pair is only valid with the dual-weight 'swiglu' epilogue "
                             f"(got epilogue={epilogue!r})")
        weights = (w,)
    n_expected = 0 if spec.dual_weight else spec.n_operands
    if len(operands) != n_expected:
        raise ValueError(f"epilogue {epilogue!r} takes {n_expected} epilogue_operands, got {len(operands)}")
    if backend is None and isinstance(weights[0], QuantizedDipWeight):
        backend = weights[0].default_backend
    be = get_backend(backend)
    if be.layout == "sharded":
        return _sharded_dispatch(be, x, w, weights, epilogue, operands, prologue, pro_operands, prologue_eps,
                                 verify)
    if any(_is_shard(wi) for wi in weights):
        raise ValueError(f"backend {be.name!r} was given one rank's shard of a weight; dispatch it through "
                         "its plan's sharded backend (dip_tp / dip_fsdp / dip_sp / dip_ep)")

    if verify:
        # the ordinary dispatch, then the audit outside it (reliability sits
        # above the api layer: imported here)
        from repro_torch.reliability import abft

        out = matmul(x, w, backend=be.name, epilogue=epilogue, epilogue_operands=operands, prologue=prologue,
                     prologue_operands=pro_operands, prologue_eps=prologue_eps)
        report = abft.verify_matmul(x, weights, out, epilogue=epilogue, operands=operands, prologue=prologue,
                                    backend_abft=be.abft, mode=verify if isinstance(verify, str) else "auto")
        return out, report

    if prologue != "none":
        _check_prologue_inputs(weights, prologue, pro_operands)
        if prologue not in be.prologues:
            xn = prologue_lib.apply(prologue, x, pro_operands[0].reshape(-1), eps=prologue_eps)
            return matmul(xn, w, backend=be.name, epilogue=epilogue, epilogue_operands=operands)

    if epilogue != "none":
        _check_epilogue_inputs(x, weights, epilogue, operands)
        if epilogue not in be.epilogues:
            outs = [matmul(x, wi, backend=be.name, prologue=prologue, prologue_operands=pro_operands,
                           prologue_eps=prologue_eps) for wi in weights]
            aux = (outs[1].float(),) if spec.dual_weight else tuple(op.float() for op in operands)
            out_dtype = outs[0].dtype if outs[0].dtype.is_floating_point else torch.float32
            return epilogue_lib.apply(epilogue, outs[0].float(), *aux).to(out_dtype)

    if be.layout == "dip_q":
        qws = []
        for wi in weights:
            if isinstance(wi, QuantizedDipWeight):
                if wi.scheme != be.scheme:
                    raise ValueError(
                        f"backend {be.name!r} consumes scheme {be.scheme!r} but the weight is quantized "
                        f"as {wi.scheme!r} — requantize from the float weight (api.quant.quantize)")
                qws.append(wi)
            else:  # one-off convenience: models quantize once at init
                qws.append(quant.quantize(wi, be.scheme))
        xk = _validated_dip_x(x, qws[0])
        return _tiled_dispatch(be, xk, tuple(q.data for q in qws), qws[0].d_out, qws[0].d_in, epilogue,
                               operands, prologue, pro_operands, prologue_eps,
                               scales=tuple(q.scale for q in qws))

    if any(isinstance(wi, QuantizedDipWeight) for wi in weights):
        # another backend: fold the scales back in once, at the activation
        # dtype (an f32 weight would promote every output to f32)
        deq = x.dtype if x.dtype.is_floating_point else torch.float32
        weights = tuple(quant.dequantize(wi, deq) if isinstance(wi, QuantizedDipWeight) else wi
                        for wi in weights)

    if be.layout == "dip":
        dws = tuple(as_dip_weight(wi) for wi in weights)
        xk = _validated_dip_x(x, dws[0])
        return _tiled_dispatch(be, xk, tuple(dw.data for dw in dws), dws[0].d_out, dws[0].d_in,
                               epilogue, operands, prologue, pro_operands, prologue_eps)

    wns = tuple(wi.to_natural() if isinstance(wi, DipWeight) else wi for wi in weights)
    for wn in wns:
        if wn.dim() != 2:
            raise ValueError(f"matmul weight must be 2-D, got {tuple(wn.shape)}")
        if x.shape[-1] != wn.shape[-2]:
            raise ValueError(f"contraction mismatch: x {tuple(x.shape)} @ w {tuple(wn.shape)}")
    if not be.tiled:
        return be.fn(x, wns[0])
    k, n = wns[0].shape
    kp, np_ = DipWeight.storage_dims(k, n, PERM_TILE)
    return _tiled_dispatch(be, x, tuple(_pad_last2(wn, kp, np_).contiguous() for wn in wns), n, k,
                           epilogue, operands, prologue, pro_operands, prologue_eps)
