"""ABFT checksum verification for the matmul surface (port of
``repro/reliability/abft.py``).

Huang and Abraham's algorithm-based fault tolerance audits a product's
result in O(M·N) instead of recomputing it in O(M·K·N).  For ``out = x @ W``
the weight side keeps, once per weight, two natural-domain vectors

    row      r[k] = Σ_n W[k, n]     so that Σ_n out[m, n] == x[m, :] @ r
    row_abs  a[k] = Σ_n |W[k, n]|   its magnitude twin, the tolerance's scale

and one storage-domain vector

    col      c[j] = Σ_k P[k, j]     the column sums of the permutated storage
                                    P as it is (int codes for quantized
                                    weights, so the compare is exact)

plus ``scale_col`` (the scales' column sums) for a quantized weight.  The
DiP permutation rotates rows within a column (paper Fig. 3), so ``col`` is
layout-invariant.

Two verification modes (the degradation ladder):

* ``probe``   — ``rowsum(out)`` against ``x @ row`` under the dtype-aware
  tolerance below.  Valid for one weight under a linear epilogue (``none``
  / ``bias`` / ``residual``), no fused prologue, on an ``abft`` backend.  A
  stored checksum folds the storage compare in.
* ``storage`` — ``col`` (and ``scale_col``) recomputed against the stored
  reference, plus a nonfinite screen of the output; valid everywhere.

Row ``m`` passes iff ``|rowsum(out)[m] - expected[m]| <= ATOL + rtol *
(|x[m]| @ a + s)``, ``s`` the epilogue operands' magnitudes, plus for the
int8 W8A8 kernel ``amax(|x[m]|) / 254 * Σ a`` (its per-row activation
rounding).  ``rtol`` is :data:`RTOL` at the coarsest dtype in play; the
values are the reference's.

The report's scalars are 0-d tensors on the output's device: nothing in
:func:`verify_matmul` reads a value back to the host (:func:`raise_on_fault`
does).  The probe's ``x @ row`` is an elementwise product and a sum in f32,
never a TF32 product.  :func:`weight_checksum` works layer slice by layer
slice on a stacked weight, so it holds one slice's f32 natural copy, not the
stack's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence, Union

import torch

from repro_torch.api.quant import QuantizedDipWeight
from repro_torch.api.weights import DipWeight
from repro_torch.kernels import epilogue as epilogue_lib

__all__ = [
    "ATOL",
    "RTOL",
    "AbftChecksum",
    "ReliabilityError",
    "attach_checksums",
    "probe_applicable",
    "raise_on_fault",
    "verify_matmul",
    "weight_checksum",
]


class ReliabilityError(RuntimeError):
    """A checksum or finiteness audit failed (or an integrity check at restore)."""


class AbftChecksum(NamedTuple):
    """Precomputed per-weight checksums, an optional child of the weight
    (``tree`` flattens it as ``.checksum/.col`` ...).  ``col`` and
    ``scale_col`` are in the permutated storage domain, ``row`` and
    ``row_abs`` in the natural one (length ``d_in``); all float32."""

    col: Any                  # (..., Np) storage column sums
    row: Any                  # (..., d_in) W @ 1
    row_abs: Any              # (..., d_in) |W| @ 1
    scale_col: Any = None     # (..., Np) quantized-scale column sums


# Probe tolerances, keyed by the coarsest dtype in play (the reference's).
# Generous on purpose: a false positive poisons a healthy step, while the
# faults worth catching (flipped exponent / sign bits, NaNs) sit orders of
# magnitude above any rounding.
RTOL: Dict[str, float] = {
    "float32": 1e-4,
    "bfloat16": 2e-2,
    "float16": 5e-3,
    "int8": 5e-2,        # W8A8: weight rounding; activations add an amax term
    "fp8_e4m3": 8e-2,
}
ATOL = 1e-3

Weight = Union[DipWeight, QuantizedDipWeight, torch.Tensor]


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _storage(w: Weight) -> torch.Tensor:
    return w.data if isinstance(w, (DipWeight, QuantizedDipWeight)) else w


def _slice(w: Weight, i: int) -> Weight:
    """Layer slice ``i`` of a stacked weight (leading dims flattened)."""
    def flat(t):
        return t.reshape((-1,) + tuple(t.shape[-2:]))[i]
    if isinstance(w, QuantizedDipWeight):
        return w.with_data(flat(w.data), flat(w.scale))
    if isinstance(w, DipWeight):
        return w.with_data(flat(w.data))
    return flat(w)


def _col(data: torch.Tensor) -> torch.Tensor:
    """Storage column sums as stored, slice by slice: one definition for
    the checksum and for every recompute, so that a clean compare is exact."""
    if data.dim() > 2:
        flat = data.reshape((-1,) + tuple(data.shape[-2:]))
        return torch.stack([_col(d) for d in flat]).reshape(tuple(data.shape[:-2]) + (-1,))
    if data.dtype in (torch.bfloat16, torch.float16):  # summed in f32 as read: no f32 copy of the weight
        return data.sum(dim=-2, dtype=torch.float32)
    return data.float().sum(dim=-2)


def weight_checksum(w: Weight) -> AbftChecksum:
    """The checksum set of any weight type (one O(K·N) pass, a stacked
    weight one layer slice at a time).  A quantized weight's ``col`` sums
    its raw codes (sums of |q| <= 127 are exact in f32) and ``scale_col``
    pins its scales."""
    data = _storage(w)
    if data.dim() > 2:
        lead = tuple(data.shape[:-2])
        parts = [weight_checksum(_slice(w, i)) for i in range(data[..., 0, 0].numel())]
        return AbftChecksum(*(None if f[0] is None else torch.stack(f).reshape(lead + (-1,))
                              for f in zip(*parts)))
    with torch.no_grad():
        if isinstance(w, QuantizedDipWeight):
            wn = w.to_natural(torch.float32)
        else:
            wn = (w.to_natural() if isinstance(w, DipWeight) else w).float()
        scale_col = w.scale.float().sum(dim=-2) if isinstance(w, QuantizedDipWeight) else None
        return AbftChecksum(col=_col(data), row=wn.sum(dim=-1), row_abs=wn.abs().sum(dim=-1),
                            scale_col=scale_col)


def attach_checksums(tree: Any) -> Any:
    """Stamp an :class:`AbftChecksum` on every ``DipWeight`` /
    ``QuantizedDipWeight`` of a tree that has none (idempotent).  Checksums
    are frozen inference artifacts: training uses the fingerprint side-car
    of ``reliability.guard`` instead, so that weight decay never touches a
    reference."""
    if isinstance(tree, dict):
        return {k: attach_checksums(v) for k, v in tree.items()}
    if isinstance(tree, (DipWeight, QuantizedDipWeight)):
        return tree if tree.checksum is not None else tree.with_checksum(weight_checksum(tree))
    return tree


# --------------------------------------------------------------------------
# verification
def _checksum_of(w: Weight) -> AbftChecksum:
    if isinstance(w, (DipWeight, QuantizedDipWeight)) and w.checksum is not None:
        return w.checksum
    return weight_checksum(w)


def _rtol_for(x_dtype: torch.dtype, weights) -> float:
    names = [_dtype_name(x_dtype)]
    for w in weights:
        names.append(w.scheme if isinstance(w, QuantizedDipWeight) else _dtype_name(w.dtype))
    return max(RTOL.get(n, RTOL["float32"]) for n in names)


def _storage_ok(w: Weight, ref: AbftChecksum) -> torch.Tensor:
    """Recomputed column sums against the stored reference: the same
    reduction on the same storage, so a clean compare is exact; the
    tolerance only absorbs references that crossed a dtype or device."""
    col_now = _col(_storage(w))
    ok = torch.all((col_now - ref.col).abs() <= 1e-5 * (1.0 + ref.col.abs()))
    if isinstance(w, QuantizedDipWeight) and ref.scale_col is not None:
        s_now = w.scale.float().sum(dim=-2)
        ok = ok & torch.all((s_now - ref.scale_col).abs() <= 1e-5 * (1.0 + ref.scale_col.abs()))
    return ok


_LINEAR_EPILOGUES = frozenset({"none", "bias", "residual"})


def probe_applicable(epilogue: str = "none", prologue: str = "none", backend_abft: bool = True,
                     n_weights: int = 1) -> bool:
    """Whether the full row-sum probe is valid for this dispatch (the top
    rung of the degradation ladder)."""
    return backend_abft and n_weights == 1 and epilogue in _LINEAR_EPILOGUES and prologue == "none"


def verify_matmul(x: torch.Tensor, weights: Sequence[Any], out: torch.Tensor, *, epilogue: str = "none",
                  operands: Sequence[torch.Tensor] = (), prologue: str = "none", backend_abft: bool = True,
                  mode: str = "auto") -> Dict[str, Any]:
    """Audit ``out`` as the claimed result of ``epilogue(x @ w, ...)``.

    Returns ``mode`` (str) and 0-d tensors on ``out``'s device: ``ok`` /
    ``finite`` / ``checksum_ok`` (bool), ``rows_flagged`` (int32),
    ``max_excess`` (float32: the worst row's error beyond its tolerance,
    <= 0 when clean; +-inf in storage mode).  ``mode="auto"`` picks the
    strongest applicable rung; ``"probe"`` where it is invalid raises."""
    weights = tuple(weights)
    can_probe = probe_applicable(epilogue, prologue, backend_abft, len(weights))
    if mode == "auto":
        mode = "probe" if can_probe else "storage"
    elif mode == "probe" and not can_probe:
        raise ValueError(
            f"probe verification is invalid here (epilogue={epilogue!r}, prologue={prologue!r}, "
            f"abft={backend_abft}, {len(weights)} weights): the row-sum identity only holds for a single "
            "weight under a linear epilogue on an abft-capable backend — use mode='storage' or 'auto'")
    elif mode not in ("probe", "storage"):
        raise ValueError(f"mode must be 'auto'|'probe'|'storage', got {mode!r}")

    with torch.no_grad():
        finite = torch.isfinite(out).all()
        if mode == "storage":
            ok = finite
            for w in weights:
                ok = ok & _storage_ok(w, _checksum_of(w))
            return {"mode": "storage", "ok": ok, "finite": finite, "checksum_ok": ok | ~finite,
                    "rows_flagged": torch.where(ok, 0, 1).to(torch.int32),
                    "max_excess": torch.where(ok, float("-inf"), float("inf")).to(torch.float32)}

        ref = _checksum_of(weights[0])
        # a stored reference also enables the exact storage compare, which
        # catches small code flips that hide inside the W8A8 tolerance
        storage_ok = torch.ones((), dtype=torch.bool, device=out.device)
        for w in weights:
            if isinstance(w, (DipWeight, QuantizedDipWeight)) and w.checksum is not None:
                storage_ok = storage_ok & _storage_ok(w, w.checksum)
        x32 = x.float()
        rowsum = out.float().sum(dim=-1)
        expected = (x32 * ref.row).sum(dim=-1)
        magnitude = (x32.abs() * ref.row_abs).sum(dim=-1)
        spec = epilogue_lib.spec(epilogue)
        if spec.bias:
            b32 = operands[0].float().reshape(-1)
            expected = expected + b32.sum()
            magnitude = magnitude + b32.abs().sum()
        if spec.residual:
            r32 = operands[0].float()
            expected = expected + r32.sum(dim=-1)
            magnitude = magnitude + r32.abs().sum(dim=-1)
        tol = ATOL + _rtol_for(x.dtype, weights) * magnitude
        if isinstance(weights[0], QuantizedDipWeight) and weights[0].scheme == "int8":
            # W8A8: the kernel quantizes x per row; half an activation step
            # dotted against |W| summed over N bounds the drift
            tol = tol + x32.abs().amax(dim=-1) / 254.0 * ref.row_abs.sum()
        err = (rowsum - expected).abs()
        row_ok = err <= tol  # a NaN / Inf row never passes, so the probe subsumes the screen
        return {"mode": "probe", "ok": row_ok.all() & finite & storage_ok, "finite": finite,
                "checksum_ok": row_ok.all() & storage_ok, "rows_flagged": (~row_ok).sum().to(torch.int32),
                "max_excess": (err - tol).max().to(torch.float32)}


def raise_on_fault(report: Dict[str, Any], context: str = "matmul") -> None:
    """Host side: raise :class:`ReliabilityError` on a failed audit (reads
    the report's scalars back)."""
    if bool(report["ok"]):
        return
    raise ReliabilityError(
        f"ABFT verification failed in {context}: mode={report['mode']} finite={bool(report['finite'])} "
        f"rows_flagged={int(report['rows_flagged'])} max_excess={float(report['max_excess']):.3e}")
