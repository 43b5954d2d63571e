"""``QuantizedDipWeight`` — reduced-precision permutated weight storage (port
of ``repro/api/quant.py``).

    storage   ``data``    (..., Kp, Np) quantized permutated storage (int8 or
                          float8_e4m3fn), zero-padded to the tile grid
              ``scale``   (..., 1, Np) float32 per-output-channel scales
                          (padding columns carry 1.0)
    metadata  ``d_in`` / ``d_out`` / ``perm_tile`` as in ``DipWeight``;
              ``scheme`` (``int8`` | ``fp8_e4m3``)

The permutation rotates rows within a column, so one scale per storage
column dequantizes permutated and natural layout alike.  The ``dip_int8w``
and ``dip_fp8`` matmul backends consume this type (``kernels/dip_matmul_q.py``);
any other backend receives it dequantized at the activation dtype.

Every quantizer divides by the scale (never multiplies by its reciprocal),
rounds half to even (``torch.round``, as ``jnp.round``) and clips integer
codes to +-127, so the same float32 input gives the same bytes as the
reference.  The scale is amax divided by ``qmax`` held as a tensor on the
input's device: torch's CUDA division by a Python scalar multiplies by its
rounded reciprocal, which moves some scales by one ulp (and their codes with
them) off the IEEE quotient, so a pool written on the card would differ from
the same rows quantized on the CPU.  fp8 codes are the dtype cast itself:
the scale maps amax onto 448, the format's largest normal, so no value
leaves the range (where ``ml_dtypes`` would give NaN and torch saturates).

``checksum`` is the optional ABFT child and ``plan`` the optional partition
decision, as on ``DipWeight`` (under a plan ``data`` and, on a column
plan, ``scale`` are this rank's shards).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.api.weights import PERM_TILE, DipWeight
from repro_torch.core import permute

__all__ = [
    "QuantScheme",
    "SCHEMES",
    "scheme_info",
    "QuantizedDipWeight",
    "quantize",
    "dequantize",
    "dequantize_natural",
    "quantize_rows",
    "dequantize_rows",
    "rows_error_bound",
    "max_abs_error_bound",
]


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """One supported weight-quantization scheme."""

    name: str
    storage_dtype: torch.dtype  # dtype of the quantized storage
    qmax: float                 # |q| ceiling the scale maps amax onto
    backend: str                # matmul backend that consumes this scheme

    @property
    def is_integer(self) -> bool:
        return not self.storage_dtype.is_floating_point


SCHEMES: Dict[str, QuantScheme] = {
    # symmetric int8, the paper's PE datatype (DiP Table 3)
    "int8": QuantScheme("int8", torch.int8, 127.0, "dip_int8w"),
    # fp8 e4m3: amax maps onto 448; rounding is the cast
    "fp8_e4m3": QuantScheme("fp8_e4m3", torch.float8_e4m3fn, 448.0, "dip_fp8"),
}

_AMAX_FLOOR = 1e-8  # all-zero channels would otherwise get scale 0
_MANTISSA_BITS = {torch.float8_e4m3fn: 3}


def scheme_info(scheme: str) -> QuantScheme:
    try:
        return SCHEMES[scheme]
    except KeyError:
        raise ValueError(f"unknown quantization scheme {scheme!r}; supported: {sorted(SCHEMES)}") from None


class QuantizedDipWeight:
    """Quantized permutated storage plus per-output-channel scales."""

    __slots__ = ("data", "scale", "d_in", "d_out", "perm_tile", "scheme", "plan", "checksum")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor, d_in: int, d_out: int,
                 perm_tile: int = PERM_TILE, scheme: str = "int8", plan=None, checksum=None):
        self.plan = plan
        self.data = data
        self.scale = scale
        self.d_in = int(d_in)
        self.d_out = int(d_out)
        self.perm_tile = int(perm_tile)
        self.scheme = str(scheme)
        self.checksum = checksum

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def storage_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical shape: leading dims + (d_in, d_out)."""
        return tuple(self.data.shape[:-2]) + (self.d_in, self.d_out)

    @property
    def scheme_info(self) -> QuantScheme:
        return scheme_info(self.scheme)

    @property
    def default_backend(self) -> str:
        return self.scheme_info.backend

    def dequantize(self, dtype: torch.dtype = torch.float32) -> DipWeight:
        """Scales applied in the permutated domain (they commute with the
        per-column rotation); returns a float ``DipWeight`` (the plan rides
        along)."""
        return DipWeight((self.data.float() * self.scale).to(dtype), self.d_in, self.d_out, self.perm_tile,
                         self.plan)

    def to_natural(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Dequantized natural-layout weight (inverse permutation + crop)."""
        return self.dequantize(dtype).to_natural()

    def with_data(self, data: torch.Tensor, scale: torch.Tensor, checksum=None) -> "QuantizedDipWeight":
        """Same metadata, different payloads (a layer slice, a device copy).
        The checksum does not carry over unless passed as ``checksum=``; the
        plan rides along."""
        return QuantizedDipWeight(data, scale, self.d_in, self.d_out, self.perm_tile, self.scheme,
                                  plan=self.plan, checksum=checksum)

    def with_checksum(self, checksum) -> "QuantizedDipWeight":
        """Same payloads, with an ABFT checksum attached."""
        return QuantizedDipWeight(self.data, self.scale, self.d_in, self.d_out, self.perm_tile, self.scheme,
                                  plan=self.plan, checksum=checksum)

    def with_plan(self, plan) -> "QuantizedDipWeight":
        """Same payloads, another partition decision."""
        if plan == self.plan:
            return self
        return QuantizedDipWeight(self.data, self.scale, self.d_in, self.d_out, self.perm_tile, self.scheme,
                                  plan=plan, checksum=self.checksum)

    def __repr__(self) -> str:
        return (f"QuantizedDipWeight({tuple(self.data.shape)}:{self.data.dtype}, scheme={self.scheme!r}, "
                f"d_in={self.d_in}, d_out={self.d_out}, perm_tile={self.perm_tile})")


def _scale(amax: torch.Tensor, info: QuantScheme) -> torch.Tensor:
    """``max(amax, floor) / qmax``, an IEEE quotient on every device."""
    return torch.clamp(amax, min=_AMAX_FLOOR) / torch.full_like(amax, info.qmax)


def _codes(x32: torch.Tensor, scale: torch.Tensor, info: QuantScheme) -> torch.Tensor:
    if info.is_integer:
        return torch.clamp(torch.round(x32 / scale), -info.qmax, info.qmax).to(info.storage_dtype)
    return (x32 / scale).to(info.storage_dtype)


def quantize(w: Union[torch.Tensor, DipWeight, QuantizedDipWeight], scheme: str = "int8", *,
             perm_tile: int = PERM_TILE) -> QuantizedDipWeight:
    """Quantize a natural (..., d_in, d_out) float tensor or a ``DipWeight``
    (de-sheared first; the permutation is exact) to permutated storage with
    per-output-channel scales.  A ``QuantizedDipWeight`` of the same scheme
    passes through; another scheme raises (two roundings would stack)."""
    info = scheme_info(scheme)
    if isinstance(w, QuantizedDipWeight):
        if w.scheme == scheme:
            return w
        raise ValueError(
            f"weight is already quantized as {w.scheme!r}; requantizing to {scheme!r} would stack two "
            "rounding errors — dequantize from the float checkpoint instead"
        )
    if isinstance(w, DipWeight):
        perm_tile = w.perm_tile
        wn = w.to_natural()
    else:
        wn = w
    if not wn.dtype.is_floating_point:
        raise TypeError(f"quantize expects a floating-point weight, got {wn.dtype}")
    d_in, d_out = int(wn.shape[-2]), int(wn.shape[-1])
    w32 = wn.float()
    amax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)          # (..., 1, d_out)
    scale = _scale(amax, info)
    storage = permute.permute_tiled(_codes(w32, scale, info), perm_tile)
    scale_p = F.pad(scale, (0, storage.shape[-1] - d_out), value=1.0)
    return QuantizedDipWeight(storage, scale_p, d_in, d_out, perm_tile, scheme)


def dequantize(qw: QuantizedDipWeight, dtype: torch.dtype = torch.float32) -> DipWeight:
    """Float ``DipWeight`` with the scales folded back in."""
    if not isinstance(qw, QuantizedDipWeight):
        raise TypeError(f"dequantize expects a QuantizedDipWeight, got {type(qw)}")
    return qw.dequantize(dtype)


def dequantize_natural(qw: QuantizedDipWeight, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantized natural-layout (d_in, d_out) weight."""
    return dequantize(qw, dtype).to_natural()


def quantize_rows(x: torch.Tensor, scheme: str = "int8") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` with ``x ~= q * scale`` per row (last axis); scale has
    shape ``x.shape[:-1] + (1,)``.  The paged KV cache stores int8 rows so."""
    info = scheme_info(scheme)
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = _scale(amax, info)
    return _codes(x32, scale, info), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (scale broadcasts over the last axis)."""
    return (q.float() * scale).to(dtype)


def _step_bound(scale: torch.Tensor, info: QuantScheme) -> torch.Tensor:
    if info.is_integer:
        return 0.5 * scale
    return scale * info.qmax * (2.0 ** -float(_MANTISSA_BITS[info.storage_dtype]))


def rows_error_bound(scale: torch.Tensor, scheme: str = "int8") -> torch.Tensor:
    """Worst-case |x - dequant(quant(x))| per row: half a step (int8), half
    an ulp at the row amax (fp8)."""
    return _step_bound(scale, scheme_info(scheme))


def max_abs_error_bound(qw: QuantizedDipWeight) -> torch.Tensor:
    """Per-output-channel worst-case elementwise quantization error."""
    return _step_bound(qw.scale[..., 0, : qw.d_out], qw.scheme_info)
