"""The port's accelerator-abstraction boundary (port of ``repro.api``).

* :class:`DipWeight` — permutated weight storage plus its logical shape.
* :class:`QuantizedDipWeight` and ``quant`` — int8 / fp8-e4m3 permutated
  storage with per-output-channel scales (``quant.quantize``).
* ``matmul(x, w, backend=...)`` — the matmul registry: ``torch`` (plain,
  the peer of ``xla``), ``ws`` (the CUDA kernel on natural storage),
  ``dip`` (the CUDA kernel on DiP storage, the peer of ``pallas_dip``),
  ``systolic`` (the wavefront kernel, the peer of ``pallas_systolic``) and
  the quantized ``dip_int8w`` / ``dip_fp8``, with fused prologues/epilogues
  and the decomposition rule.
* ``attention(q, k, v, backend=...)`` — ``flash`` (the CUDA kernel) and
  ``dense`` (the torch oracle).
"""

from repro_torch.api.weights import PERM_TILE, DipWeight, as_dip_weight
from repro_torch.api import quant
from repro_torch.api.quant import QuantizedDipWeight
from repro_torch.api.registry import (
    DEFAULT_BACKEND,
    EPILOGUES,
    PROLOGUES,
    MatmulBackend,
    backend_layout,
    get_backend,
    list_backends,
    matmul,
)
from repro_torch.api.attention import attention

__all__ = [
    "PERM_TILE",
    "DipWeight",
    "as_dip_weight",
    "quant",
    "QuantizedDipWeight",
    "DEFAULT_BACKEND",
    "EPILOGUES",
    "PROLOGUES",
    "MatmulBackend",
    "backend_layout",
    "get_backend",
    "list_backends",
    "matmul",
    "attention",
]
