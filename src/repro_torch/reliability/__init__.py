"""The reliability layer: ABFT-verified matmuls, fault injection, fail-safe
loops (port of ``repro.reliability``).

* :mod:`repro_torch.reliability.abft` — Huang–Abraham checksums for every
  weight type, the dtype-aware tolerance model, and the audit behind
  ``api.matmul(..., verify=...)``.
* :mod:`repro_torch.reliability.inject` — deterministic fault injection
  (seeded bit flips, planted NaNs, a poisoned KV block, host fail-points),
  byte for byte as the reference's.
* :mod:`repro_torch.reliability.guard` — the fail-safe training step:
  nonfinite loss / gradient screening and a parameter fingerprint, with
  skip-and-count semantics that ``runtime.Trainer`` consumes.

The engine's retry → degrade → fail ladder and request deadlines live in
``serving/engine.py``; the checkpoint fail-points and crc32s in
``checkpoint/manager.py``.
"""

from repro_torch.reliability.abft import (
    ATOL,
    RTOL,
    AbftChecksum,
    ReliabilityError,
    attach_checksums,
    raise_on_fault,
    verify_matmul,
    weight_checksum,
)
from repro_torch.reliability.guard import (
    GUARD_KEYS,
    fingerprint,
    fingerprint_paths,
    guarded_step_fn,
    init_guard_state,
    locate_fingerprint_fault,
)
from repro_torch.reliability.inject import (
    InjectedFault,
    bitflip,
    corrupt_kv_block,
    corrupt_pytree,
    failpoint,
    maybe_fail,
    plant_nan,
)

__all__ = [
    "ATOL",
    "RTOL",
    "AbftChecksum",
    "ReliabilityError",
    "attach_checksums",
    "raise_on_fault",
    "verify_matmul",
    "weight_checksum",
    "GUARD_KEYS",
    "fingerprint",
    "fingerprint_paths",
    "guarded_step_fn",
    "init_guard_state",
    "locate_fingerprint_fault",
    "InjectedFault",
    "bitflip",
    "corrupt_kv_block",
    "corrupt_pytree",
    "failpoint",
    "maybe_fail",
    "plant_nan",
]
