"""Fail-safe training: screen every step, skip the poisoned ones (port of
``repro/reliability/guard.py``).

Two fault classes, two detectors:

* **Transient numerics** (a NaN/Inf loss or gradient): a finiteness screen
  of the loss and the global gradient norm.  The update is discarded, the
  step counter still advances (the loop cannot wedge on one batch), and
  ``skipped`` counts it.
* **Weight-storage corruption** (a parameter changed between steps): the
  **fingerprint side-car**, one f32 ``Σ|leaf|`` per parameter leaf,
  recomputed at the top of every step and compared with the reference in
  ``state["fingerprint"]``.  The reference is refreshed from the committed
  parameters and frozen when a step is skipped, so persistent corruption
  trips ``weight_faults`` every step until the host recovers (the
  ``Trainer`` restores the latest checkpoint).

The fingerprint is a side-car, not the per-weight ``AbftChecksum`` child:
a checksum child would be an optimizer leaf, and weight decay would
corrupt the reference itself.

:func:`guarded_step_fn` wraps a step that returns new tensors and selects
per leaf between the new and the incoming state, as the reference does.
The port's own training step updates its parameters and moments in place
(``optim/adamw.py``), where a select would need a second copy of the state;
``models.transformer.train_step_fn(guard=True)`` applies the same screens
before the update and calls the optimizer only when they pass (it uses
:func:`fingerprint` and :func:`fingerprint_ok` from here).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

__all__ = [
    "fingerprint",
    "fingerprint_ok",
    "fingerprint_paths",
    "guarded_step_fn",
    "init_guard_state",
    "locate_fingerprint_fault",
    "GUARD_KEYS",
]

# state keys the guard adds next to params / opt_state / step
GUARD_KEYS = ("fingerprint", "skipped", "weight_faults")

# |Σ|leaf|| drift tolerated between the stored reference and a recompute;
# loud faults (exponent / sign flips, NaNs) move the sum by about the
# element's magnitude (the reference's values)
_FP_RTOL = 1e-5
_FP_ATOL = 1e-6


def fingerprint(params: Any) -> torch.Tensor:
    """(n_leaves,) f32 per-leaf ``Σ|leaf|``, in ``tree.leaves`` order, one
    pass over each leaf with no copy of it.  A NaN anywhere in a leaf makes
    its entry NaN, which never compares equal."""
    with torch.no_grad():
        return torch.stack([torch.linalg.vector_norm(leaf.detach(), 1, dtype=torch.float32)
                            for leaf in tree_lib.leaves(params)])


def fingerprint_paths(params: Any) -> List[str]:
    """Leaf path strings aligned with :func:`fingerprint`'s entries (the
    reference's ``keystr`` parts joined by ``/``)."""
    return [p for p, _ in tree_lib.paths(params)]


def locate_fingerprint_fault(params: Any, reference: torch.Tensor) -> List[str]:
    """Host side: the parameter leaves whose recomputed fingerprint
    disagrees with ``reference`` (the trainer's corrupt-leaf diagnostic)."""
    now = fingerprint(params).cpu().numpy().astype(np.float64)
    ref = reference.detach().cpu().numpy().astype(np.float64)
    bad = ~(np.abs(now - ref) <= _FP_ATOL + _FP_RTOL * np.abs(ref))  # NaN compares unequal: flagged
    return [p for p, b in zip(fingerprint_paths(params), bad) if b]


def fingerprint_ok(now: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: every entry of ``now`` within tolerance of ``ref``."""
    return torch.all((now - ref).abs() <= _FP_ATOL + _FP_RTOL * ref.abs())


def guarded_step_fn(step_fn: Callable) -> Callable:
    """Wrap ``step(state, batch) -> (state, metrics)``, a step that returns
    new tensors, with the guard.  The guarded state carries
    :data:`GUARD_KEYS` next to the inner keys; metrics gain ``skipped`` /
    ``weight_fault`` (0/1 for this step) and ``skipped_total`` /
    ``weight_faults_total``.  The skip is a per-leaf ``torch.where``
    between the new and the incoming ``params`` and ``opt_state``; nothing
    is read back to the host."""

    def gstep(state: Dict[str, Any], batch) -> Tuple[Dict[str, Any], Dict]:
        inner = {k: v for k, v in state.items() if k not in GUARD_KEYS}
        fp_ref = state["fingerprint"]
        weights_ok = fingerprint_ok(fingerprint(inner["params"]), fp_ref)
        new_inner, metrics = step_fn(inner, batch)
        loss_ok = torch.isfinite(torch.as_tensor(metrics["loss"])) & torch.isfinite(
            torch.as_tensor(metrics["grad_norm"]))
        ok = weights_ok & loss_ok
        committed = {
            k: tree_lib.map_tree(lambda n, o: torch.where(ok, n, o), new_inner[k], inner[k])
            for k in ("params", "opt_state")
        }
        committed["step"] = new_inner["step"]
        fp_next = torch.where(ok, fingerprint(committed["params"]), fp_ref)
        skipped = torch.where(ok, 0, 1).to(torch.int32)
        wfault = torch.where(weights_ok, 0, 1).to(torch.int32)
        new_state = dict(committed, fingerprint=fp_next, skipped=state["skipped"] + skipped,
                         weight_faults=state["weight_faults"] + wfault)
        metrics = dict(metrics, skipped=skipped, weight_fault=wfault, skipped_total=new_state["skipped"],
                       weight_faults_total=new_state["weight_faults"])
        return new_state, metrics

    return gstep


def init_guard_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """The guard's side-car keys added to a fresh train state (the counters
    as host ints, as the port's step counter is)."""
    return dict(state, fingerprint=fingerprint(state["params"]), skipped=0, weight_faults=0)
