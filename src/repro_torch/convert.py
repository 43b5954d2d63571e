"""Load the reference's parameters into the port.

``params_from_jax(np_params, cfg, device)`` takes the reference's
``init_params`` output moved to numpy (``jax.tree_util.tree_map(np.asarray,
params)``) and returns the port's parameter dict, so that both sides compute
with the same weights.  Leaves are numpy arrays (``ml_dtypes.bfloat16``
included, ``ml_dtypes.float8_e4m3fn`` read through a ``uint8`` view) or
DiP-stored weights, read by their attributes so nothing of the reference is
imported: an object that also has ``scale`` and ``scheme`` is the
reference's ``QuantizedDipWeight`` (checked first, so its scales are never
dropped); any other with ``data`` (numpy storage, kept permutated),
``d_in``, ``d_out`` and ``perm_tile`` is a ``DipWeight``.  Either one's ABFT
``checksum`` (the reference's ``AbftChecksum``, read by its fields) comes
across as a ``reliability.AbftChecksum`` of tensors, and its ``plan`` (the
reference's ``WeightPlan``, which holds a JAX mesh) as a
``distributed.WeightPlan`` of its kind and axis names only: a rank's slice
of the reference's parameters is ``plan.shard_params(params_from_jax(...))``
under a live ``ShardingPlan``, which decides each weight's plan anew.

Every family's tree converts leaf by leaf the same way: the SSM scalars and
norms as tensors, ``in_proj`` / ``out_proj`` as ``DipWeight``, the hybrid's
``shared_attn`` subtree, and a tied model's tree without ``lm_head``; a
quantized tree of any family the same, its layer-stacked int8 or fp8
projections as ``QuantizedDipWeight`` with their stacked scales.

``opt_state_from_jax(np_opt_state, device)`` converts the reference's AdamW
state the same way (moments leaf by leaf, ``count`` as an int, a gradient
transform's state, the compression's error-feedback buffers, leaf by
leaf), so that one optimizer step can be compared leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.api import DipWeight
from repro_torch.api.quant import QuantizedDipWeight
from repro_torch.device import resolve_device
from repro_torch.distributed.plan import WeightPlan
from repro_torch.reliability.abft import AbftChecksum

__all__ = ["params_from_jax", "opt_state_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (bf16 via its float32 widening, which is exact; fp8
    e4m3 through its bytes) as a tensor of the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _checksum(cs, dev):
    if cs is None:
        return None
    return AbftChecksum(*(None if getattr(cs, f) is None else tensor_from_numpy(getattr(cs, f), dev)
                          for f in AbftChecksum._fields))


def _plan(v):
    p = getattr(v, "plan", None)
    return None if p is None else WeightPlan(kind=p.kind, axis=p.axis, fsdp=p.fsdp)


def _convert(v, dev):
    if isinstance(v, dict):
        return {k: _convert(x, dev) for k, x in v.items()}
    if isinstance(v, np.ndarray):  # (its .data is a buffer, which refuses bf16)
        return tensor_from_numpy(v, dev)
    dip = all(hasattr(v, a) for a in ("data", "d_in", "d_out", "perm_tile"))
    if dip and hasattr(v, "scale") and hasattr(v, "scheme"):
        return QuantizedDipWeight(tensor_from_numpy(v.data, dev), tensor_from_numpy(v.scale, dev),
                                  v.d_in, v.d_out, v.perm_tile, v.scheme, plan=_plan(v),
                                  checksum=_checksum(getattr(v, "checksum", None), dev))
    if dip:
        return DipWeight(tensor_from_numpy(v.data, dev), v.d_in, v.d_out, v.perm_tile, plan=_plan(v),
                         checksum=_checksum(getattr(v, "checksum", None), dev))
    return tensor_from_numpy(v, dev)


def params_from_jax(np_params: Dict[str, Any], cfg, device="cuda") -> Dict[str, Any]:
    """Convert a (nested) reference parameter dict for ``cfg`` to the port's
    layout on ``device`` (default ``"cuda"``)."""
    params = _convert(np_params, resolve_device(device))
    if cfg.uses_dip_storage != _holds_dip(params):
        raise ValueError(f"parameter storage does not match cfg.uses_dip_storage={cfg.uses_dip_storage}")
    return params


def _holds_dip(t) -> bool:
    """Whether any linear of the tree is DiP-stored (a tied model has no
    ``lm_head``; its projections are the ``layers`` ones)."""
    if isinstance(t, dict):
        return any(_holds_dip(v) for v in t.values())
    return isinstance(t, (DipWeight, QuantizedDipWeight))


def opt_state_from_jax(np_opt_state: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference's AdamW state (``mu``, ``nu``, ``count``, ``grad_norm``
    and, with a gradient transform, ``transform``, as numpy) as the port's
    ``AdamW`` state on ``device``."""
    dev = resolve_device(device)
    state = {"mu": _convert(np_opt_state["mu"], dev), "nu": _convert(np_opt_state["nu"], dev),
             "count": int(np_opt_state["count"]),
             "grad_norm": tensor_from_numpy(np.asarray(np_opt_state["grad_norm"], np.float32), dev)}
    if "transform" in np_opt_state:
        state["transform"] = _convert(np_opt_state["transform"], dev)
    return state
