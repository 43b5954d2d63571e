"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``).

The state mirrors the parameter tree leaf for leaf, in f32: a ``DipWeight``
leaf's moments stay in its permutated layout, which is exact because the
update is elementwise.  Unlike the reference, :meth:`AdamW.update` works IN
PLACE — it writes the new parameters into ``params`` and the new moments
into ``state["mu"]`` / ``state["nu"]`` — so a full-width step holds one copy
of each, and returns ``(params, state)``::

    opt = AdamW(lr=...)
    state = opt.init(params)
    params, state = opt.update(grads, state, params)
    opt.last_grad_norm(state) -> 0-d f32 tensor (pre-clip global norm)

The arithmetic follows the reference step by step (f32 moments, bias
corrections from ``b ** count`` in f32, decay on leaves with ndim >= 2).
A ``grad_transform`` (``distributed.compression.compression_transform``)
runs first, before clipping, as the reference's ``update`` does: its state
is ``state["transform"]``, and ``grad_norm`` is the transformed gradients'
norm.
The update walks each leaf in slabs of its leading axis (at most
:data:`SLAB` elements), clipping each slab of the gradient as it goes, so
its transients are a slab's and not a leaf's (a full-width Zamba2 in_proj
leaf is 5.8 GB); elementwise, the result is the same bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import tree

__all__ = ["AdamW", "GradientTransform", "clip_by_global_norm", "global_norm"]

Schedule = Union[float, Callable[[int], float]]


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def global_norm(grads, *, replicated: Optional[Sequence[Optional[slice]]] = None,
                psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The f32 global norm of a gradient tree (or a list of its leaves), as
    :meth:`AdamW.update` computes it.  Under a sharding plan
    (``replicated``: per leaf, the part of its last dim that every rank
    holds alike, ``slice(None)`` for a whole leaf, None for a rank's
    slice; ``psum``: the sum over the ranks) the ranks' own parts count
    once each (ONE psum of their squared sums) and the parts held alike
    once, so that every rank gets the single-rank norm."""
    flat = grads if isinstance(grads, list) else tree.leaves(grads)
    if replicated is None:
        return _global_norm(flat)
    own = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    alike = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for g, rep in zip(flat, replicated):
        g = g.float()
        if rep is None:
            own = own + torch.sum(torch.square(g))
        elif rep == slice(None):
            alike = alike + torch.sum(torch.square(g))
        else:
            own = own + torch.sum(torch.square(g[..., :rep.start]))
            alike = alike + torch.sum(torch.square(g[..., rep]))
    return torch.sqrt(psum(own) + alike)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


# elements of one slab of the update's leading-axis walk (64 MiB of f32)
SLAB = 1 << 24


def _slabs(t: torch.Tensor):
    """``t`` as views along its leading axis of at most :data:`SLAB`
    elements each (one row when a row is larger); a 0-d or small tensor is
    one slab."""
    if t.dim() == 0 or t.numel() <= SLAB:
        return (t,)
    return t.split(max(1, SLAB // t[0].numel()))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / norm), norm)`` with ``norm`` the f32
    global norm; the scaled leaves are new tensors (:meth:`AdamW.update`
    scales each slab as it goes instead)."""
    flat = tree.leaves(grads)
    norm = _global_norm(flat)
    scale = _clip_scale(norm, max_norm)
    return tree.unflatten(grads, [(g * scale).to(g.dtype) for g in flat]), norm


@dataclasses.dataclass(frozen=True)
class GradientTransform:
    """A hook applied to the gradients before the optimizer (the reference's
    ``GradientTransform``).  ``fn(grads, state, reduce_max=None) -> (grads,
    state)``; ``reduce_max``, under a sharding plan, maxes a vector of
    per-leaf values over the ranks that share the leaves."""

    fn: Callable[..., tuple]
    init: Callable[[Any], Any]  # params -> transform state


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Schedule = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_transform: Optional[GradientTransform] = None

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        first = tree.leaves(params)[0]
        state = {
            "mu": tree.map_tree(zeros, params),
            "nu": tree.map_tree(zeros, params),
            "count": 0,
            "grad_norm": torch.zeros((), dtype=torch.float32, device=first.device),
        }
        if self.grad_transform is not None:
            state["transform"] = self.grad_transform.init(params)
        return state

    def transform(self, grads, state: Dict[str, Any], *,
                  reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """``grads`` after ``grad_transform`` (the identity without one),
        its state ``state["transform"]`` advanced (in place for the
        compression transform); ``reduce_max`` under a sharding plan (see
        :class:`GradientTransform`).  A caller that must read the
        transformed gradients' norm before it decides to update (the guard,
        a plan's norm over the ranks) runs it and passes
        ``update(..., transformed=True)``."""
        if self.grad_transform is None:
            return grads
        grads, state["transform"] = self.grad_transform.fn(grads, state["transform"], reduce_max=reduce_max)
        return grads

    def _lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(np.float32(self.lr))

    @torch.no_grad()
    def update(self, grads, state: Dict[str, Any], params, *, gnorm: Optional[torch.Tensor] = None,
               transformed: bool = False):
        """One step, in place on ``params``, ``state["mu"]`` and ``state["nu"]``
        (and, with a ``grad_transform``, on ``grads`` and
        ``state["transform"]``).  The transform runs first (:meth:`transform`)
        unless ``transformed`` says that the caller ran it; ``gnorm`` is
        the global norm of the gradients as clipped when the caller has it
        (under a sharding plan, :func:`global_norm` over the ranks), else
        it is computed over them."""
        if self.grad_transform is not None and not transformed:
            if gnorm is not None:
                raise ValueError("gnorm must be the transformed gradients' norm: run transform() first and "
                                 "pass transformed=True")
            grads = self.transform(grads, state)
        flat = tree.leaves(grads)
        if gnorm is None:
            gnorm = _global_norm(flat)
        scale = _clip_scale(gnorm, self.clip_norm)
        count = int(state["count"]) + 1
        f32 = np.float32
        b1c = float(f32(1.0) - f32(self.b1) ** f32(count))
        b2c = float(f32(1.0) - f32(self.b2) ** f32(count))
        lr = self._lr_at(count)
        for g, mu, nu, p in zip(flat, tree.leaves(state["mu"]), tree.leaves(state["nu"]), tree.leaves(params)):
            decay = self.weight_decay and p.dim() >= 2  # decay matrices only
            # slab by slab along the leading axis: the same elementwise
            # arithmetic, with transients of one slab instead of the leaf
            for gs, ms, ns, ps in zip(*(_slabs(t) for t in (g, mu, nu, p))):
                g32 = (gs * scale).to(gs.dtype).float()  # clip_by_global_norm's leaf
                ms.mul_(self.b1).add_(g32 * (1 - self.b1))
                ns.mul_(self.b2).add_(torch.square(g32) * (1 - self.b2))
                step = (ms / b1c) / (torch.sqrt(ns / b2c) + self.eps)
                if decay:
                    step = step + self.weight_decay * ps.float()
                ps.add_((-lr * step).to(ps.dtype))
        state["count"] = count
        state["grad_norm"] = gnorm
        return params, state

    @staticmethod
    def last_grad_norm(state) -> torch.Tensor:
        return state["grad_norm"]
