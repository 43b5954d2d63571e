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

__all__ = ["AdamW", "clip_by_global_norm", "global_norm"]

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
class AdamW:
    lr: Schedule = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_transform: Optional[Any] = None

    def __post_init__(self):
        if self.grad_transform is not None:
            raise NotImplementedError(
                'gradient transforms (compression) are not ported yet (ROADMAP.md Queue 1 "Distributed")')

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        first = tree.leaves(params)[0]
        return {
            "mu": tree.map_tree(zeros, params),
            "nu": tree.map_tree(zeros, params),
            "count": 0,
            "grad_norm": torch.zeros((), dtype=torch.float32, device=first.device),
        }

    def _lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(np.float32(self.lr))

    @torch.no_grad()
    def update(self, grads, state: Dict[str, Any], params, *, gnorm: Optional[torch.Tensor] = None):
        """One step, in place on ``params``, ``state["mu"]`` and ``state["nu"]``;
        ``gnorm`` is the global norm when the caller has it (under a
        sharding plan, :func:`global_norm` over the ranks), else it is
        computed over ``grads``."""
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
