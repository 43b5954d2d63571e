"""The mesh and its collectives over ``torch.distributed`` (the port's
counterpart of ``jax.sharding.Mesh`` and of ``jax.lax.{psum, all_gather,
psum_scatter, ppermute, all_to_all}`` inside ``shard_map``).

The port runs one process per rank and every rank holds only its shard
(local view).  A :class:`Mesh` names its axes and their sizes (``data``
then ``model``: rank = data index x model size + model index), and holds one
process group per axis for this rank: the group of the ranks that differ
from it along that axis only.  A collective is one call on the axis's group.

**Transport**, chosen by where the ranks live, never by what failed:

    gloo   ranks on the CPU (tensors on the CPU)
    nccl   each rank owns a card (NCCL groups on the rank's card)
    host   ranks that share one card (NCCL refuses two ranks on one
           device): gloo groups, each payload copied from the card to the
           host and back explicitly; the products stay on the card

A mesh on CUDA must state its transport (``nccl`` or ``host``); one that
does not raises.  An *abstract* mesh (:func:`abstract_mesh`) has axis sizes
and no groups: plans are made and validated against it, and a collective on
it raises.

**The log.**  Every collective counts itself by the reference's primitive
name (``psum``, ``all_gather``, ``reduce_scatter``, ``ppermute``,
``all_to_all``, ``pmax``) in
:data:`COUNTS`; the sharded backends call :func:`note_launch` where they
dispatch a per-shard product, counted as ``launch``, and the ``sp`` model
path :func:`note_replicated` where a weight the plan leaves replicated
makes it gather rows (:func:`replicated`).  After
``reset(schedule=True)``, every collective and launch is also appended to
:data:`SCHEDULE` in issue order (the reference's ``collective_schedule``);
``dip_sp`` issues each ring hop before the launch it overlaps, and the
expert-parallel MoE layer its dispatch all-to-all before the shared-expert
launches (``models/moe.py``).

**Gradients.**  Every collective is differentiable, and its backward is its
transpose, issued on the same group and logged under its own name:
``psum`` <-> ``psum``, ``all_gather`` <-> ``psum_scatter`` (logged
``reduce_scatter``), ``all_to_all`` <-> the inverse ``all_to_all``, a ring
hop <-> the hop the other way round (:func:`hop_grad`).  The convention
that makes these transposes the right backward: a rank's cotangent of a
value that every rank holds alike (a replicated activation, the replicated
loss) is its *share*, and the ranks' shares sum to the single-rank
cotangent; a rank's cotangent of its own slice is that slice's whole
cotangent.  So a replicated loss is differentiated as ``loss / ranks``
(each rank seeds its share), a replicated value that enters rank-specific
work (its heads, its experts, its tokens) needs no collective, and a
parameter that every rank holds whole takes the psum of the ranks' shares
once, after the backward (``models/transformer.py::train_step_fn``).  The
backward's collectives run in the autograd engine's order, which is the
same on every rank for the same graph.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["TRANSPORTS", "Mesh", "abstract_mesh", "build_mesh", "psum", "pmax", "all_gather", "psum_scatter",
           "all_to_all", "ppermute_start", "hop_grad", "differentiated", "note_launch", "note_replicated",
           "replicated", "reset", "counts", "schedule", "COUNTS", "SCHEDULE"]

TRANSPORTS = ("gloo", "nccl", "host")
COLLECTIVES = ("psum", "all_gather", "reduce_scatter", "ppermute", "all_to_all")

COUNTS: collections.Counter = collections.Counter()
SCHEDULE: List[str] = []
_RECORD = [False]


def reset(schedule: bool = False) -> None:
    """Counts to 0; ``schedule=True`` also starts recording the order."""
    COUNTS.clear()
    SCHEDULE.clear()
    _RECORD[0] = bool(schedule)


def counts() -> Dict[str, int]:
    """Collectives and launches since :func:`reset`, by name (0 for none):
    the reference's ``count_collectives`` names and ``launch`` always, and
    ``pmax`` (gradient compression's shared scale, which that count has no
    name for) when one ran."""
    out = {name: COUNTS.get(name, 0) for name in COLLECTIVES + ("launch",)}
    if COUNTS.get("pmax"):
        out["pmax"] = COUNTS["pmax"]
    return out


def schedule() -> List[str]:
    return list(SCHEDULE)


def _log(name: str) -> None:
    COUNTS[name] += 1
    if _RECORD[0]:
        SCHEDULE.append(name)


def note_launch() -> None:
    """Log one per-shard product dispatch (the reference's ``pallas_call``)."""
    _log("launch")


def note_replicated() -> None:
    """Count one dispatch of a weight that the plan leaves replicated where
    the ``sp`` model path wants its columns split (not in the schedule)."""
    COUNTS["replicated"] += 1


def replicated() -> int:
    """:func:`note_replicated` calls since :func:`reset`."""
    return COUNTS.get("replicated", 0)


class Mesh:
    """Named axes over ``torch.distributed`` process groups (see module doc).

    ``shape``: axis name -> size, in mesh order.  ``rank``: this process's
    global rank; ``groups`` / ``members``: per axis, this rank's group and
    its members' global ranks in axis order (None for an abstract mesh).
    Equality is by value (axes, transport, device type, rank), so plans made
    against one mesh compare equal however often they are rebuilt."""

    def __init__(self, shape: Dict[str, int], *, transport: Optional[str] = None,
                 device: Optional[torch.device] = None, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None, members: Optional[Dict[str, List[int]]] = None):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        if transport is not None and transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
        self.transport = transport
        self.device = None if device is None else torch.device(device)
        self.rank = int(rank)
        self.groups = groups
        self.members = members

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def abstract(self) -> bool:
        return self.groups is None

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis:
                return (self.rank // stride) % self.shape[name]
            stride *= self.shape[name]
        raise KeyError(f"mesh has no axis {axis!r}; axes {self.axis_names}")

    def group(self, axis: str):
        if self.groups is None:
            raise RuntimeError(f"an abstract mesh {self.shape} has no process groups; build one with "
                               "distributed.make_local_mesh inside an initialized world")
        return self.groups[axis]

    def _key(self):
        return (tuple(self.shape.items()), self.transport, None if self.device is None else self.device.type,
                self.rank)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        where = "abstract" if self.abstract else f"rank {self.rank}, {self.transport} on {self.device}"
        return f"Mesh({self.shape}, {where})"


def abstract_mesh(**shape: int) -> Mesh:
    """Axis sizes without groups, for making and checking plans: an
    ``abstract_mesh(data=1, model=2)`` plan attaches and validates like a
    live one; its collectives raise."""
    return Mesh(shape)


def build_mesh(shape: Dict[str, int], *, transport: Optional[str], device=None) -> Mesh:
    """The mesh of ``shape`` over the initialized world; every rank calls it
    with the same arguments (the groups are created collectively)."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        if transport not in (None, "gloo"):
            raise ValueError(f"ranks on the CPU talk over gloo, got transport={transport!r}")
        transport = "gloo"
    elif device.type == "cuda":
        if transport not in ("nccl", "host"):
            raise ValueError(
                "a mesh on CUDA must state how its ranks map to cards: transport='nccl' (each rank owns a "
                f"card) or transport='host' (ranks share a card; payloads go through host memory); got "
                f"{transport!r}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    else:
        raise ValueError(f"unsupported mesh device {device}")
    if not dist.is_initialized():
        raise RuntimeError("a live mesh needs torch.distributed initialized (distributed.run_world does it); "
                           "plans alone take distributed.abstract_mesh")
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = Mesh(shape)
    if mesh.size != world:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} ranks, the world {world}")
    if transport == "nccl":
        torch.cuda.set_device(device)
    backend = "nccl" if transport == "nccl" else "gloo"
    groups: Dict[str, object] = {}
    members: Dict[str, List[int]] = {}
    names = mesh.axis_names
    for axis in names:
        # every group of this axis, in one order on every rank (new_group is collective)
        stride = 1
        for name in reversed(names[names.index(axis) + 1:]):
            stride *= mesh.shape[name]
        seen = set()
        for base in range(world):
            if base in seen or (base // stride) % mesh.shape[axis] != 0:
                continue
            ranks = [base + i * stride for i in range(mesh.shape[axis])]
            seen.update(ranks)
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[axis], members[axis] = g, ranks
    return Mesh(shape, transport=transport, device=device, rank=rank, groups=groups, members=members)


# ------------------------------------------------------------ transport ---
def _send_form(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The payload as the transport carries it: on ``host``, copied from the
    card to the host explicitly; else the contiguous tensor itself."""
    if mesh.transport == "host":
        return t.to("cpu")
    if mesh.transport == "nccl" and t.device.type != "cuda":
        raise ValueError(f"an nccl mesh carries CUDA tensors, got one on {t.device}")
    if mesh.transport == "gloo" and t.device.type != "cpu":
        raise ValueError(f"a gloo mesh carries CPU tensors, got one on {t.device}; a mesh of ranks sharing a "
                         "card takes transport='host'")
    return t.contiguous()


def _back(t: torch.Tensor, like: torch.Tensor, to_host: bool = False) -> torch.Tensor:
    """The received payload as ``like``'s dtype, on ``like``'s device (or,
    ``to_host``, in host memory)."""
    t = t.view(like.dtype) if t.dtype != like.dtype else t
    where = torch.device("cpu") if to_host else like.device
    return t.to(where) if t.device != where else t


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """One-byte payloads (int8 and float8 storage) move as their bytes: a
    gather or a hop copies them unchanged, and gloo carries no float8."""
    return t.view(torch.uint8) if t.element_size() == 1 and t.dtype != torch.uint8 else t


def _single(name: str, old: str):
    """``torch.distributed``'s single-tensor gather / scatter by the
    installed release's name for it: torch 2.13 names it ``*_single`` and
    deprecates ``*_tensor``; 2.11, on the H100 machine, has only
    ``*_tensor``."""
    return getattr(dist, name, None) or getattr(dist, old)


def _psum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """One ``all_reduce`` of ``t`` over ``axis``, logged ``psum``."""
    _log("psum")
    w = _send_form(t, mesh)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return _back(w, t)


def pmax(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum over ``axis`` (``jax.lax.pmax``); one
    ``all_reduce(MAX)``, logged ``pmax``.  No backward: it is taken of
    values that are not differentiated (a quantization scale)."""
    _log("pmax")
    t = t.detach()
    w = _send_form(t, mesh)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return _back(w, t)


def _all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0, to_host: bool = False) -> torch.Tensor:
    """One ``all_gather`` of ``t`` along ``dim``, logged."""
    _log("all_gather")
    n = mesh.shape[axis]
    w = _bytes(_send_form(t.movedim(dim, 0), mesh).contiguous())
    out = torch.empty((n * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    _single("all_gather_single", "all_gather_into_tensor")(out, w, group=mesh.group(axis))
    return _back(out, t.movedim(dim, 0), to_host).movedim(0, dim)


def _psum_scatter(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """One ``reduce_scatter`` of ``t`` along ``dim``, logged."""
    _log("reduce_scatter")
    n = mesh.shape[axis]
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not divide by {axis}={n}")
    w = _send_form(t.movedim(dim, 0), mesh).contiguous()
    out = torch.empty((w.shape[0] // n,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    scatter = _single("reduce_scatter_single", "reduce_scatter_tensor")
    scatter(out, w, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return _back(out, t).movedim(0, dim)


def _all_to_all(t: torch.Tensor, mesh: Mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """One ``all_to_all`` of ``t``, logged; the payload moves as its bytes
    (an exchange changes no value; gloo carries no float8)."""
    _log("all_to_all")
    n = mesh.shape[axis]
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} does not divide by {axis}={n}")
    lead = t.movedim(split_dim, 0)
    w = _send_form(lead, mesh).contiguous()
    raw = w.reshape(w.shape[0], -1).view(torch.uint8)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=mesh.group(axis))
    got = _back(out.view(w.dtype).reshape(w.shape), lead)
    return torch.cat([b.movedim(0, split_dim) for b in got.chunk(n, 0)], dim=concat_dim)


class _Hop:
    """A ring hop in flight: :meth:`wait` returns the received block."""

    def __init__(self, works, recv: torch.Tensor, like: torch.Tensor):
        self._works, self._recv, self._like = works, recv, like

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return _back(self._recv, self._like)


def ppermute_start(t: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1) -> _Hop:
    """Start sending ``t`` to the next rank on ``axis``'s ring and receiving
    the previous rank's block (``jax.lax.ppermute`` with ``perm = [(j, j +
    1)]``; ``shift=-1`` the other way round); returns at once, the transfer
    in flight.  One ``ppermute``.  The hop carries no gradient by itself:
    :func:`hop_grad` attaches the received block to the sent one."""
    _log("ppermute")
    g = mesh.group(axis)
    ring = mesh.members[axis]
    n = len(ring)
    me = ring.index(mesh.rank)
    w = _bytes(_send_form(t.detach(), mesh))
    recv = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, ring[(me + shift) % n], g),
           dist.P2POp(dist.irecv, recv, ring[(me - shift) % n], g)]
    return _Hop(dist.batch_isend_irecv(ops), recv, t)


# ------------------------------------------------------------ gradients ---
def differentiated(t: torch.Tensor) -> bool:
    """Whether autograd records work on ``t`` (grad mode on and ``t``
    requiring grad): a training forward, not a serving one."""
    return torch.is_grad_enabled() and t.requires_grad



class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.args = (mesh, axis)
        return _psum(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, *ctx.args), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, *ctx.args), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _psum_scatter(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _all_to_all(t, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return _all_to_all(g, mesh, axis, concat_dim, split_dim), None, None, None, None


class _HopGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sent, received, mesh, axis):
        ctx.args = (mesh, axis)
        return received.clone()

    @staticmethod
    def backward(ctx, g):
        # the received block's cotangent goes back to the rank it came from,
        # and the sent block's comes from the rank it went to
        return ppermute_start(g, *ctx.args, shift=-1).wait(), None, None, None


def psum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` (``jax.lax.psum``); one ``all_reduce``.  Its
    backward is a ``psum`` of the cotangents (module doc)."""
    return _Psum.apply(t, mesh, axis) if differentiated(t) else _psum(t, mesh, axis)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0, *, to_host: bool = False) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in axis order
    (``jax.lax.all_gather(..., tiled=True)``); one ``all_gather``.  Its
    backward reduce-scatters the cotangent back to this rank's block.
    ``to_host`` (no gradient): the result in host memory, where the
    ``host`` transport receives it anyway (a checkpoint's whole leaves)."""
    if to_host:
        return _all_gather(t.detach(), mesh, axis, dim, to_host=True)
    return _AllGather.apply(t, mesh, axis, dim) if differentiated(t) else _all_gather(t, mesh, axis, dim)


def psum_scatter(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum over ``axis``, of which this rank keeps its block of ``dim``
    (``jax.lax.psum_scatter(..., tiled=True)``); one ``reduce_scatter``.
    ``t.shape[dim]`` must divide by the axis size.  Its backward
    all-gathers the cotangent."""
    return _PsumScatter.apply(t, mesh, axis, dim) if differentiated(t) else _psum_scatter(t, mesh, axis, dim)


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Block ``j`` of ``split_dim`` to rank ``j`` of ``axis``, and the
    blocks received concatenated along ``concat_dim`` in axis order
    (``jax.lax.all_to_all(..., tiled=True)``); one ``all_to_all``.
    ``t.shape[split_dim]`` must divide by the axis size.  Its backward is
    the inverse exchange (``split_dim`` and ``concat_dim`` swapped)."""
    if differentiated(t):
        return _AllToAll.apply(t, mesh, axis, split_dim, concat_dim)
    return _all_to_all(t, mesh, axis, split_dim, concat_dim)


def hop_grad(sent: torch.Tensor, received: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``received`` (a finished :func:`ppermute_start` of ``sent``) joined
    to the graph: its backward sends the cotangent the other way round the
    ring (one ``ppermute``) as ``sent``'s.  The identity without grad."""
    return _HopGrad.apply(sent, received, mesh, axis) if differentiated(sent) else received
