"""``ShardingPlan`` — the mesh, the declarative per-weight partition rules
and the activation constraints (port of ``repro/distributed/plan.py``).

The reference's plan is global-view: a ``PartitionSpec`` says how XLA
splits a global array.  The port runs one process per rank, each holding
only its shard (Megatron-style local view, as the reference's
``kernels/dip_matmul_sharded.py`` module doc describes it), so a spec here
says which slice of a leaf this rank holds; the global array is the
concatenation of the ranks' slices along the spec's dims.  Specs are
tuples of axis names (or None), one per dim, as ``PartitionSpec`` holds
them.

* :data:`LAYER_RULES` maps a template leaf name to its role; a role
  resolves to a concrete :class:`WeightPlan` (column / row / replicated)
  against this plan's mesh (:meth:`ShardingPlan.weight_plan`), checked
  against the *storage* dims so every shard is perm-tile-aligned DiP
  storage.  A mis-sized dim replicates and warns once (``strict`` raises).
* :meth:`ShardingPlan.attach_params` stamps every ``DipWeight`` /
  ``QuantizedDipWeight`` with its plan; :meth:`ShardingPlan.shard_params`
  also cuts each leaf to this rank's slice (the model path's layout under
  ``tp``, ``sp``, ``ep`` and ``fsdp``).  Under ``tp``, ``sp`` and ``ep``:
  projections by their plan, the MoE expert banks by expert, the embedding
  and the lm_head by vocab, everything else whole (``sp`` consumes the
  same column / row shards as ``tp``: the reference's specs do not depend
  on the strategy); under ``ep`` the shared experts stay whole, since the
  expert-parallel layer runs them plan-free on the rank's tokens.  Under
  ``fsdp`` (ZeRO-3): every DiP projection, the lm_head included, along its
  storage K over ``data`` (``shard_weight(..., along="fsdp")``, the layout
  ``dip_fsdp`` gathers), the embedding's d over ``data`` as the reference's
  spec cuts it, each MoE expert bank along its contraction dim (d of the
  gate / up banks (L, E, d, ffe), ffe of the down bank (L, E, ffe, d)) and
  the router (L, d, E) along d, as the reference's ``expert_bank`` and
  ``router`` specs cut them, the norms and the SSM leaves whole.
* **The SSM leaves under ``tp`` and ``sp`` are cut by head**, not as the
  reference's specs cut them: a rank holds the H / T consecutive heads
  (:meth:`ShardingPlan.ssm_heads`) of ``dt_bias``, ``A_log`` and ``D``,
  their ``d_inner / T`` channels of the gated norm's gain ``norm``, and of
  ``conv_w`` / ``conv_b`` its heads' x channels followed by the whole B
  and C (one B/C group, which every head reads).  The reference's
  ``conv`` and ``vector_tp`` roles split ``conv_dim / T`` channels, which
  fall on no head boundary (Zamba2: 5248 / 2 = 2624, all of x's first 2560
  and 64 of B); GSPMD reshards that implicitly, a local-view rank cannot.
  :meth:`ShardingPlan.param_pspec` still returns the reference's specs
  (its global-view contract); the conv history and state pools follow the
  leaves (:meth:`ShardingPlan.paged_cache_pspec`).
* :meth:`ShardingPlan.gather_leaf` / :meth:`ShardingPlan.gather_params`
  are the inverse of ``shard_leaf`` / ``shard_params``: every rank's slice
  of a leaf all-gathered whole (a collective), so that a checkpoint saved
  under a plan holds whole, mesh-independent leaves
  (``checkpoint.manager``).
* :attr:`ShardingPlan.expert_plan` is the ``WeightPlan(kind="expert")``
  that the MoE layer dispatches on under ``ep`` (None otherwise).
* ``with_sharding_constraint`` has no counterpart: the explicit strategies
  place every collective by hand, so :meth:`ShardingPlan.constrain` is the
  identity.

* **Pipeline stages** (``pp``, over the ``("stage", "data", "model")``
  mesh that ``make_local_mesh(stage=)`` builds): rank s of S holds the
  contiguous layers ``[s L / S, (s + 1) L / S)`` of every layer-stacked
  leaf (:meth:`ShardingPlan.stage_layers`, cut along the leading axis) and
  the embedding, the final norm and the lm_head whole; the stages run the
  config's own backend (``explicit_backend`` is None) through
  ``distributed.pipeline``.

Strategies this slice runs: ``tp``, ``sp``, ``ep`` and ``fsdp`` (the
model path and the matmul backends), ``pp`` over a stage axis alone (data
and model 1) and ``gspmd`` over a one-rank mesh.  ``gspmd`` over more than
one rank, ``pp`` beside a data or model axis above 1 and a stage axis under
another strategy raise, citing ROADMAP.md Queue 1 "Distributed".
``make_production_mesh`` (a 256/512-chip TPU pod layout) waits with the
dry-run.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Set, Tuple

import torch

from repro_torch.api.quant import QuantizedDipWeight
from repro_torch.api.weights import DipWeight
from repro_torch.distributed.comm import Mesh, build_mesh

__all__ = ["WeightPlan", "LAYER_RULES", "ShardingPlan", "make_plan", "make_local_mesh", "STRATEGIES",
           "shard_weight"]

_DIST = 'ROADMAP.md Queue 1 "Distributed"'
STRATEGIES = ("gspmd", "tp", "fsdp", "sp", "ep", "pp")
_RUNS = ("gspmd", "tp", "fsdp", "sp", "ep", "pp")
_MODEL_PATHS = ("tp", "sp", "ep", "fsdp")
_HEAD_SPLIT = ("tp", "sp")  # the strategies whose ranks run H / T SSM heads
_STAGE_WHOLE = ("embed", "final_norm", "lm_head")  # the leaves every stage holds whole

Spec = Tuple[Optional[str], ...]


def make_local_mesh(data: int = 1, model: int = 1, stage: int = 1, *, transport: Optional[str] = None,
                    device=None) -> Mesh:
    """The ("data", "model") mesh over the initialized world (every rank
    calls it alike), or with ``stage > 1`` the reference's ("stage",
    "data", "model") mesh of pipeline stages; ``device`` is this rank's
    device (default the CPU, over gloo) and ``transport`` how the ranks
    talk (see ``distributed.comm``: a CUDA mesh must say ``"nccl"`` or
    ``"host"``)."""
    shape = {"data": data, "model": model}
    if stage > 1:
        shape = {"stage": stage, **shape}
    return build_mesh(shape, transport=transport, device=device)


# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WeightPlan:
    """One weight's partition decision: ``kind`` is the tensor-parallel role
    of the (d_in, d_out) storage (column: d_out over ``axis``; row: d_in
    over ``axis``; replicated; expert), ``fsdp`` the ZeRO-3 axis that
    ``dip_fsdp`` splits K over, ``mesh`` the mesh the decision was made
    against (None for a plan read from a reference checkpoint or weight,
    which carries only its kind and axes)."""

    kind: str = "replicated"
    axis: Optional[str] = None
    fsdp: Optional[str] = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.kind not in ("column", "row", "replicated", "expert"):
            raise ValueError(f"WeightPlan.kind must be column | row | replicated | expert, got {self.kind!r}")

    def axis_size(self, name: Optional[str]) -> int:
        if name is None or self.mesh is None or name not in self.mesh.shape:
            return 1
        return int(self.mesh.shape[name])

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.axis)

    @property
    def fsdp_size(self) -> int:
        return self.axis_size(self.fsdp)

    def describe(self) -> Dict[str, Any]:
        """JSON-safe manifest form (the mesh reduced to its axis sizes), as
        the reference writes it."""
        return {"kind": self.kind, "axis": self.axis, "fsdp": self.fsdp,
                "mesh_axes": None if self.mesh is None else dict(self.mesh.shape)}

    def __repr__(self) -> str:
        parts = [self.kind]
        if self.axis:
            parts.append(f"axis={self.axis}:{self.tp_size}")
        if self.fsdp:
            parts.append(f"fsdp={self.fsdp}:{self.fsdp_size}")
        return f"WeightPlan({', '.join(parts)})"


LAYER_RULES: Dict[str, str] = {
    "embed": "embed",
    "lm_head": "lm_head",
    "final_norm": "replicated",
    "wq": "column", "wk": "column", "wv": "column",
    "w_gate": "column", "w_up": "column",
    "in_proj": "column", "w_dkv": "column", "w_krope": "column",
    "w_uk": "column", "w_uv": "column",
    "shared_w_gate": "column", "shared_w_up": "column",
    "wo": "row", "w_down": "row",
    "out_proj": "row", "shared_w_down": "row",
    "router": "router",
    "bq": "bias_out", "bk": "bias_out", "bv": "bias_out",
    "conv_w": "conv",
    "conv_b": "vector_tp", "norm": "vector_tp",
    "dt_bias": "vector_tp", "A_log": "vector_tp", "D": "vector_tp",
}

_TP_KINDS = {"column": "column", "row": "row"}
# the SSM leaves a rank holds by head under tp (module doc)
_SSM_BY_HEAD = ("conv_w", "conv_b", "norm", "dt_bias", "A_log", "D")


def _rule_for(name: Optional[str], shape: Tuple[int, ...]) -> str:
    if name in ("w_gate", "w_up", "w_down") and len(shape) == 4:
        return "expert_bank"
    return LAYER_RULES.get(name, "replicated")


_WARNED: Set[Tuple] = set()


def _surface_fallback(leaf: str, dim: int, axis: str, size: int, strict: bool) -> None:
    msg = (f"ShardingPlan: leaf {leaf!r} dim {dim} does not divide mesh axis {axis!r}={size}; "
           "replicating instead of sharding")
    if strict:
        raise ValueError(msg + " (strict=True)")
    key = (leaf, dim, axis, size)
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg, UserWarning, stacklevel=3)


# ------------------------------------------------------------ the shards ---
def _slice(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size).clone()


def shard_weight(w, plan: WeightPlan, *, along: str = "tp"):
    """This rank's shard of a whole DiP-stored weight under ``plan``, with
    the plan attached: ``along="tp"`` cuts the storage's N (column; the
    quantized scales with it) or K (row) over the plan's axis (the layout
    ``dip_tp`` and ``dip_sp`` consume); ``along="fsdp"`` cuts K over its
    fsdp axis (``dip_fsdp``).  The logical ``d_in`` / ``d_out`` stay the
    whole weight's.  Leading (layer) dims pass through."""
    if plan.mesh is None:
        raise ValueError("shard_weight needs a WeightPlan with a mesh")
    if along == "tp":
        axis, dim = plan.axis, {"column": -1, "row": -2}.get(plan.kind)
    elif along == "fsdp":
        axis, dim = plan.fsdp, -2
    else:
        raise ValueError(f"along must be 'tp' or 'fsdp', got {along!r}")
    if axis is None or dim is None:
        return w.with_plan(plan)
    parts, idx = plan.mesh.shape[axis], plan.mesh.coord(axis)
    data = _slice(w.data, w.data.dim() + dim, idx, parts)
    if isinstance(w, QuantizedDipWeight):
        scale = _slice(w.scale, w.scale.dim() - 1, idx, parts) if dim == -1 else w.scale.clone()
        return QuantizedDipWeight(data, scale, w.d_in, w.d_out, w.perm_tile, w.scheme, plan=plan)
    return DipWeight(data, w.d_in, w.d_out, w.perm_tile, plan=plan)


# --------------------------------------------------------------------------
@dataclasses.dataclass
class ShardingPlan:
    """Mesh + partition rules + activation constraints for one (mesh,
    config, phase) triple; ``strategy`` comes from ``cfg.sharding`` and
    ``explicit_backend`` names the matmul backend its projections take."""

    mesh: Mesh
    cfg: Any
    mode: str
    strict: bool = False
    fsdp: Optional[str] = None
    tp: Optional[str] = None
    stage: Optional[str] = None   # pipeline stage axis
    stages: int = 1               # pipeline depth (1 = no pipelining)
    _stacked: Optional[frozenset] = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        names = self.mesh.axis_names
        self.fsdp = "data" if "data" in names else None
        self.tp = "model" if "model" in names else None
        self.stage = "stage" if "stage" in names else None
        self.stages = int(self.mesh.shape[self.stage]) if self.stage else 1
        strategy = self.strategy
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown sharding strategy {strategy!r} (cfg.sharding); supported: {STRATEGIES}")
        if strategy == "pp" and self.stages < 2:
            raise ValueError("sharding='pp' needs a mesh with a 'stage' axis of size >= 2 "
                             "(make_local_mesh(stage=...))")
        if strategy not in _RUNS or (strategy == "gspmd" and self.mesh.size > 1):
            what = "implicit gspmd partitioning over more than one rank" if strategy == "gspmd" else \
                f"sharding strategy {strategy!r}"
            raise NotImplementedError(f"{what} is not ported yet ({_DIST})")
        if (strategy == "pp") != (self.stages > 1) or (strategy == "pp" and self.mesh.size != self.stages):
            what = f"pipeline stages beside {dict(self.mesh.shape)}'s data / model axes" if strategy == "pp" \
                else f"a stage axis under the {strategy!r} strategy"
            raise NotImplementedError(f"{what} is not ported yet ({_DIST}); the reference replicates the batch "
                                      "over data there")

    # ---------------------------------------------------------- strategy ---
    @property
    def strategy(self) -> str:
        return getattr(self.cfg, "sharding", "gspmd") or "gspmd"

    @property
    def explicit_backend(self) -> Optional[str]:
        return {"tp": "dip_tp", "fsdp": "dip_fsdp", "sp": "dip_sp", "ep": "dip_ep", "pp": None,
                "gspmd": None}[self.strategy]

    @property
    def expert_plan(self) -> Optional[WeightPlan]:
        """The ``WeightPlan(kind="expert")`` the MoE expert banks dispatch
        on under ``ep`` (the expert dim over the model axis); None
        otherwise, which keeps ``moe_ffn`` on its dense-style path."""
        if self.strategy != "ep" or not self.tp:
            return None
        return WeightPlan(kind="expert", axis=self.tp, fsdp=None, mesh=self.mesh)

    @property
    def tp_size(self) -> int:
        return int(self.mesh.shape[self.tp]) if self.tp else 1

    @property
    def tp_rank(self) -> int:
        return self.mesh.coord(self.tp) if self.tp else 0

    @property
    def fsdp_size(self) -> int:
        return int(self.mesh.shape[self.fsdp]) if self.fsdp else 1

    @property
    def fsdp_rank(self) -> int:
        return self.mesh.coord(self.fsdp) if self.fsdp else 0

    @property
    def stage_rank(self) -> int:
        return self.mesh.coord(self.stage) if self.stage else 0

    def stage_layers(self) -> Tuple[int, int]:
        """(first layer, layers) of this rank's stage: the contiguous
        ``n_layers / stages`` layers of stage s under ``pp``, every layer
        otherwise."""
        n = self.cfg.n_layers
        if self.strategy != "pp":
            return 0, n
        if n % self.stages:
            raise ValueError(f"n_layers={n} does not divide into {self.stages} stages")
        return self.stage_rank * (n // self.stages), n // self.stages

    def stage_stacked(self, name: Optional[str]) -> bool:
        """Whether ``pp`` cuts the leaf ``name`` along its leading (layer)
        axis: a parameter of the template's layer stack (the embedding, the
        final norm and the lm_head stay whole, as do the state's other
        leaves)."""
        if self.strategy != "pp" or name in _STAGE_WHOLE:
            return False
        if self._stacked is None:
            from repro_torch.models.transformer import param_template  # lazy: the model imports this package

            self._stacked = frozenset(param_template(self.cfg).get("layers", {}))
        return name in self._stacked

    def _stage_cut(self, name: str, t: Any) -> Any:
        """This rank's layers of a layer-stacked leaf (a copy) under
        ``pp``; a leaf that already holds them, or is not stacked, passes
        through."""
        if not self.stage_stacked(name) or not isinstance(t, (torch.Tensor, DipWeight, QuantizedDipWeight)):
            return t
        data = t.data if isinstance(t, (DipWeight, QuantizedDipWeight)) else t
        first, n = self.stage_layers()
        if data.shape[0] == n:
            return t
        if data.shape[0] != self.cfg.n_layers:
            raise ValueError(f"{name} holds {data.shape[0]} layers: neither the whole {self.cfg.n_layers} nor this "
                             f"stage's {n}")
        if isinstance(t, QuantizedDipWeight):
            return t.with_data(data.narrow(0, first, n).clone(), t.scale.narrow(0, first, n).clone())
        if isinstance(t, DipWeight):
            return t.with_data(data.narrow(0, first, n).clone())
        return data.narrow(0, first, n).clone()

    def ssm_heads(self) -> Tuple[int, int]:
        """(first head, heads) of this rank's SSM heads: H / T consecutive
        heads under ``tp`` and ``sp`` (the model path requires T to divide
        H), all of them under the other strategies."""
        h = self.cfg.n_ssm_heads
        if self.strategy not in _HEAD_SPLIT or self.tp_size == 1:
            return 0, h
        if h % self.tp_size:
            raise ValueError(f"{h} SSM heads do not divide {self.tp}={self.tp_size}")
        return self.tp_rank * (h // self.tp_size), h // self.tp_size

    def _ssm_local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's heads of an SSM leaf (module doc): the per-head
        vectors by head, ``norm`` by its heads' channels, ``conv_w`` /
        ``conv_b`` by its heads' x channels, then the whole B and C."""
        cfg = self.cfg
        h0, hl = self.ssm_heads()
        if hl == cfg.n_ssm_heads:
            return t
        p, di = cfg.ssm_headdim, cfg.d_inner
        if name in ("dt_bias", "A_log", "D"):
            whole, start, width = cfg.n_ssm_heads, h0, hl
        elif name == "norm":
            whole, start, width = di, h0 * p, hl * p
        else:  # conv_w / conv_b: the [x | B | C] channels
            whole, start, width = di + 2 * cfg.ssm_state, h0 * p, hl * p
        local = width + (whole - di if name in ("conv_w", "conv_b") else 0)
        if t.shape[-1] == local:
            return t
        if t.shape[-1] != whole:
            raise ValueError(f"{name} holds {t.shape[-1]} channels: neither the whole {whole} nor this rank's {local}")
        own = t.narrow(-1, start, width)
        if name in ("conv_w", "conv_b"):
            own = torch.cat([own, t.narrow(-1, di, whole - di)], dim=-1)
        return own.clone()

    # ---------------------------------------------------------- helpers ----
    def _tp_if(self, n: int, leaf: Optional[str] = None) -> Optional[str]:
        return self._axis_if(self.tp, n, leaf)

    def _fsdp_if(self, n: int, leaf: Optional[str] = None) -> Optional[str]:
        return self._axis_if(self.fsdp, n, leaf)

    def _axis_if(self, axis: Optional[str], n: int, leaf: Optional[str]) -> Optional[str]:
        if not axis or axis not in self.mesh.shape:
            return None
        if n % self.mesh.shape[axis] == 0:
            return axis
        if leaf is not None:
            _surface_fallback(leaf, n, axis, self.mesh.shape[axis], self.strict)
        return None

    @property
    def heads_on_tp(self) -> bool:
        """Can attention shard heads over the TP axis (both q and kv)?"""
        cfg = self.cfg
        if not cfg.n_heads or not self.tp:
            return False
        tp = self.mesh.shape[self.tp]
        if self.mode == "decode":
            return cfg.n_kv_heads % tp == 0 and cfg.n_heads % tp == 0
        return cfg.n_heads % tp == 0

    # ------------------------------------------------------------ params ---
    def param_pspec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        """The spec of a template leaf through LAYER_RULES (layer-stacked
        shapes included), as the reference's ``param_pspec``."""
        rule = _rule_for(name, shape)
        stacked = rule not in ("embed", "lm_head") and name != "final_norm" and len(shape) >= 1
        lead = (None,) if stacked else ()
        body = shape[1:] if stacked else shape
        if rule == "embed":
            return (self._tp_if(shape[0], name), self._fsdp_if(shape[1], name))
        if rule == "lm_head":
            combo = tuple(a for a in (self.fsdp, self.tp) if a)
            size = 1
            for a in combo:
                size *= self.mesh.shape[a]
            if combo and shape[1] % size == 0:
                return (None, combo)
            return (self._fsdp_if(shape[0], name), self._tp_if(shape[1], name))
        if rule == "expert_bank":
            return (*lead, self._tp_if(body[0], name), self._fsdp_if(body[1], name), None)
        if rule == "router":
            return (*lead, self._fsdp_if(body[0], name), None)
        if rule in ("column", "row"):
            if len(body) != 2:
                return (*lead, *([None] * len(body)))
            if rule == "column":
                return (*lead, self._fsdp_if(body[0], name), self._tp_if(body[1], name))
            return (*lead, self._tp_if(body[0], name), self._fsdp_if(body[1], name))
        if rule == "bias_out":
            return (*lead, self._tp_if(body[0], name))
        if rule == "conv":
            return (*lead, None, self._tp_if(body[1], name))
        if rule == "vector_tp":
            return (*lead, self._tp_if(body[0], name))
        return (*lead, *([None] * len(body)))

    def weight_plan(self, name: str, storage_shape: Tuple[int, ...], perm_tile: int) -> WeightPlan:
        """The plan of a DiP-stored linear: the sharded storage dim must
        divide the axis into perm-tile-aligned shards, else it replicates
        (warned once, raised under ``strict``); lm_head is column-parallel
        over its (padded) vocab."""
        rule = _rule_for(name, storage_shape)
        kind = _TP_KINDS.get(rule, "column" if rule == "lm_head" else "replicated")
        kp, np_ = int(storage_shape[-2]), int(storage_shape[-1])
        if kind != "replicated" and self.tp:
            tp = self.mesh.shape[self.tp]
            dim = np_ if kind == "column" else kp
            if dim % tp != 0 or (dim // tp) % perm_tile != 0:
                _surface_fallback(name, dim, self.tp, tp, self.strict)
                kind = "replicated"
        fsdp = self.fsdp
        if fsdp and kp % self.mesh.shape[fsdp] != 0:
            _surface_fallback(name, kp, fsdp, self.mesh.shape[fsdp], self.strict)
            fsdp = None
        return WeightPlan(kind=kind, axis=self.tp if kind != "replicated" else None, fsdp=fsdp, mesh=self.mesh)

    def attach_params(self, tree: Any) -> Any:
        """Every ``DipWeight`` / ``QuantizedDipWeight`` node stamped with
        its :class:`WeightPlan` (payloads untouched)."""
        def walk(t, name=None):
            if isinstance(t, dict):
                return {k: walk(v, k) for k, v in t.items()}
            if isinstance(t, (DipWeight, QuantizedDipWeight)):
                return t.with_plan(self.weight_plan(name, tuple(t.data.shape), t.perm_tile))
            return t

        return walk(tree)

    def shard_params(self, params: Any) -> Any:
        """This rank's slice of the parameters (``init_params`` or
        ``params_from_jax`` output) under the ``tp``, ``ep`` or ``fsdp``
        strategy, plans attached, leaf by leaf (:meth:`shard_leaf`).  Leaves
        that already are this rank's slice (``init_params(plan=)``) pass
        through."""
        def walk(t, name=None):
            if isinstance(t, dict):
                return {k: walk(v, k) for k, v in t.items()}
            return self.shard_leaf(name, t)

        return walk(params)

    def experts_local(self, n_experts: int) -> Tuple[int, int]:
        """(first expert, experts) of this rank's slice of an expert bank:
        E / T consecutive experts when E divides the TP axis, else all."""
        tp = self.tp_size
        if n_experts % tp:
            return 0, n_experts
        return self.tp_rank * (n_experts // tp), n_experts // tp

    def _fsdp_cut(self, name: str, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of the MoE leaf ``t`` along ``dim`` (the dim
        :meth:`fsdp_whole` names) over ``data``; a dim that does not divide
        the axis stays whole, as the reference's ``fsdp_if`` replicates it."""
        whole, n = self.fsdp_whole(name), self.fsdp_size
        if n == 1 or whole % n:
            return t
        if t.shape[dim] == whole:
            return _slice(t, dim, self.fsdp_rank, n)
        if t.shape[dim] * n == whole:
            return t
        raise ValueError(f"{name} holds {t.shape[dim]} along dim {dim}: neither the whole {whole} nor this "
                         f"rank's {whole // n}")

    def fsdp_whole(self, name: str) -> int:
        """The whole length of the dim that ``fsdp`` cuts in the MoE leaf
        ``name`` (dim 2 of a bank, dim 1 of the router): d, or ffe for the
        down bank."""
        return self.cfg.d_ff_expert if name == "w_down" else self.cfg.d_model

    def shard_leaf(self, name: str, t: Any) -> Any:
        """This rank's slice of the leaf ``name`` (module doc): a projection
        by its plan (:func:`shard_weight`: along its tensor-parallel split,
        or under ``fsdp`` along K; under ``ep`` the shared experts keep
        their whole storage with the plan attached), an expert bank (L, E,
        ., .) by expert (:meth:`experts_local`; under ``fsdp`` along its
        contraction dim, and the router along d), the embedding's rows by
        vocab (under ``fsdp`` its columns by d), the SSM leaves under
        ``tp`` and ``sp`` by head (:meth:`ssm_heads`), every other leaf
        whole (the biases too: the backend takes its columns).  A slice is
        a copy, so the whole leaf can be freed; a leaf that already is this
        rank's slice (its shape and plan say so) passes through.  Under
        ``pp`` a layer-stacked leaf is cut to the stage's layers and every
        other leaf kept whole (module doc)."""
        if self.strategy == "pp":
            return self._stage_cut(name, t)
        if self.strategy not in _MODEL_PATHS:
            raise NotImplementedError(f"the {self.strategy!r} strategy's model path is not ported yet ({_DIST}); "
                                      f"the model runs under {_MODEL_PATHS}")
        fsdp = self.strategy == "fsdp"
        tp, idx = (self.fsdp_size, self.fsdp_rank) if fsdp else (self.tp_size, self.tp_rank)
        if isinstance(t, (DipWeight, QuantizedDipWeight)):
            whole = tuple(t.data.shape[:-2]) + DipWeight.storage_dims(t.d_in, t.d_out, t.perm_tile)
            wp = self.weight_plan(name, whole, t.perm_tile)
            keep_whole = self.strategy == "ep" and name.startswith("shared_")
            if tuple(t.data.shape) == whole:
                return t.with_plan(wp) if keep_whole else shard_weight(t, wp, along="fsdp" if fsdp else "tp")
            part = list(whole)
            dim = (-2 if wp.fsdp else None) if fsdp else {"column": -1, "row": -2}.get(wp.kind)
            if dim is not None:
                part[dim] //= tp
            if t.plan == wp and tuple(t.data.shape) == tuple(part):
                return t
            raise ValueError(f"{name}: storage {tuple(t.data.shape)} (plan {t.plan}) is neither the whole "
                             f"{whole} nor this rank's slice {tuple(part)} under {wp}")
        rule = _rule_for(name, tuple(t.shape))
        if fsdp and rule in ("expert_bank", "router"):
            return self._fsdp_cut(name, t, 2 if rule == "expert_bank" else 1)
        if rule == "expert_bank":
            e = self.cfg.n_experts
            e0, n = self.experts_local(e)
            if t.shape[1] == e:
                return t.narrow(1, e0, n).clone() if n != e else t
            if t.shape[1] == n:
                return t
            raise ValueError(f"{name} holds {t.shape[1]} experts: neither the whole {e} nor this rank's {n}")
        if name == "embed":
            dim, whole = (1, self.cfg.d_model) if fsdp else (0, self.cfg.padded_vocab)
            what = "columns" if fsdp else "rows"
            if whole % tp:
                raise ValueError(f"embed {what} {whole} do not divide by {self.fsdp if fsdp else self.tp}={tp}")
            if t.shape[dim] == whole:
                return _slice(t, dim, idx, tp)
            if t.shape[dim] * tp == whole:
                return t
            raise ValueError(f"embed has {t.shape[dim]} {what}: neither the whole {whole} nor this rank's "
                             f"{whole // tp}")
        if name == "lm_head":
            raise ValueError("a natural lm_head under a plan: the model path stores its projections "
                             "DiP-permutated (cfg.uses_dip_storage)")
        if name in _SSM_BY_HEAD and self.cfg.ssm_state and self.strategy in _HEAD_SPLIT:
            return self._ssm_local(name, t)
        return t

    # ------------------------------------------------------- whole leaves --
    def _whole_shape(self, name: str, t: torch.Tensor) -> Tuple[int, ...]:
        """The whole leaf's shape of this rank's slice ``t`` of the non-DiP
        leaf ``name`` (:meth:`shard_leaf`'s cuts)."""
        cfg, shape = self.cfg, list(t.shape)
        rule = _rule_for(name, tuple(t.shape))
        fsdp = self.strategy == "fsdp"
        if self.strategy == "pp":
            if self.stage_stacked(name):
                shape[0] = cfg.n_layers
        elif rule == "expert_bank":
            shape[1] = cfg.n_experts
            if fsdp:
                shape[2] = self.fsdp_whole(name)
        elif rule == "router" and fsdp:
            shape[1] = cfg.d_model
        elif name == "embed":
            shape[1 if fsdp else 0] = cfg.d_model if fsdp else cfg.padded_vocab
        elif name in _SSM_BY_HEAD and cfg.ssm_state and self.strategy in _HEAD_SPLIT:
            shape[-1] = {"dt_bias": cfg.n_ssm_heads, "A_log": cfg.n_ssm_heads, "D": cfg.n_ssm_heads,
                         "norm": cfg.d_inner}.get(name, cfg.d_inner + 2 * cfg.ssm_state)
        return tuple(shape)

    def gather_leaf(self, name: str, t: Any, *, to_host: bool = False) -> Any:
        """The whole leaf from every rank's slice ``t`` of the leaf ``name``:
        the inverse of :meth:`shard_leaf` (a ``DipWeight`` keeps its plan).
        One ``comm.all_gather`` along the cut dim for a cut leaf; the Mamba2
        conv leaves under a head split gather their x channels and keep the
        whole B and C; under ``pp`` a layer-stacked leaf gathers its
        stages' layers.  Every rank calls it alike (it is collective).
        ``to_host``: the whole leaf in host memory (a leaf held whole is
        copied there)."""
        from repro_torch.distributed import comm

        if self.strategy not in _MODEL_PATHS + ("pp",):
            raise NotImplementedError(f"the {self.strategy!r} strategy's model path is not ported yet ({_DIST})")
        axis = {"fsdp": self.fsdp, "pp": self.stage}.get(self.strategy, self.tp)
        parts = self.mesh.shape[axis] if axis else 1
        if isinstance(t, (DipWeight, QuantizedDipWeight)):
            if isinstance(t, QuantizedDipWeight):
                raise NotImplementedError(f"{name}: gathering quantized storage is not ported yet ({_DIST})")
            lead = (self.cfg.n_layers,) if self.stage_stacked(name) else tuple(t.data.shape[:-2])
            whole = lead + DipWeight.storage_dims(t.d_in, t.d_out, t.perm_tile)
            return t.with_data(self._gathered(name, t.data, whole, comm, axis, parts, to_host))
        if not isinstance(t, torch.Tensor):
            return t
        whole = self._whole_shape(name, t)
        if name in ("conv_w", "conv_b") and tuple(t.shape) != whole:
            bc = whole[-1] - self.cfg.d_inner  # the whole B and C, held by every rank
            x = comm.all_gather(t[..., :t.shape[-1] - bc].contiguous(), self.mesh, axis, dim=t.dim() - 1,
                                to_host=to_host)
            return torch.cat([x, t[..., t.shape[-1] - bc:].to(x.device)], dim=-1)
        return self._gathered(name, t, whole, comm, axis, parts, to_host)

    def _gathered(self, name, t, whole, comm, axis, parts, to_host):
        if tuple(t.shape) == tuple(whole):
            return t.detach().to("cpu", copy=True) if to_host else t
        dims = [i for i, (a, b) in enumerate(zip(t.shape, whole)) if a != b]
        if len(dims) != 1 or t.shape[dims[0]] * parts != whole[dims[0]]:
            raise ValueError(f"{name}: {tuple(t.shape)} is not one rank's slice of {tuple(whole)} over "
                             f"{axis}={parts}")
        return comm.all_gather(t.contiguous(), self.mesh, axis, dim=dims[0], to_host=to_host)

    def gather_params(self, tree: Any) -> Any:
        """Every leaf of ``tree`` (parameters, or a state holding them and
        their moments) whole on every rank (:meth:`gather_leaf`, leaf by
        leaf in sorted-key order, the same on every rank)."""
        def walk(t, name=None):
            if isinstance(t, dict):
                return {k: walk(t[k], k) for k in sorted(t)}
            return self.gather_leaf(name, t)

        return walk(tree)

    # ------------------------------------------------------------- cache ---
    def paged_cache_pspec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        """Paged serving-cache leaves (L, num_blocks, block_size, ...): the
        block and in-block dims are addresses, never sharded; K/V heads
        shard over TP when they divide it; the MLA latent pools (c_kv,
        k_rope and their scales) stay whole on every rank: the absorbed
        form reads the whole latent for the rank's heads.  The SSM pools
        (L, slots, ...) follow the leaves: ``state``'s heads over TP (a
        rank's H / T heads), and ``conv``'s channel dim over TP, which
        under ``tp`` means the rank's heads' x channels followed by the
        whole B and C (d_inner / T + 2 N channels: the leaves' layout in
        the module doc, not the reference's conv_dim / T block).  Under
        ``fsdp`` (model axis 1) every pool is whole on every rank, and a
        rank writes only the slots it decodes."""
        if name in ("k", "v"):
            return (None, None, None, self.tp, None) if self.heads_on_tp else (None,) * len(shape)
        if name in ("k_scale", "v_scale"):
            return (None, None, None, self.tp) if self.heads_on_tp else (None,) * len(shape)
        if name == "state":
            return (None, None, self._tp_if(shape[2]), None, None)
        if name == "conv":
            return (None, None, None, self._tp_if(shape[3]))
        return (None,) * len(shape)

    # -------------------------------------------------------- activations --
    def constrain(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """The identity: the explicit strategies place every collective by
        hand (the reference's ``with_sharding_constraint`` hints XLA)."""
        return x


def make_plan(mesh: Mesh, cfg, mode: str, *, strict: bool = False) -> ShardingPlan:
    """The plan for one (mesh, config, phase) triple; ``strict`` raises
    where a divisibility fallback would replicate."""
    return ShardingPlan(mesh=mesh, cfg=cfg, mode=mode, strict=strict)
