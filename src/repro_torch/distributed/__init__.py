"""The explicit distributed layer (port of ``repro.distributed``): the
``ShardingPlan`` and its per-weight ``WeightPlan`` metadata, the mesh and
its collectives over ``torch.distributed`` (``comm``), and ``run_world``,
which spawns a world of ranks on this host.

One process per rank, each holding its shard (local view): ``make_plan``
builds the plan, ``plan.shard_params`` cuts whole parameters to the rank's
slice with the plans attached, and the ``dip_tp`` / ``dip_fsdp`` /
``dip_sp`` / ``dip_ep`` matmul backends (``kernels/dip_matmul_sharded.py``)
dispatch on them; under ``ep`` the MoE layer exchanges tokens with
``comm.all_to_all`` (``models/moe.py``).  The collectives are
differentiable, so every path also trains (``train_step_fn(plan=)``,
``Trainer(plan=)``).  ``pipeline`` runs the dense family's layer stack
over a ``stage`` axis (the overlapped GPipe schedule,
``pipeline_train_step_fn``), and ``compression`` quantizes gradients to
int8 with error feedback (``compression_transform`` for
``AdamW(grad_transform=)``, ``compressed_psum``).  Not ported yet
(ROADMAP.md Queue 1 "Distributed"): the production mesh and the plans that
section lists.
"""

from repro_torch.distributed import comm
from repro_torch.distributed.comm import Mesh, abstract_mesh
from repro_torch.distributed.compression import compressed_psum, compression_transform
from repro_torch.distributed.pipeline import pipeline_apply, pipeline_train_step_fn
from repro_torch.distributed.plan import (
    LAYER_RULES,
    STRATEGIES,
    ShardingPlan,
    WeightPlan,
    make_local_mesh,
    make_plan,
    shard_weight,
)
from repro_torch.distributed.world import run_world

__all__ = [
    "comm",
    "Mesh",
    "abstract_mesh",
    "LAYER_RULES",
    "STRATEGIES",
    "ShardingPlan",
    "WeightPlan",
    "make_local_mesh",
    "make_plan",
    "shard_weight",
    "run_world",
    "pipeline_apply",
    "pipeline_train_step_fn",
    "compression_transform",
    "compressed_psum",
]
