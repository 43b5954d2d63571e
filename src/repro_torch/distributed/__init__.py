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
``Trainer(plan=)``).  Not ported yet (ROADMAP.md Queue 1 "Distributed"):
the pipeline stage axis, gradient compression and the production mesh.
"""

from repro_torch.distributed import comm
from repro_torch.distributed.comm import Mesh, abstract_mesh
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
]
