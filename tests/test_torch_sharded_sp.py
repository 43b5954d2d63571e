"""The sequence-parallel (``sp``) model path over a 2-rank gloo world (data 1
x model 2) against the reference's single-device model, on the reference's
parameters (``params_from_jax``): the dense and ssm families here, the
hybrid in ``test_torch_sharded_sp_hybrid.py`` (cases and checks in
``_torch_sp_checks.py``).

The configs are the reduced ones with the overrides of the reference's
fleet ``sp`` cells (``benchmarks/fleet.py`` ``cell_config``: f32 compute,
``dip_sp``, ``sharding="sp"``); the reference runs single-device on the
same DiP storage (``dip_weights=True``).  The cases:

* ``llama3``: the reduced llama3-8b (``wk`` / ``wv`` replicate at 64 / 2
  columns: each gives the rank's rows, then one all-gather of rows);
* ``mamba2``: the reduced Mamba2, ``in_proj`` replicated, its tied head
  multiplying every row (one all-gather of rows) by the rank's vocab rows;
* (the hybrid file) ``zamba2``: the reduced Zamba2, ``in_proj``
  replicated, and ``zamba2_col``: with ``ssm_state=32``, ``in_proj``
  column-parallel (one ring hop, then the gather of columns).

Each rank holds its block of the flattened B S rows of the residual
stream, padded to 2 m rows: a batch of 1 x 1, 1 x 3 or 1 x 5 tokens leaves
rank 1 a pad row.  Held: layer 0's block on the rank's rows (the dense
block on a 2 x 12 chunk; the Mamba2 block's 40-token chunked prefill into
a cache and one O(1) decode token: the rank's heads of the state and their
conv channels), the logits at M = 1, 3, 5 and a 2 x 12 chunk, the exact
collective and launch counts, the replicated dispatches counted, the
schedule of one dense block (each ring hop before its launch, each
reduce-scatter after its launch), the ``Engine``'s greedy tokens on prompts
that leave a 3-token SSM tail, the pools (``tp``'s: H / T heads); with no
world, the ``sp`` plan through ``params_from_jax``, ``tree`` and a
checkpoint, and what stays refused.  Tolerance, of max(1,
max|reference|): the block ``TOL["float32"]`` (1e-5), the logits
``MODEL_TOL`` (1e-4), as the ``tp`` tests hold them: the reduce-scatter
sums the same partials in the same order as ``tp``'s all-reduce, so the
f32 results equal ``tp``'s on the CPU bit for bit at M >= 2 (at M = 1 the
row launch runs the two padded rows where ``tp`` runs one, and the CPU's
one-row product sums in another order: 1e-6 apart).
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_sp_checks as checks
from repro.configs import get_config as ref_config
from repro.distributed.plan import make_plan as ref_make_plan
from repro.models import transformer as ref_model

from repro_torch import tree
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import WeightPlan, abstract_mesh, make_plan
from repro_torch.models import transformer as tf_model

NAMES = ("llama3", "mamba2")


@pytest.fixture(scope="module")
def served():
    return checks.serve(NAMES, 30)


@pytest.mark.parametrize("name", NAMES)
def test_block_under_sp_matches_the_reference(served, name):
    checks.check_block(served, name)


def test_dense_block_schedule_hops_before_launches_reduce_scatter_after(served):
    col = ["ppermute", "launch", "launch"]  # dip_sp column: the hop issued before the launch it overlaps
    row = ["launch", "reduce_scatter"]      # dip_sp row: the reduce-scatter after the launch
    for out in served[1]:
        # wq column; wk and wv replicated (each the rank's rows, then one
        # all-gather of rows); wo row; gate+up column; w_down row
        assert out["llama3"]["block_schedule"] == col + ["all_gather", "all_gather"] + row + col + row


@pytest.mark.parametrize("name", NAMES)
def test_forward_under_sp_matches_the_reference(served, name):
    checks.check_forward(served, name)


@pytest.mark.parametrize("name", NAMES)
def test_engine_under_sp_serves_the_reference_tokens(served, name):
    checks.check_engine(served, name)


@pytest.mark.parametrize("name", NAMES)
def test_pools_are_the_tp_pools(served, name):
    checks.check_pools(served, name)


def _sp_cfg(arch="llama3-8b", **kw):
    return dataclasses.replace(get_config(arch).reduced(), **checks.SP, **kw)


def test_sp_plan_rides_through_convert_tree_and_checkpoint(tmp_path):
    """The reference's ``sp`` plan on its weights reaches ``params_from_jax``;
    ``shard_params`` under ``sp`` cuts exactly as under ``tp``; the rank's
    slice passes through ``tree`` and a checkpoint, whose restore refuses
    a target planned otherwise."""
    rcfg = dataclasses.replace(ref_config("zamba2_2_7b").reduced(), sharding="sp", matmul_backend="dip_sp",
                               **checks.F32)
    rplan = ref_make_plan(AbstractMesh((1, 2), ("data", "model")), rcfg, "decode")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rparams = rplan.attach_params(ref_model.init_params(jax.random.PRNGKey(0), rcfg))
    cfg = _sp_cfg("zamba2-2.7b")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), cfg, device="cpu")
    assert params["shared_attn"]["wq"].plan == WeightPlan("column", axis="model", fsdp="data")
    assert params["layers"]["out_proj"].plan == WeightPlan("row", axis="model", fsdp="data")
    mesh = abstract_mesh(data=1, model=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        local = make_plan(mesh, cfg, "decode").shard_params(params)
        tp_cfg = dataclasses.replace(cfg, sharding="tp", matmul_backend="dip_tp")
        tp_local = make_plan(mesh, tp_cfg, "decode").shard_params(params)
    for a, b in zip(tree.leaves(local), tree.leaves(tp_local)):
        assert torch.equal(a, b)
    assert local["layers"]["A_log"].shape == (cfg.n_layers, cfg.n_ssm_heads // 2)
    wq = local["shared_attn"]["wq"]
    assert wq.plan.kind == "column" and wq.data.shape[-1] * 2 == params["shared_attn"]["wq"].data.shape[-1]
    back = tree.unflatten(local, tree.leaves(local))
    assert back["layers"]["out_proj"].plan == local["layers"]["out_proj"].plan
    path = str(tmp_path / "ck")
    save_pytree(path, local)
    got = restore_pytree(path, tree.unflatten(local, [torch.zeros_like(t) for t in tree.leaves(local)]))
    assert got["shared_attn"]["wo"].plan == local["shared_attn"]["wo"].plan
    assert torch.equal(got["layers"]["out_proj"].data, local["layers"]["out_proj"].data)
    bad = WeightPlan("replicated", mesh=wq.plan.mesh)
    with pytest.raises(ValueError, match="ShardingPlan mismatch"):
        restore_pytree(path, dict(local, shared_attn=dict(local["shared_attn"], wq=wq.with_plan(bad))))


def test_what_sp_leaves_unported_still_raises():
    mesh = abstract_mesh(data=1, model=2)
    moe = _sp_cfg("deepseek-v2-lite-16b")
    with pytest.raises(NotImplementedError, match="Distributed"):  # the moe family under sp
        tf_model.param_template(moe)
    with pytest.raises(NotImplementedError, match="Distributed"):
        tf_model.paged_decode_step_fn(dataclasses.replace(moe, sharding="gspmd"),
                                      plan=make_plan(mesh, _sp_cfg("qwen3-moe-235b-a22b"), "decode"))
    odd = _sp_cfg(n_heads=3, n_kv_heads=1, head_dim=32)  # heads that do not divide the axis
    with pytest.raises(NotImplementedError, match="do not divide the TP axis"):
        tf_model.decode_step_fn(odd, plan=make_plan(mesh, odd, "decode"))
    dense = _sp_cfg()
    with pytest.raises(NotImplementedError, match="fused lm_head"):  # sp trains through the unfused loss only
        tf_model.loss_fn({}, dense, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, fused_ce=True,
                         plan=make_plan(mesh, dense, "train"))
