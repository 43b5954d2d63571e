"""The sharded backends' backward and the differentiable collectives
(``distributed.comm``), on a 2-rank gloo world, against single-rank
gradients; what training under a plan still refuses; the training
launcher over 2 ranks.

Every collective has a backward that is its transpose, on the same group
and logged under its own name (``psum`` <-> ``psum``, ``all_gather`` <->
``reduce_scatter``, ``all_to_all`` <-> the inverse exchange, a ring hop
<-> the hop the other way round), under the convention that a rank's
cotangent of a value every rank holds alike is its share of it (a
replicated loss is differentiated as ``loss / ranks``; a whole leaf's
shares are summed after the backward).  Each case is a function of whole
inputs that the ranks compute together: the rank's gradient of its own
slice (or the psum of its share of a whole input) must equal the
single-rank gradient of that slice, each way a collective is used (a sum
used whole by every rank; a replicated input entering rank-specific work;
a gathered whole used by every rank, along dim 0 and the last dim; a
reduce-scatter's rows; an exchange; a ring hop).

The backends: ``dip_tp`` column and row, ``dip_fsdp``, ``dip_sp`` column
and row, each with the epilogues none, bias, residual and swiglu, with and
without the rmsnorm prologue (the row paths' psum of sums of squares, the
row partials' ``FusedDispatch``), in f32, against the single-rank
``api.matmul`` gradients of x, each weight's DiP storage, the gain and the
bias or residual, cut as the rank's operands are (1e-5 of the largest
gradient), with the backward's collectives pinned.
"""

import numpy as np
import pytest

from repro_torch.distributed import run_world

import _torch_sharded_ranks as ranks

COLLECTIVES = {  # name -> the backward's collectives
    "psum": {"psum": 1},
    "psum_of_replicated": {"psum": 1},
    "all_gather_0": {"reduce_scatter": 1},
    "all_gather_1": {"reduce_scatter": 1},
    "psum_scatter": {"all_gather": 1, "psum": 1},  # the loss's psum, then the scatter's transpose
    "all_to_all": {"all_to_all": 1, "psum": 1},
    "hop": {"ppermute": 1, "psum": 1},
}
PATHS = ("tp_col", "tp_row", "fsdp", "sp_col", "sp_row")
EPILOGUES = ("none", "bias", "residual", "swiglu")
CASES = [dict(path=p, epilogue=e, rmsnorm=r) for p in PATHS for e in EPILOGUES for r in (False, True)]


def _backward_counts(path, epilogue, rmsnorm):
    """The backward's collectives of one dispatch (its loss's psum
    included, where the rank's output is a slice)."""
    pair = 2 if epilogue == "swiglu" else 1
    want = {"tp_col": {"psum": 1}, "tp_row": {"psum": 1 + rmsnorm}, "fsdp": {"psum": 1, "reduce_scatter": pair},
            "sp_col": {"psum": 1, "ppermute": 1}, "sp_row": {"psum": 1 + rmsnorm, "all_gather": pair}}[path]
    return want


@pytest.fixture(scope="module")
def world():
    return run_world(ranks.train_grad_rank, 2, list(COLLECTIVES), CASES, timeout=300)


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_each_collective_backward_is_the_single_rank_gradient(world, name):
    for coll, _ in world:
        got, want, counts = coll[name]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert {k: v for k, v in counts.items() if v} == COLLECTIVES[name], counts


def _case_id(c):
    return f"{c['path']}-{c['epilogue']}-{'rms' if c['rmsnorm'] else 'plain'}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_backend_gradients_match_the_single_rank_dispatch(world, case):
    i = CASES.index(case)
    for _, back in world:
        pairs, _, bwd = back[i]
        n_want = 2 + (case["epilogue"] == "swiglu") + case["rmsnorm"] + (case["epilogue"] in ("bias", "residual"))
        assert len(pairs) == n_want
        for got, want in pairs:
            assert got.shape == want.shape
            err = float(np.abs(got - want).max())
            assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err
        assert {k: v for k, v in bwd.items() if v} == _backward_counts(**case), bwd


# ----------------------------------------------------------- refusals ---
def _cfg(**over):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3-8b").reduced(), compute_dtype="float32", param_dtype="float32",
                               **over)


def _tp(cfg):
    import dataclasses

    return dataclasses.replace(cfg, sharding="tp", matmul_backend="dip_tp")


def test_a_train_plan_whose_kv_heads_do_not_split_is_refused():
    from repro_torch.distributed import abstract_mesh, make_plan
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    cfg = _tp(_cfg(n_heads=4, n_kv_heads=1))
    plan = make_plan(abstract_mesh(data=1, model=2), cfg, "train")
    assert plan.heads_on_tp  # a train plan reads the query heads only
    with pytest.raises(NotImplementedError, match='do not divide the TP axis.*ROADMAP.md Queue 1 "Distributed"'):
        tf_model.train_step_fn(cfg, AdamW(), plan=plan)


def test_training_over_both_axes_of_a_mesh_is_refused():
    from repro_torch.distributed import abstract_mesh, make_plan
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    cfg = _tp(_cfg())
    with pytest.raises(NotImplementedError, match='both axes above 1.*"Distributed"'):
        tf_model.train_step_fn(cfg, AdamW(), plan=make_plan(abstract_mesh(data=2, model=2), cfg, "train"))


def test_pipeline_stages_and_gspmd_over_ranks_are_refused():
    import dataclasses

    from repro_torch.distributed import abstract_mesh, make_local_mesh, make_plan
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg()
    pp = dataclasses.replace(cfg, sharding="pp")
    # stages train over a stage axis alone (test_torch_pipeline_train.py): beside a data or model axis
    # above 1 they stay refused, as a stage axis under another strategy is
    for axes in (dict(data=1, model=2), dict(data=2, model=1)):
        with pytest.raises(NotImplementedError, match='"Distributed"'):
            make_plan(abstract_mesh(stage=2, **axes), pp, "train")
    with pytest.raises(NotImplementedError, match='stage axis.*"Distributed"'):
        Trainer(_tp(cfg), TrainerConfig(pipeline_microbatches=4), device="cpu",
                plan=make_plan(abstract_mesh(stage=2, data=1, model=1), _tp(cfg), "train"))
    with pytest.raises(NotImplementedError, match="gspmd"):
        make_plan(abstract_mesh(data=1, model=2), cfg, "train")
    with pytest.raises(RuntimeError, match="torch.distributed initialized"):
        make_local_mesh(stage=2)  # a live stage mesh needs a world (run_world)


def test_the_trainer_pairs_a_plan_with_its_sharded_backend():
    from repro_torch.distributed import abstract_mesh, make_plan
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg(matmul_backend="dip")
    tp = _tp(cfg)
    plan = make_plan(abstract_mesh(data=1, model=2), tp, "train")
    with pytest.raises(ValueError, match="sharded backend"):
        Trainer(tp, TrainerConfig(), device="cpu")
    with pytest.raises(ValueError, match="sharded backend"):
        Trainer(cfg, TrainerConfig(), plan=plan, device="cpu")
    t = Trainer(tp, TrainerConfig(), policy=plan, device="cpu")  # the reference's deprecated alias
    assert t.plan is plan and t.mesh is plan.mesh


def test_the_moe_family_under_sp_and_the_fused_loss_under_a_plan_are_refused():
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import abstract_mesh, make_plan
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    mesh = abstract_mesh(data=1, model=2)
    moe = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(), sharding="sp", matmul_backend="dip_sp")
    with pytest.raises(NotImplementedError, match='"Distributed"'):
        tf_model.train_step_fn(moe, AdamW(), plan=make_plan(mesh, moe, "train"))
    cfg = _tp(_cfg())
    with pytest.raises(NotImplementedError, match="fused lm_head"):
        tf_model.loss_fn({}, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, fused_ce=True,
                         plan=make_plan(mesh, cfg, "train"))


@pytest.mark.parametrize("flags,error", [
    # pp and --compress-grads train (test_torch_pipeline_train.py); the vlm and audio families'
    # stages, with or without compression, and a stage axis under tp stay refused
    (["--mesh", "local", "--sharding", "pp", "--stages", "2", "--arch", "phi-3-vision-4.2b"], NotImplementedError),
    (["--mesh", "local", "--sharding", "tp", "--stages", "2"], NotImplementedError),
    (["--mesh", "local", "--sharding", "pp", "--stages", "2", "--compress-grads", "--arch", "musicgen-medium"],
     NotImplementedError),
    (["--mesh", "single", "--sharding", "tp"], NotImplementedError),
    (["--mesh", "local", "--sharding", "gspmd"], NotImplementedError),
    (["--sharding", "tp"], ValueError),
], ids=["pp", "stages", "compress", "production_mesh", "gspmd_over_ranks", "no_mesh"])
def test_launch_train_refuses_what_the_slice_does_not_train(flags, error):
    from repro_torch.launch import train

    with pytest.raises(error, match="ROADMAP|--mesh local"):
        train.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--steps", "1"] + flags)


def test_launch_train_mesh_local_tp_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu --mesh
    local --sharding tp`` over 2 gloo ranks: the losses of the single-rank
    launcher on the same seed and batches, within 1e-3 of them (the
    launcher computes in bf16, whose rounding the ranks' other summation
    order moves by ~3e-4; the unfused loss under the plan, the fused
    kernel's plain version without), and a resume from its step-2
    checkpoint repeating step 3's loss bit for bit."""
    import json

    from repro_torch.launch import train

    common = ["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--ckpt-every", "2"]
    single = train.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "one")])
    sharded = train.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "tp"), "--mesh", "local",
                                   "--sharding", "tp"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["train"]["steps"] == 3
    want = [m["loss"] for m in single["metrics"]]
    got = [m["loss"] for m in sharded["metrics"]]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)
    resumed = train.main(common + ["--steps", "4", "--ckpt-dir", str(tmp_path / "tp"), "--mesh", "local",
                                   "--sharding", "tp"])
    assert [m["step"] for m in resumed["metrics"]] == [3, 4]  # resumed from step 2 (the ranks print it)
    assert resumed["metrics"][0]["loss"] == got[2]
