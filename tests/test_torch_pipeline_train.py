"""The pipelined training step (``distributed.pipeline_train_step_fn``) and
``Trainer(plan=pp)`` over 2 gloo ranks (``_torch_pipeline_ranks.pp_step_rank``,
one world for the file).

* The reference test's configuration (``tests/test_multidevice.py::
  test_pipelined_train_step_matches_flat``: ``pp_t``, 4 layers, d_model 32,
  f32, batch 4 x 16 in 4 microbatches, lr 1e-3, weights from
  ``PRNGKey(2)`` converted with ``params_from_jax``) against the
  reference's flat ``train_step_fn(fused_ce=False)`` on the same batch, at
  that test's bounds: loss rtol 1e-5, ``grad_norm`` rtol 1e-4, every
  parameter after the step (gathered whole) atol 2e-5 / rtol 1e-4.  The
  reference's own test cannot run here (jax 0.9.0 rejects its
  ``shard_map(check_rep=)``, and it wants 4 devices).  Its second step's
  loss is finite; after each step the embedding, the final norm and the
  lm_head are bit-equal on both ranks; each rank holds its stage's 2
  layers; a step's collectives a rank are pinned: 6 ticks' ppermutes
  forward and 4 reverse hops, and 4 psums (the outputs' broadcast, its
  transpose, the whole leaves' shares, the norm).
* The ``ValueError``s of the reference's ``pipeline_train_step_fn``: no
  stage axis, the SSM and MoE families, ``n_layers % stages``,
  ``batch % n_micro``; the rank's draw (``init_params(plan=)``) equal to
  its stage's layers of the whole draw; what stays refused (the vlm and
  audio families, serving under a ``pp`` plan).
* ``Trainer(plan=pp)`` with gradient compression, 3 steps, a checkpoint at
  step 2: resumed on the same mesh (step 3 bit for bit), the checkpoint
  restored under ``pp``, under ``tp`` and on one rank, every leaf (the
  transform's buffers included) bit-equal.
* ``python -m repro_torch.launch.train --mesh local --sharding pp --stages
  2 --compress-grads`` on the CPU against the single-rank
  ``--compress-grads`` launcher.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import transformer as ref_tf
from repro.optim import AdamW as RefAdamW
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import abstract_mesh, make_plan, pipeline_train_step_fn, run_world
from repro_torch.optim import AdamW

import _torch_pipeline_ranks as ranks

PP_T = dict(name="pp_t", family="dense", n_layers=4, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
            head_dim=16, remat="none", compute_dtype="float32")
LR = 1e-3
STEP_COUNTS = dict(psum=4, all_gather=0, reduce_scatter=0, ppermute=10, all_to_all=0, launch=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rcfg = RefArchConfig(**PP_T, matmul_backend="xla", dip_weights=True)
    params = ref_tf.init_params(jax.random.PRNGKey(2), rcfg)
    tok = jax.random.randint(jax.random.PRNGKey(3), (4, 16), 0, rcfg.vocab_size)
    batch = {"tokens": tok, "labels": tok}
    opt = RefAdamW(lr=LR)
    state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    after, m = jax.jit(ref_tf.train_step_fn(rcfg, opt, fused_ce=False))(state, batch)
    case = {"cfg": dict(PP_T, matmul_backend="dip", sharding="pp"), "lr": LR, "n_micro": 4,
            "params": jax.tree_util.tree_map(np.asarray, params),
            "batch": {k: np.asarray(v, np.int64) for k, v in batch.items()}}
    trainer_case = {"cfg": dict(arch="llama3-8b", matmul_backend="dip", **ranks.F32), "steps": 3,
                    "ckpt_dir": str(tmp_path_factory.mktemp("pp_ckpt"))}
    got = run_world(ranks.pp_step_rank, 2, case, trainer_case, timeout=240)
    want = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": [np.asarray(t) for t in jax.tree_util.tree_leaves(after["params"])]}
    return [g[0] for g in got], [g[1] for g in got], want


def test_pipelined_step_matches_the_reference_flat_step(run):
    steps, _, want = run
    for r in steps:
        np.testing.assert_allclose(r["loss"][0], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"][0], want["grad_norm"], rtol=1e-4)
        assert np.isfinite(r["loss"][1])
    assert steps[0]["loss"] == steps[1]["loss"]  # every rank reports the global loss
    assert len(steps[0]["params"]) == len(want["params"])
    for a, b in zip(steps[0]["params"], want["params"]):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


def test_each_stage_holds_its_layers_and_the_whole_leaves_alike(run):
    steps, _, _ = run
    for r in steps:
        assert r["shapes"]["['layers']/['wq']/.data"][0] == 2  # 4 layers over 2 stages
        assert r["shapes"]["['embed']"] == (ArchConfig(**PP_T).padded_vocab, 32)  # whole on every stage
        assert r["counts"] == [STEP_COUNTS, STEP_COUNTS]
    for i in range(2):  # bit-equal replicated leaves on the ranks after each step
        assert steps[0]["replicated"][i] == steps[1]["replicated"][i]
        assert set(steps[0]["replicated"][i]) == {"embed", "final_norm", "lm_head"}


@pytest.mark.parametrize("what", ["no_stage_axis", "ssm", "hybrid", "moe", "layers", "batch"])
def test_the_reference_value_errors(what):
    from repro_torch.configs import get_config

    cfg = ArchConfig(**PP_T, matmul_backend="dip", sharding="pp")
    plan = make_plan(abstract_mesh(stage=2, data=1, model=1), cfg, "train")
    fam = {"ssm": "mamba2-370m", "hybrid": "zamba2-2.7b", "moe": "deepseek-v2-lite-16b"}
    if what == "no_stage_axis":
        tp = dataclasses.replace(cfg, sharding="tp", matmul_backend="dip_tp")
        with pytest.raises(ValueError, match="stage axis of >= 2"):
            pipeline_train_step_fn(tp, AdamW(), make_plan(abstract_mesh(data=1, model=2), tp, "train"), n_micro=2)
    elif what in fam:
        c = dataclasses.replace(get_config(fam[what]).reduced(), sharding="pp")
        with pytest.raises(ValueError, match="dense attention"):
            pipeline_train_step_fn(c, AdamW(), make_plan(abstract_mesh(stage=2, data=1, model=1), c, "train"),
                                   n_micro=2)
    elif what == "layers":
        c = dataclasses.replace(cfg, n_layers=3)
        with pytest.raises(ValueError, match="n_layers=3 does not divide into 2 stages"):
            pipeline_train_step_fn(c, AdamW(), make_plan(abstract_mesh(stage=2, data=1, model=1), c, "train"),
                                   n_micro=2)
    else:  # the batch check runs in the step, before any collective
        from repro_torch.device import make_generator
        from repro_torch.models import transformer as tf_model

        params = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu", plan=plan)
        opt = AdamW()
        step = pipeline_train_step_fn(cfg, opt, plan, n_micro=3)
        tok = torch.zeros((4, 8), dtype=torch.long)
        with pytest.raises(ValueError, match="batch=4 does not divide into 3 pipeline microbatches"):
            step({"params": params, "opt_state": opt.init(params), "step": 0}, {"tokens": tok, "labels": tok})


def test_a_stage_draws_its_layers_of_the_whole_draw():
    from repro_torch import tree
    from repro_torch.device import make_generator
    from repro_torch.distributed import Mesh
    from repro_torch.models import transformer as tf_model

    cfg = ArchConfig(**PP_T, matmul_backend="dip", sharding="pp")
    whole = tf_model.init_params(dataclasses.replace(cfg, sharding="gspmd"), make_generator(0, "cpu"), "cpu")
    for rank in range(2):
        plan = make_plan(Mesh({"stage": 2, "data": 1, "model": 1}, rank=rank), cfg, "train")
        mine = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu", plan=plan)
        assert plan.stage_layers() == (2 * rank, 2)
        for (path, a), b in zip(tree.paths(mine), tree.leaves(plan.shard_params(whole))):
            assert torch.equal(a, b), path
        assert torch.equal(mine["layers"]["w_up"].data, whole["layers"]["w_up"].data[2 * rank:2 * rank + 2])


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "musicgen-medium"])
def test_stages_for_the_stub_frontends_and_serving_under_stages_are_refused(arch):
    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig

    c = dataclasses.replace(get_config(arch).reduced(), sharding="pp")
    with pytest.raises(NotImplementedError, match='ROADMAP.md Queue 1 "Distributed"'):
        pipeline_train_step_fn(c, AdamW(), make_plan(abstract_mesh(stage=2, data=1, model=1), c, "train"), n_micro=2)
    # serving under a pp plan: the reference's engine would run it, the port's model path does not
    cfg = ArchConfig(**PP_T, matmul_backend="dip", sharding="pp")
    plan = make_plan(abstract_mesh(stage=2, data=1, model=1), cfg, "decode")
    params = tf_model.init_params(dataclasses.replace(cfg, sharding="gspmd"), make_generator(0, "cpu"), "cpu")
    with pytest.raises(NotImplementedError, match='ROADMAP.md Queue 1 "Distributed"'):
        Engine(cfg, params, engine_cfg=EngineConfig(slots=1, max_seq=16), device="cpu", plan=plan)


def test_trainer_under_stages_resumes_and_restores_anywhere(run):
    _, drills, _ = run
    for r in drills:
        assert len(r["losses"]) == 3 and np.all(np.isfinite(r["losses"]))
        assert r["resumed_losses"] == r["losses"][2:]  # step 3 only: it resumed from step 2
        for a, b in zip(r["final"], r["resumed_final"]):
            np.testing.assert_array_equal(a, b)
        pp, tp, one = r["restored"]["pp"], r["restored"]["tp"], r["restored"]["one"]
        assert len(pp) == len(tp) == len(one)
        for a, b, c in zip(pp, tp, one):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        # the error-feedback buffers: the stage's 1 of 2 layers under pp, a column half of wq under tp
        assert (1, 128, 128) in r["pp_transform_shapes"] and (2, 128, 64) in r["tp_transform_shapes"]
    assert drills[0]["losses"] == drills[1]["losses"]


def test_launch_train_pp_with_compression_on_cpu(tmp_path, capsys):
    """``--mesh local --sharding pp --stages 2 --compress-grads`` over 2
    gloo ranks against the single-rank ``--compress-grads`` launcher on
    the same seed and batches: the first loss within 1e-3 (bf16 compute
    rounds the stages' microbatches otherwise than the whole batch), the
    later ones within 1e-2 (a compressed gradient that sits at a rounding
    boundary takes the neighbouring int8 code on one side)."""
    import json

    from repro_torch.launch import train

    common = ["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--steps", "3",
              "--compress-grads"]
    single = train.main(common + ["--ckpt-dir", str(tmp_path / "one")])
    staged = train.main(common + ["--ckpt-dir", str(tmp_path / "pp"), "--mesh", "local", "--sharding", "pp",
                                  "--stages", "2", "--microbatches", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["train"]["steps"] == 3
    want = [m["loss"] for m in single["metrics"]]
    got = [m["loss"] for m in staged["metrics"]]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=0)
