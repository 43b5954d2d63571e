"""The port's data stream, checkpoints and ``Trainer`` against the JAX
reference on the CPU.

* ``SyntheticLM`` batches are bit-identical to the reference's.
* A port ``Trainer`` run of 4 steps on the reduced llama3-8b (f32, ``dip``),
  started from the reference's initial weights, gives the reference
  ``Trainer``'s losses and gradient norms.  Tolerance 1e-4 of
  max(1, |reference|): each step's parameters differ by the f32 rounding of
  the step before, which AdamW's m/(sqrt(n) + eps) can amplify where a
  gradient is near 0 (``test_torch_train.py`` holds one step to 1e-5).
* A checkpoint written by the reference ``Trainer`` restores in the port
  (same paths, dtypes and crc32), and the next step's loss matches (1e-5 of
  max(1, |reference|): the same weights, batch and optimizer state).
* ``fail_at_step`` then auto-resume continues bit-exactly.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from _torch_parity import TOL, assert_close, reduced_configs
from repro.data import SyntheticLM as RefSyntheticLM
from repro.optim import cosine_schedule as ref_cosine
from repro.runtime import Trainer as RefTrainer
from repro.runtime import TrainerConfig as RefTrainerConfig
from repro_torch import api, tree
from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree
from repro_torch.convert import params_from_jax
from repro_torch.data import DataState, SyntheticLM
from repro_torch.optim import cosine_schedule
from repro_torch.runtime import Trainer, TrainerConfig

LOSS_TOL = 1e-4
SEQ, BATCH = 16, 2


@pytest.mark.parametrize("seed,shard", [(0, 0), (3, 1)])
def test_synthetic_batches_are_bit_identical(seed, shard):
    kw = dict(vocab_size=512, seq_len=40, global_batch=4, seed=seed, shard_index=shard, num_shards=2)
    ref, port = RefSyntheticLM(**kw), SyntheticLM(**kw)
    for step in (0, 1, 17):
        a, b = ref.batch(step), port.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    port.start(DataState(step=5))
    try:
        step, item = next(iter(port))
    finally:
        port.stop()
    assert step == 5
    np.testing.assert_array_equal(item["tokens"], ref.batch(5)["tokens"])


def test_schedules_match_reference():
    import jax.numpy as jnp

    for s in (0, 1, 5, 10, 11, 57, 100, 150):
        assert float(cosine_schedule(3e-4, 10, 100)(s)) == pytest.approx(
            float(ref_cosine(3e-4, 10, 100)(jnp.asarray(s, jnp.int32))), rel=1e-6)


def _tree():
    g = torch.Generator().manual_seed(0)
    w = api.DipWeight.from_natural(torch.randn(100, 70, generator=g))
    return {"params": {"w": w, "b16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
                       "v": torch.randn(7, generator=g)},
            "step": 4, "norm": torch.tensor(1.5)}


def test_checkpoint_roundtrip_and_manager(tmp_path):
    state = _tree()
    save_pytree(str(tmp_path / "one"), state, meta={"x": 1})
    like = tree.map_tree(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else 0, state)
    got = restore_pytree(str(tmp_path / "one"), like)
    for a, b in zip(tree.leaves(got), tree.leaves(state)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert a == b
    assert isinstance(got["params"]["w"], api.DipWeight) and got["params"]["w"].d_in == 100
    manifest = json.loads((tmp_path / "one" / "manifest.json").read_text())
    assert manifest["dip_weights"] == {"['params']/['w']": {"d_in": 100, "d_out": 70, "perm_tile": 64}}
    assert {e["path"]: e["dtype"] for e in manifest["leaves"]}["['params']/['b16']"] == "bfloat16"

    os.makedirs(tmp_path / "mgr" / "step_00000007.tmp-dead")
    mgr = CheckpointManager(str(tmp_path / "mgr"), keep=2)
    assert mgr.latest_step() is None and not any(".tmp-" in n for n in os.listdir(tmp_path / "mgr"))
    for s in (1, 2, 3):
        mgr.save(s, state, blocking=(s != 3))
    mgr.wait()
    assert mgr.steps() == [2, 3]
    _, meta = mgr.restore(like)
    assert meta["step"] == 3


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    state = _tree()
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, state, blocking=False)
    state["params"]["v"].add_(100.0)  # the trainer updates parameters in place
    mgr.wait()
    got, _ = mgr.restore(_tree())
    torch.testing.assert_close(got["params"]["v"], _tree()["params"]["v"], rtol=0, atol=0)


def test_restore_fails_loudly_on_what_it_cannot_place(tmp_path):
    state = _tree()
    path = str(tmp_path / "ck")
    save_pytree(path, state)
    with pytest.raises(ValueError, match="mismatch"):
        restore_pytree(path, {"params": state["params"], "step": 0})
    bad = dict(state, params=dict(state["params"], v=torch.zeros(8)))
    with pytest.raises(ValueError, match="v"):
        restore_pytree(path, bad)
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    manifest["leaves"].append(dict(manifest["leaves"][0], path="['params']/['w']/.checksum/.row"))
    open(os.path.join(path, "manifest.json"), "w").write(json.dumps(manifest))
    with pytest.raises(ValueError, match="checksum"):
        restore_pytree(path, state)
    np.save(os.path.join(path, manifest["leaves"][0]["file"]), np.zeros(3, np.float32))
    manifest["leaves"].pop()
    open(os.path.join(path, "manifest.json"), "w").write(json.dumps(manifest))
    with pytest.raises(ValueError, match="integrity"):
        restore_pytree(path, state)


# ------------------------------------------------------------ the trainer --
def _trainers(ckpt_ref, ckpt_port, steps, **kw):
    ref_cfg, cfg = reduced_configs("pallas_dip", "dip")
    tk = dict(steps=steps, ckpt_every=2, keep=5, async_ckpt=False, log_every=100, **kw)
    ref = RefTrainer(ref_cfg, RefTrainerConfig(ckpt_dir=ckpt_ref, **tk), seq_len=SEQ, global_batch=BATCH)
    port = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt_port, **tk), seq_len=SEQ, global_batch=BATCH,
                   device="cpu")
    return ref, port, cfg


def _reference_start(ref, cfg):
    np_params = jax.tree_util.tree_map(np.asarray, ref.init_state(0)["params"])
    return params_from_jax(np_params, cfg, device="cpu")


def test_trainer_losses_match_reference(tmp_path):
    ref, port, cfg = _trainers(str(tmp_path / "r"), str(tmp_path / "p"), steps=4)
    want = ref.run()["metrics"]
    got = port.run(params=_reference_start(ref, cfg))["metrics"]
    assert [m["step"] for m in got] == [1, 2, 3, 4]
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= LOSS_TOL * max(1.0, abs(b[k])), (k, a, b)
        assert a["step_time_s"] > 0 and "stragglers" in a
    assert got[-1]["loss"] < got[0]["loss"]


def test_reference_checkpoint_restores_in_the_port(tmp_path, capsys):
    ckpt = str(tmp_path / "shared")
    ref, _, cfg = _trainers(ckpt, str(tmp_path / "unused"), steps=2)
    ref.run()  # writes step 2
    ref3, port3, _ = _trainers(str(tmp_path / "ref3"), ckpt, steps=3)
    want = ref3.run()["metrics"][-1]  # the uninterrupted reference's step 3
    got = port3.run()["metrics"]
    assert "resumed from step 2" in capsys.readouterr().out
    assert [m["step"] for m in got] == [3]
    assert_close(np.float32(got[0]["loss"]), np.float32(want["loss"]), TOL["float32"])
    assert_close(np.float32(got[0]["grad_norm"]), np.float32(want["grad_norm"]), TOL["float32"])


def test_fail_at_step_then_resume_is_bit_exact(tmp_path):
    _, cfg = reduced_configs("pallas_dip", "dip")

    def trainer(d, fail_at=None):
        return Trainer(cfg, TrainerConfig(steps=5, ckpt_every=2, ckpt_dir=str(tmp_path / d), keep=5,
                                          async_ckpt=True, fail_at_step=fail_at, log_every=100),
                       seq_len=SEQ, global_batch=BATCH, device="cpu")

    full = trainer("a").run()
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer("b", fail_at=3).run()
    resumed = trainer("b").run()
    assert [m["step"] for m in resumed["metrics"]] == [3, 4, 5]
    assert [m["loss"] for m in resumed["metrics"]] == [m["loss"] for m in full["metrics"][2:]]
    for a, b in zip(tree.leaves(resumed["state"]), tree.leaves(full["state"])):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert a == b


def test_launch_train_on_cpu_and_not_without_a_card(tmp_path, capsys):
    from repro_torch.launch import train

    out = train.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                      "--seq", "16", "--ckpt-dir", str(tmp_path / "c"), "--layers", "1"])
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("[train] llama3-8b reduced: 1 layers")
    assert len(out["metrics"]) == 3 and all(np.isfinite(m["loss"]) for m in out["metrics"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "llama3-8b", "--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "d")])


def test_trainer_refuses_what_is_not_ported(tmp_path):
    _, cfg = reduced_configs()
    for tcfg, kw in ((TrainerConfig(guard=True, ckpt_dir=str(tmp_path)), {}),
                     (TrainerConfig(ckpt_dir=str(tmp_path)), {"plan": object()}),
                     (TrainerConfig(pipeline_microbatches=4, ckpt_dir=str(tmp_path)), {})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(cfg, tcfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="inference-only"):
        Trainer(dataclasses.replace(cfg, quantization="int8"), TrainerConfig(ckpt_dir=str(tmp_path)),
                device="cpu")
