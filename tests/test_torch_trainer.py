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
* ``SyntheticLM(emit_embeddings=)`` (the stub frontends' batches) is
  byte-identical to the reference's.
* The reduced Mamba2 (tied head) and Zamba2 (hybrid) ``Trainer`` runs of 3
  steps from the reference's initial weights give the reference
  ``Trainer``'s losses and gradient norms (``LOSS_TOL``; both on DiP storage,
  the reference on its ``xla`` backend), and a run stopped at step 2 resumes
  from its checkpoint (a tree without ``lm_head``, with ``shared_attn``) and
  repeats step 3 bit for bit.
* ``convert.opt_state_from_jax`` converts the reference's AdamW state over a
  MoE/MLA and a hybrid tree leaf for leaf, bytes and paths.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax

from _torch_parity import TOL, assert_close, family_configs, reduced_configs
from repro.data import SyntheticLM as RefSyntheticLM
from repro.optim import cosine_schedule as ref_cosine
from repro.runtime import Trainer as RefTrainer
from repro.runtime import TrainerConfig as RefTrainerConfig
from repro_torch import api, tree
from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree
from repro_torch.convert import opt_state_from_jax, params_from_jax
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


@pytest.mark.parametrize("d_model", [24, 64])
def test_synthetic_embeddings_are_bit_identical(d_model):
    kw = dict(vocab_size=512, seq_len=24, global_batch=2, seed=1, emit_embeddings=d_model)
    ref, port = RefSyntheticLM(**kw), SyntheticLM(**kw)
    for step in (0, 3):
        a, b = ref.batch(step), port.batch(step)
        assert sorted(a) == sorted(b) == ["embeddings", "labels"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "zamba2-2.7b"])
def test_opt_state_from_jax_over_family_trees(name):
    """The reference's AdamW state (moments in the parameters' tree: the
    plain stacked banks and router, MLA's projections, ``A_log``, the
    hybrid's ``shared_attn``) converts leaf for leaf into the port's."""
    from repro.models import transformer as ref_tf
    from repro.optim import AdamW as RefAdamW
    from repro_torch.optim import AdamW

    ref_cfg, cfg = family_configs(name)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    state = RefAdamW().init(params)
    r = np.random.default_rng(0)
    np_state = jax.tree_util.tree_map(lambda a: r.normal(size=np.shape(a)).astype(np.asarray(a).dtype), state)
    np_state["count"] = np.asarray(3, np.int32)
    conv = opt_state_from_jax(np_state, device="cpu")
    port = AdamW().init(params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu"))
    assert conv["count"] == 3
    for name_ in ("mu", "nu"):
        assert [p for p, _ in tree.paths(conv[name_])] == [p for p, _ in tree.paths(port[name_])]
        for a, b, want in zip(tree.leaves(conv[name_]), tree.leaves(port[name_]),
                              jax.tree_util.tree_leaves(np_state[name_])):
            assert a.shape == b.shape and a.dtype == b.dtype and a.numpy().tobytes() == np.asarray(want).tobytes()


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


@pytest.mark.parametrize("budget", [1, 600])
def test_restore_reads_ahead_within_its_byte_budget(budget, tmp_path, monkeypatch):
    """The leaf files held on the host at once stay within the read-ahead
    budget (one leaf at least) and restore in order, bit for bit."""
    from repro_torch.checkpoint import manager

    g = torch.Generator().manual_seed(1)
    state = {f"l{i}": torch.randn(40 + i, generator=g) for i in range(12)}  # 160-204 bytes a leaf
    save_pytree(str(tmp_path / "ck"), state)
    held, most, lock, load = [0], [0], threading.Lock(), np.load

    def counting_load(f, *a, **kw):
        arr = load(f, *a, **kw)
        with lock:
            held[0] += arr.nbytes
            most[0] = max(most[0], held[0])
        return arr

    real_from_numpy = manager._from_numpy

    def releasing_from_numpy(arr, *a):
        with lock:
            held[0] -= arr.nbytes
        return real_from_numpy(arr, *a)

    monkeypatch.setattr(manager, "_READ_AHEAD_BYTES", budget)
    monkeypatch.setattr(manager.np, "load", counting_load)
    monkeypatch.setattr(manager, "_from_numpy", releasing_from_numpy)
    got = restore_pytree(str(tmp_path / "ck"), {k: torch.zeros_like(v) for k, v in state.items()})
    assert most[0] <= max(budget, 204) + 204  # the budget, or one leaf, beyond the one being copied
    for k in state:
        assert torch.equal(got[k], state[k])


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
    # an ABFT checksum leaf of a DipWeight is placed on the restored weight
    # (test_torch_reliability_abft.py: the reference's checksums verify)
    row = next(e for e in manifest["leaves"] if e["path"] == "['params']/['v']")
    manifest["leaves"].append(dict(row, path="['params']/['w']/.checksum/.row"))
    open(os.path.join(path, "manifest.json"), "w").write(json.dumps(manifest))
    got = restore_pytree(path, _tree())
    assert got["params"]["w"].checksum.col is None and torch.equal(got["params"]["w"].checksum.row,
                                                                  state["params"]["v"])
    # a leaf nothing in the target can take still fails loudly
    manifest["leaves"].append(dict(row, path="['params']/['u']/.checksum/.row"))
    open(os.path.join(path, "manifest.json"), "w").write(json.dumps(manifest))
    with pytest.raises(ValueError, match=r"extra=.*\['u'\]/\.checksum/\.row"):
        restore_pytree(path, state)
    np.save(os.path.join(path, manifest["leaves"][0]["file"]), np.zeros(3, np.float32))
    manifest["leaves"] = manifest["leaves"][:-2]
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


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-2.7b"])
def test_family_trainer_matches_reference_and_resumes(name, tmp_path, capsys):
    ref_cfg, cfg = family_configs(name)
    tk = dict(steps=3, ckpt_every=2, keep=5, log_every=100)
    ref = RefTrainer(ref_cfg, RefTrainerConfig(ckpt_dir=str(tmp_path / "r"), async_ckpt=False, **tk),
                     seq_len=SEQ, global_batch=BATCH)
    want = ref.run()["metrics"]
    start = _reference_start(ref, cfg)
    assert ("lm_head" in start) != cfg.tie_embeddings and ("shared_attn" in start) == cfg.is_hybrid

    def trainer(d, fail_at=None):
        return Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / d), fail_at_step=fail_at, **tk),
                       seq_len=SEQ, global_batch=BATCH, device="cpu")

    full = trainer("a").run(params=tree.map_tree(lambda t: t.clone(), start))
    got = full["metrics"]
    assert [m["step"] for m in got] == [1, 2, 3]
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= LOSS_TOL * max(1.0, abs(b[k])), (k, a, b)
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer("b", fail_at=2).run(params=tree.map_tree(lambda t: t.clone(), start))
    resumed = trainer("b").run()
    assert "resumed from step 2" in capsys.readouterr().out
    assert [m["loss"] for m in resumed["metrics"]] == [got[-1]["loss"]]
    for a, b in zip(tree.leaves(resumed["state"]["params"]), tree.leaves(full["state"]["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


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


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-2.7b", "mamba2-370m", "musicgen-medium"])
def test_launch_train_takes_every_family_on_cpu(arch, tmp_path, capsys):
    """``--arch`` takes the MoE/MLA, hybrid, SSM and stub-frontend families;
    a hybrid's ``--layers`` must close its last shared-block group."""
    from repro_torch.launch import train

    out = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path / "c")])
    assert capsys.readouterr().out.startswith(f"[train] {arch} reduced")
    assert len(out["metrics"]) == 2 and all(np.isfinite(m["loss"]) for m in out["metrics"])
    if arch == "zamba2-2.7b":
        with pytest.raises(ValueError, match="multiple of its attn_every"):
            train.main(["--arch", arch, "--reduced", "--device", "cpu", "--layers", "3", "--ckpt-dir",
                        str(tmp_path / "d")])


def test_trainer_refuses_what_is_not_ported(tmp_path):
    _, cfg = reduced_configs()
    # the guard is ported (test_torch_reliability_guard.py): its state carries the side-car keys
    guarded = Trainer(cfg, TrainerConfig(guard=True, ckpt_dir=str(tmp_path)), device="cpu").init_state()
    assert {"fingerprint", "skipped", "weight_faults"} <= set(guarded)
    # training under a plan runs (test_torch_sharded_train_*.py) but over one
    # axis only: a (data, model) mesh with both above 1 raises, as stages
    # beside a data axis do (test_torch_pipeline_train.py: a stage axis alone)
    from repro_torch.distributed import abstract_mesh, make_plan

    tp = dataclasses.replace(cfg, sharding="tp", matmul_backend="dip_tp")
    pp = dataclasses.replace(cfg, sharding="pp")
    for c, tcfg, mesh in ((tp, TrainerConfig(ckpt_dir=str(tmp_path)), abstract_mesh(data=2, model=2)),
                          (pp, TrainerConfig(pipeline_microbatches=4, ckpt_dir=str(tmp_path)),
                           abstract_mesh(stage=2, data=2, model=1))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(c, tcfg, device="cpu", plan=make_plan(mesh, c, "train"))
    with pytest.raises(ValueError, match="inference-only"):
        Trainer(dataclasses.replace(cfg, quantization="int8"), TrainerConfig(ckpt_dir=str(tmp_path)),
                device="cpu")
