"""The port's training guard (``repro_torch.reliability.guard``,
``train_step_fn(guard=True)``, ``Trainer(guard=True)``) against the JAX
reference on the CPU.

* ``fingerprint`` equals the reference's within the guard's own tolerance
  (``_FP_RTOL`` 1e-5, ``_FP_ATOL`` 1e-6: f32 sums in another order) on the
  reduced llama3-8b's DiP parameters, and ``fingerprint_paths`` equals its
  paths; ``locate_fingerprint_fault`` names the leaf the reference names.
* ``guarded_step_fn``: the reference's unit drill (a step that returns new
  tensors, selected per leaf).
* ``train_step_fn(guard=True)``: a weight fault and a loss-only fault skip
  the update and leave the parameters and the optimizer state (``count``
  and ``grad_norm`` included) as they were; ``step`` advances.
* The guarded tiny ``Trainer`` (the reference test's ``ArchConfig``) against
  the reference ``Trainer`` with the same hook, from the same weights: a
  NaN planted mid-run (and a flipped exponent bit in a DiP weight) is
  detected, the step skipped, the latest checkpoint restored and the run
  finished; ``skipped``, ``weight_faults`` and ``recoveries`` equal the
  reference's and the losses match within ``LOSS_TOL`` (1e-4 of max(1,
  |reference|), as ``test_torch_trainer.py`` holds the trainers; a skipped
  step's NaN loss is NaN on both sides).  Without a checkpoint it raises
  "weight corruption"; a clean guarded run equals the unguarded run loss
  for loss, bit for bit, and resumes from its checkpoint bit-exactly with
  the guard's keys.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import reduced_configs, reference_params
from repro import reliability as ref_rel
from repro.configs.base import ArchConfig as RefArchConfig
from repro.runtime import Trainer as RefTrainer
from repro.runtime import TrainerConfig as RefTrainerConfig
from repro_torch import reliability as rel
from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.data import SyntheticLM
from repro_torch.models import transformer as tf_model
from repro_torch.optim import AdamW
from repro_torch.reliability.guard import _FP_ATOL, _FP_RTOL
from repro_torch.runtime import Trainer, TrainerConfig

LOSS_TOL = 1e-4
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=128, head_dim=16, remat="none", compute_dtype="float32")
SEQ, BATCH = 32, 4


def test_fingerprint_and_paths_match_reference():
    ref_cfg, cfg = reduced_configs("pallas_dip", "dip")
    params, np_params = reference_params(ref_cfg)
    tparams = params_from_jax(np_params, cfg, device="cpu")
    assert rel.fingerprint_paths(tparams) == ref_rel.fingerprint_paths(params)
    got, want = rel.fingerprint(tparams).numpy(), np.asarray(ref_rel.fingerprint(params))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.abs(got - want) <= _FP_ATOL + _FP_RTOL * np.abs(want))
    # a corrupted leaf is named on both sides
    bad, hit = rel.corrupt_pytree(tparams, "['wo']", seed=2, bit=30)
    ref_bad, ref_hit = ref_rel.corrupt_pytree(params, "['wo']", seed=2, bit=30)
    assert hit == ref_hit
    assert rel.locate_fingerprint_fault(bad, rel.fingerprint(tparams)) == \
        ref_rel.locate_fingerprint_fault(ref_bad, ref_rel.fingerprint(params)) == [hit]
    assert rel.locate_fingerprint_fault(tparams, rel.fingerprint(tparams)) == []


def test_guarded_step_fn_skip_semantics():
    """The reference's unit drill: a nonfinite loss drops the update, the
    step advances, the counters count; a healthy step commits."""
    def fake_step(state, batch):
        new = {"params": tree.map_tree(lambda p: p + 1.0, state["params"]), "opt_state": state["opt_state"],
               "step": state["step"] + 1}
        return new, {"loss": batch["loss"], "grad_norm": torch.tensor(1.0), "step": new["step"]}

    g = rel.guarded_step_fn(fake_step)
    state = rel.init_guard_state({"params": {"w": torch.zeros(2)}, "opt_state": {"m": torch.zeros(2)},
                                  "step": torch.zeros((), dtype=torch.int32)})
    state, m = g(state, {"loss": torch.tensor(1.0)})
    assert float(state["params"]["w"][0]) == 1.0 and int(state["step"]) == 1
    state, m = g(state, {"loss": torch.tensor(float("nan"))})
    assert float(state["params"]["w"][0]) == 1.0   # the poisoned update dropped
    assert int(state["step"]) == 2                 # the step advances
    assert int(state["skipped"]) == 1 and float(m["skipped"]) == 1.0 and float(m["weight_fault"]) == 0.0
    state, m = g(state, {"loss": torch.tensor(0.5)})
    assert float(state["params"]["w"][0]) == 2.0 and int(state["skipped"]) == 1
    state["params"]["w"][1] = float("nan")  # corrupted between steps
    state, m = g(state, {"loss": torch.tensor(0.5)})
    assert float(m["weight_fault"]) == 1.0 and int(state["weight_faults"]) == 1 and int(state["skipped"]) == 2


def test_guarded_train_step_skips_without_touching_the_optimizer():
    _, cfg = reduced_configs("pallas_dip", "dip")
    opt = AdamW(lr=1e-3)
    params = tf_model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = rel.init_guard_state({"params": params, "opt_state": opt.init(params), "step": 0})
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16,
                                                           global_batch=2).batch(0).items()}
    step = tf_model.train_step_fn(cfg, opt, guard=True)
    state, m = step(state, batch)  # a clean step commits
    assert (m["skipped"], m["weight_fault"], state["opt_state"]["count"], state["step"]) == (0, 0, 1, 1)
    assert torch.equal(state["fingerprint"], rel.fingerprint(state["params"]))
    held = {"params": state["params"], "mu": state["opt_state"]["mu"], "nu": state["opt_state"]["nu"]}
    good = tree.map_tree(lambda t: t.detach().clone(), held)
    fp, norm = state["fingerprint"].clone(), state["opt_state"]["grad_norm"].clone()

    # a weight fault: a NaN planted between steps
    state["params"], hit = rel.corrupt_pytree(state["params"], "['wq']", seed=3, mode="nan")
    state, m = step(state, batch)
    assert (m["skipped"], m["weight_fault"], m["skipped_total"], m["weight_faults_total"]) == (1, 1, 1, 1)
    assert state["step"] == 2 and state["opt_state"]["count"] == 1
    assert torch.equal(state["opt_state"]["grad_norm"], norm) and torch.equal(state["fingerprint"], fp)
    assert math.isnan(float(m["grad_norm"]))  # the norm that was computed
    now = {"params": state["params"], "mu": state["opt_state"]["mu"], "nu": state["opt_state"]["nu"]}
    for (p, a), b in zip(tree.paths(now), tree.leaves(good)):
        if p != "['params']/" + hit:
            assert torch.equal(a, b), p

    # a loss-only fault: a finite weight large enough to overflow the
    # forward, taken into the reference fingerprint
    params = tree.map_tree(lambda t: t.clone(), good["params"])
    dict(tree.paths(params))[hit].view(-1)[0] = 3e38
    state["params"], state["fingerprint"] = params, rel.fingerprint(params)
    state, m = step(state, batch)
    assert (m["skipped"], m["weight_fault"], state["skipped"], state["weight_faults"]) == (1, 0, 2, 1)
    assert state["opt_state"]["count"] == 1 and state["step"] == 3


# ------------------------------------------------------- the guarded trainer --
def _tiny(backend):
    ref_cfg = RefArchConfig(matmul_backend=backend, **TINY)
    cfg = ArchConfig(matmul_backend={"xla": "torch", "pallas_dip": "dip"}[backend], **TINY)
    return ref_cfg, cfg


def _trainers(tmp_path, backend, hook_ref=None, hook_port=None, **tk):
    ref_cfg, cfg = _tiny(backend)
    kw = dict(keep=5, async_ckpt=False, log_every=100, guard=True)
    kw.update(tk)
    ref = RefTrainer(ref_cfg, RefTrainerConfig(ckpt_dir=str(tmp_path / "r"), **kw), seq_len=SEQ,
                     global_batch=BATCH, step_hook=hook_ref)
    port = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "p"), **kw), seq_len=SEQ, global_batch=BATCH,
                   step_hook=hook_port, device="cpu")
    start = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.init_state(0)["params"]), cfg, device="cpu")
    return ref, port, start


def _hooks(fault_step, target, mode, bit=None):
    hits = {}

    def ref_hook(step_no, state):
        if step_no == fault_step:
            params, hits["ref"] = ref_rel.corrupt_pytree(state["params"], target, seed=7, mode=mode, bit=bit)
            state = dict(state, params=params)
        return state

    def port_hook(step_no, state):
        if step_no == fault_step:
            params, hits["port"] = rel.corrupt_pytree(state["params"], target, seed=7, mode=mode, bit=bit)
            state = dict(state, params=params)
        return state

    return ref_hook, port_hook, hits


def _losses_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm"):
            if math.isnan(b[k]):
                assert math.isnan(a[k]), (k, a, b)
            else:
                assert abs(a[k] - b[k]) <= LOSS_TOL * max(1.0, abs(b[k])), (k, a, b)
        for k in ("step", "skipped", "weight_fault", "skipped_total", "weight_faults_total"):
            assert a[k] == b[k], (k, a, b)


@pytest.mark.parametrize("backend,target,mode,bit", [("xla", "layers", "nan", None),
                                                      ("pallas_dip", "['w_gate']/.data", "bitflip", 30)])
def test_guard_detects_fault_skips_and_recovers_as_reference(tmp_path, capsys, backend, target, mode, bit):
    ref_hook, port_hook, hits = _hooks(5, target, mode, bit)
    ref, port, start = _trainers(tmp_path, backend, ref_hook, port_hook, steps=8, ckpt_every=2)
    want = ref.run()
    got = port.run(params=start)
    assert hits["port"] == hits["ref"]
    assert "weight fault in [" + hits["port"] in capsys.readouterr().out
    for k in ("skipped", "weight_faults", "recoveries"):
        assert got[k] == want[k], k
    assert got["weight_faults"] >= 1 and got["skipped"] >= 1 and got["recoveries"] >= 1
    assert got["state"]["step"] == int(want["state"]["step"]) == 8
    _losses_match(got["metrics"], want["metrics"])
    for leaf in tree.leaves(got["state"]["params"]):
        assert torch.isfinite(leaf).all()
    skipped = [m for m in got["metrics"] if m["skipped"]]
    assert skipped and skipped[0]["weight_fault"] == 1.0


def test_guard_without_checkpoint_raises(tmp_path):
    def hook(step_no, state):
        if step_no == 1:
            params, _ = rel.corrupt_pytree(state["params"], "layers", seed=1, mode="nan")
            state = dict(state, params=params)
        return state

    _, cfg = _tiny("xla")
    tr = Trainer(cfg, TrainerConfig(steps=4, ckpt_every=100, ckpt_dir=str(tmp_path), async_ckpt=False,
                                    log_every=100, guard=True), seq_len=SEQ, global_batch=BATCH,
                 step_hook=hook, device="cpu")
    with pytest.raises(rel.ReliabilityError, match="weight corruption"):
        tr.run()
    tr2 = Trainer(cfg, TrainerConfig(steps=4, ckpt_every=1, ckpt_dir=str(tmp_path / "b"), async_ckpt=False,
                                     log_every=100, guard=True, recover_on_fault=False),
                  seq_len=SEQ, global_batch=BATCH, step_hook=hook, device="cpu")
    with pytest.raises(rel.ReliabilityError, match=r"weight corruption detected in \[\['layers'\]/\['attn_norm'\]\]"):
        tr2.run()


def test_guard_clean_run_matches_unguarded_and_reference(tmp_path):
    """No fault: the guarded run's losses equal the unguarded run's bit for
    bit and the reference's guarded run's within LOSS_TOL; a guarded run
    stopped at step 3 resumes from its step-2 checkpoint (the guard's keys
    in it) bit-exactly."""
    ref, _, start = _trainers(tmp_path, "xla", steps=4, ckpt_every=2)
    _, cfg = _tiny("xla")

    def train(sub, guard, **kw):
        return Trainer(cfg, TrainerConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path / sub), async_ckpt=False,
                                          log_every=100, guard=guard, **kw),
                       seq_len=SEQ, global_batch=BATCH, device="cpu")

    a = train("a", False).run(params=tree.map_tree(lambda t: t.clone(), start))
    b = train("b", True).run(params=tree.map_tree(lambda t: t.clone(), start))
    assert [m["loss"] for m in a["metrics"]] == [m["loss"] for m in b["metrics"]]
    assert [m["grad_norm"] for m in a["metrics"]] == [m["grad_norm"] for m in b["metrics"]]
    assert (b["skipped"], b["weight_faults"], b["recoveries"]) == (0, 0, 0)
    _losses_match(b["metrics"], ref.run()["metrics"])
    with pytest.raises(RuntimeError, match="injected failure"):
        train("c", True, fail_at_step=3).run(params=tree.map_tree(lambda t: t.clone(), start))
    resumed = train("c", True).run()
    assert [m["loss"] for m in resumed["metrics"]] == [m["loss"] for m in b["metrics"][2:]]
    assert sorted(resumed["state"]) == ["fingerprint", "opt_state", "params", "skipped", "step", "weight_faults"]
    assert torch.equal(resumed["state"]["fingerprint"], b["state"]["fingerprint"])


def test_reference_guarded_checkpoint_restores_in_the_port(tmp_path, capsys):
    """A checkpoint of the reference's guarded ``Trainer`` (fingerprint and
    counters beside the params) resumes in the port's guarded ``Trainer``."""
    ref_cfg, cfg = _tiny("xla")
    kw = dict(ckpt_every=2, keep=5, async_ckpt=False, log_every=100, guard=True)
    RefTrainer(ref_cfg, RefTrainerConfig(steps=2, ckpt_dir=str(tmp_path), **kw), seq_len=SEQ,
               global_batch=BATCH).run()
    want = RefTrainer(ref_cfg, RefTrainerConfig(steps=3, ckpt_dir=str(tmp_path / "u"), **kw), seq_len=SEQ,
                      global_batch=BATCH).run()["metrics"][-1]
    got = Trainer(cfg, TrainerConfig(steps=3, ckpt_dir=str(tmp_path), **kw), seq_len=SEQ, global_batch=BATCH,
                  device="cpu").run()
    assert "resumed from step 2" in capsys.readouterr().out
    _losses_match(got["metrics"], [want])
    assert got["skipped"] == 0 and got["weight_faults"] == 0
