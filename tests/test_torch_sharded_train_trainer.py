"""``Trainer(plan=)`` over 2 gloo ranks, mesh-independent checkpoints and
the guard's joint verdict (``_torch_sharded_ranks.train_trainer_rank``).

The reduced llama3-8b in f32 with 4 KV heads (so that ``wk`` / ``wv``
split under ``tp`` as under ``fsdp`` and the two plans describe every
weight alike), batch 2 x 16, 3 AdamW steps, a checkpoint at step 2:

* a second trainer on the same ``tp`` mesh resumes from it and repeats
  step 3 bit for bit (its loss and every parameter);
* the step-2 checkpoint restored under ``tp`` (into a state drawn from
  another seed), under ``fsdp`` (data 2, model 1) and whole on one rank
  (no plan): every leaf of each, gathered whole, bit-equal to the others;
  each rank holding its slices (the ``tp`` and ``fsdp`` shapes);
* the guard: rank 1's fingerprint reference is off, so only its screen
  fails; both ranks skip the update (one psum of the flags), count the
  weight fault and keep their parameters bit for bit; the next, clean
  step passes on both.
"""

import numpy as np
import pytest

from repro_torch.distributed import run_world

import _torch_sharded_ranks as ranks

STEPS = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_world(ranks.train_trainer_rank, 2, str(tmp_path_factory.mktemp("ckpt")), STEPS, timeout=300)


def test_trainer_under_tp_resumes_bit_for_bit(run):
    for r in run:
        assert len(r["losses"]) == STEPS and np.all(np.isfinite(r["losses"]))
        assert r["resumed_losses"] == r["losses"][2:]  # step 3 only: it resumed from step 2
        for a, b in zip(r["final"], r["resumed_final"]):
            np.testing.assert_array_equal(a, b)
    assert run[0]["losses"] == run[1]["losses"]


def test_checkpoint_restores_under_another_strategy_and_on_one_rank(run):
    for r in run:
        tp, fsdp, one = r["restored"]["tp"], r["restored"]["fsdp"], r["one_rank"]
        assert len(tp) == len(fsdp) == len(one)
        for a, b, c in zip(tp, fsdp, one):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    # each rank holds its slices: the column shards' halves under tp, K's half under fsdp
    path = "['params']/['layers']/['wq']/.data"
    assert run[0]["tp_slices"][path] == (2, 128, 64) and run[0]["fsdp_slices"][path] == (2, 64, 128)
    assert run[0]["tp_slices"]["['params']/['embed']"] == (1024, 128)  # padded vocab 2048
    assert run[0]["fsdp_slices"]["['params']/['embed']"] == (2048, 64)


def test_the_guard_skips_jointly_when_one_rank_sees_a_fault(run):
    for r in run:
        assert r["guard_poisoned"] == {"skipped": 1, "weight_fault": 1}
        assert r["guard_unchanged"]
        assert r["guard_clean"] == {"skipped": 0, "weight_fault": 0}
