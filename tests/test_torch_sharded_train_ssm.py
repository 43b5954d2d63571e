"""Training the ssm and hybrid families under a sharding plan
(``train_step_fn(plan=)`` over 2 gloo ranks: ``tp``, ``fsdp`` and ``sp``)
against the reference's single-device step (``_torch_train_pairs.py``:
the loss, ``grad_norm``, every parameter leaf after the step gathered from
the ranks, a second step's loss, within the reference's 1e-4), with each
step's collectives and launches pinned.

The reduced Mamba2 (tied head) and Zamba2 (2 shared-block sites,
``in_proj`` replicating: 576 / 2 storage columns are no 64-tile shard),
batch 2 x 32.  Under ``tp`` and ``sp`` a rank holds its SSM heads' slices
of the per-head leaves and, of ``conv_w`` / ``conv_b``, its heads' x
channels and the whole B and C: the B and C channels' gradient shares are
summed with the whole leaves' (``transformer.replicated_parts``).
"""

import pytest

from _torch_train_pairs import check_pair, world

PAIRS = {  # (strategy, family) -> one step's collectives and launches a rank
    ("tp", "ssm"): dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=2),
    ("fsdp", "ssm"): dict(psum=2, all_gather=7, reduce_scatter=7, ppermute=0, all_to_all=0, launch=4),
    ("sp", "ssm"): dict(psum=6, all_gather=7, reduce_scatter=7, ppermute=0, all_to_all=0, launch=2),
    ("tp", "hybrid"): dict(psum=28, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=13),
    ("fsdp", "hybrid"): dict(psum=2, all_gather=25, reduce_scatter=25, ppermute=0, all_to_all=0, launch=21),
    ("sp", "hybrid"): dict(psum=10, all_gather=18, reduce_scatter=18, ppermute=10, all_to_all=0, launch=18),
}


@pytest.fixture(scope="module")
def trained():
    return world(list(PAIRS))


@pytest.mark.parametrize("pair", list(PAIRS), ids=lambda p: f"{p[0]}-{p[1]}")
def test_sharded_step_matches_the_reference_single_device_step(trained, pair):
    got, ref = trained[pair]
    check_pair(got, ref, *pair, counts=PAIRS[pair])
