"""Training the dense and moe families under a sharding plan
(``train_step_fn(plan=)`` over 2 gloo ranks: ``tp``, ``fsdp`` and ``ep``
for both, ``sp`` for the dense one) against the reference's single-device
step (``_torch_train_pairs.py``: the loss, ``grad_norm``, every parameter
leaf after the step gathered from the ranks, a second step's loss, within
the reference's 1e-4), with each step's collectives and launches pinned.

The reduced llama3-8b (GQA 4 / 2 heads, wk and wv replicating: 64 columns
split into no 64-tile shard) and DeepSeek-V2-Lite (MLA, 8 experts top-2, 1
shared), batch 2 x 32; ``moe_remat`` is DeepSeek-V2-Lite under ``ep``
with block remat, whose backward reruns each block's forward (its
all-to-alls, its routing on the same tokens) before differentiating it.
The counts are a step's forward, backward (and remat's reruns) and the
step's own collectives: the one psum of the whole leaves' gradient shares
and the global norm's psum.
"""

import pytest

from _torch_train_pairs import check_pair, world

PAIRS = {  # (strategy, family) -> one step's collectives and launches a rank
    ("tp", "dense"): dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=9),
    ("fsdp", "dense"): dict(psum=2, all_gather=17, reduce_scatter=17, ppermute=0, all_to_all=0, launch=13),
    ("sp", "dense"): dict(psum=2, all_gather=10, reduce_scatter=10, ppermute=10, all_to_all=0, launch=14),
    ("ep", "dense"): dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=9),
    ("tp", "moe"): dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=3),
    ("fsdp", "moe"): dict(psum=6, all_gather=29, reduce_scatter=29, ppermute=0, all_to_all=0, launch=13),
    ("ep", "moe"): dict(psum=12, all_gather=3, reduce_scatter=3, ppermute=0, all_to_all=8, launch=7),
    ("ep", "moe_remat"): dict(psum=16, all_gather=3, reduce_scatter=3, ppermute=0, all_to_all=12, launch=13),
}


@pytest.fixture(scope="module")
def trained():
    return world(list(PAIRS))


@pytest.mark.parametrize("pair", list(PAIRS), ids=lambda p: f"{p[0]}-{p[1]}")
def test_sharded_step_matches_the_reference_single_device_step(trained, pair):
    got, ref = trained[pair]
    check_pair(got, ref, *pair, counts=PAIRS[pair])


# the full-width cuts that chip_smoke.py phases 10a / 10b train on the card
# split every projection as these do (llama3-8b: q, k, v, gate / up column,
# o and down row, the vocab; DeepSeek-V2-Lite: q, the latent and its up
# projections column, w_krope replicating, o row, 32 of 64 experts a rank,
# the shared experts whole), with block remat over 2 layers: their step's
# counts are these (``TRAIN10_COUNTS`` there)
FULL_WIDTH_SPLITS = {
    "10a": (dict(arch="llama3-8b", head_dim=64, n_layers=2, remat="block", compute_dtype="bfloat16",
                 param_dtype="float32", sharding="tp", matmul_backend="dip_tp", strict=True),
            dict(psum=14, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=25)),
    "10b": (dict(arch="deepseek-v2-lite-16b", qk_rope_head_dim=32, kv_lora_rank=128, n_shared_experts=2,
                 n_layers=2, remat="block", compute_dtype="bfloat16", param_dtype="float32", sharding="ep",
                 matmul_backend="dip_ep"),
            dict(psum=16, all_gather=7, reduce_scatter=5, ppermute=0, all_to_all=12, launch=21)),
}


def test_step_counts_of_the_full_width_splits():
    from repro_torch.distributed import run_world

    import _torch_sharded_ranks as ranks

    got = run_world(ranks.train_counts_rank, 2, {k: v[0] for k, v in FULL_WIDTH_SPLITS.items()}, timeout=240)
    for counts in got:
        assert counts == {k: v[1] for k, v in FULL_WIDTH_SPLITS.items()}, counts
