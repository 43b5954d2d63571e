"""The batch-sharded ``fsdp`` model path (ZeRO-3 over a 2-rank gloo world,
data 2 x model 1) against the reference's single-device model, on the
reference's parameters (``params_from_jax``).

The configs are the reduced llama3-8b and Zamba2 with the overrides of the
reference's fleet ``fsdp`` cells (``benchmarks/fleet.py`` ``cell_config``:
f32 compute, ``dip_fsdp``); the reference runs single-device on the same
DiP storage (``dip_weights=True``).  Each rank holds K / 2 rows of every
projection's storage and d / 2 columns of the embedding; every projection
gathers its storage (one all-gather a weight) before its one launch.  A
batch of 2 splits 1 / 1 over the ranks (the logits' rows all-gathered), a
batch of 1 runs whole on both.  Held: the logits of both batches within
``MODEL_TOL`` (1e-4 of max(1, max|reference|), f32: one launch on the
gathered storage is the single-rank launch, so only the reference's XLA
order of the sums differs), the exact collective and launch counts, the
``Engine``'s greedy tokens on prompts that leave a 3-token SSM tail, the
pools whole on every rank, the rank's draw (``init_params(plan=)``)
against its slice of the whole draw; with no world, the ``fsdp`` plan
through ``params_from_jax``, ``tree`` and a checkpoint; what stays
refused (a model axis under ``fsdp``, serving or training; the MoE
family under ``sp``); ``launch.serve --sharded fsdp`` serving the
unsharded launcher's tokens, with llama3-8b and with DeepSeek-V2-Lite
(the MoE family under ``fsdp``: ``test_torch_sharded_moe_fsdp.py``).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_parity import assert_close
from repro.configs import get_config as ref_config
from repro.distributed.plan import make_plan as ref_make_plan
from repro.models import transformer as ref_model
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams

from repro_torch import api, tree
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import WeightPlan, abstract_mesh, make_plan, run_world
from repro_torch.models import transformer as tf_model

import _torch_sharded_ranks as ranks

MODEL_TOL = 1e-4
F32 = dict(compute_dtype="float32", param_dtype="float32")
CASES = {"llama3": ("llama3_8b", "llama3-8b"), "zamba2": ("zamba2_2_7b", "zamba2-2.7b")}
PROMPTS = [np.arange(2, 13, dtype=np.int32), np.arange(40, 59, dtype=np.int32)]
MAX_NEW = 4


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(30)
    cases, want = [], {}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    for i, (name, (ref_arch, arch)) in enumerate(CASES.items()):
        rcfg = dataclasses.replace(ref_config(ref_arch).reduced(), dip_weights=True, **F32)
        params = ref_model.init_params(jax.random.PRNGKey(10 + i), rcfg)
        batches = [rng.integers(0, rcfg.vocab_size, (2, 12)), rng.integers(0, rcfg.vocab_size, (1, 12))]
        eng = RefEngine(rcfg, params, engine_cfg=RefEngineConfig(slots=2, max_seq=32, prefill_chunk=8))
        for rid, p in enumerate(PROMPTS):
            eng.add_request(p, RefSamplingParams(max_new_tokens=MAX_NEW), rid=rid)
        want[name] = {"logits": [np.asarray(ref_model.forward(params, rcfg, tokens=jnp.asarray(t))[0])
                                 for t in batches], "tokens": eng.run(), "cfg": rcfg}
        cases.append(dict(name=name, cfg=dict(arch=arch, sharding="fsdp", matmul_backend="dip_fsdp", **F32),
                          params=to_np(params), tokens=batches, prompts=[p.tolist() for p in PROMPTS],
                          max_new=MAX_NEW))
    return want, run_world(ranks.sharded_model_rank, 2, "fsdp", cases, timeout=300)


def _weights(cfg) -> int:
    """DiP weights a forward dispatches: each an all-gather of its storage
    (the swiglu pair two) and each launch but gate+up one."""
    if cfg.ssm_state:
        return 2 * cfg.n_layers + 7 * (cfg.n_layers // cfg.attn_every) + 1
    return 7 * cfg.n_layers + 1


@pytest.mark.parametrize("name", list(CASES))
def test_forward_under_fsdp_matches_the_reference(served, name):
    want, outs = served
    cfg = want[name]["cfg"]
    n_w = _weights(cfg)
    n_launch = n_w - (cfg.n_layers // cfg.attn_every if cfg.ssm_state else cfg.n_layers)
    for out in outs:
        for (logits, c), ref, split in zip(out[name]["forward"], want[name]["logits"], (True, False)):
            assert_close(logits, ref, MODEL_TOL)
            # a gather per weight, the embedding's columns, and (split batch) the logits' rows
            assert (c["all_gather"], c["launch"]) == (n_w + 1 + int(split), n_launch), c
            assert c["psum"] == c["reduce_scatter"] == c["ppermute"] == c["all_to_all"] == 0, c
    for k in range(2):
        np.testing.assert_array_equal(outs[0][name]["forward"][k][0], outs[1][name]["forward"][k][0])


@pytest.mark.parametrize("name", list(CASES))
def test_engine_under_fsdp_serves_the_reference_tokens(served, name):
    want, outs = served
    cfg = want[name]["cfg"]
    ref = {rid: list(map(int, v)) for rid, v in want[name]["tokens"].items()}
    for out in outs:
        rec = out[name]
        assert {rid: list(map(int, v)) for rid, v in rec["tokens"].items()} == ref
        c = rec["decode_counts"]  # the 2 slots split 1 / 1: the logits' rows gathered
        assert (c["all_gather"], c["psum"]) == (_weights(cfg) + 2, 0), c


@pytest.mark.parametrize("name", list(CASES))
def test_rank_holds_k_slices_and_whole_pools(served, name):
    want, outs = served
    cfg = want[name]["cfg"]
    for out in outs:
        rec = out[name]
        dips = {k: v for k, v in rec["leaves"].items() if v[1] is not None}
        assert len(dips) >= 8
        for path, (shape, kind, axis, fsdp) in dips.items():
            leaf = path.split("/")[-1]
            d_in = {"w_down": cfg.d_ff, "wo": cfg.n_heads * cfg.resolved_head_dim,
                    "out_proj": cfg.d_inner}.get(leaf, cfg.d_model)
            assert fsdp == "data" and shape[-2] * 2 == api.DipWeight.storage_dims(d_in, 64)[0], (path, shape)
        assert rec["leaves"]["embed"][0] == (cfg.padded_vocab, cfg.d_model // 2)
        if cfg.ssm_state:
            assert rec["pools"]["state"] == (cfg.n_layers, 2, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
            assert rec["leaves"]["layers/conv_w"][0][-1] == cfg.d_inner + 2 * cfg.ssm_state
            assert rec["attn_pools"]["k"][3] == cfg.n_kv_heads
        else:
            assert rec["pools"]["k"][3] == cfg.n_kv_heads
        assert rec["draw_equal"]


def _fsdp_cfg(arch="llama3-8b"):
    return dataclasses.replace(get_config(arch).reduced(), sharding="fsdp", matmul_backend="dip_fsdp", **F32)


def test_fsdp_plan_rides_through_convert_tree_and_checkpoint(tmp_path):
    rcfg = dataclasses.replace(ref_config("llama3_8b").reduced(), sharding="fsdp", matmul_backend="dip_fsdp", **F32)
    rplan = ref_make_plan(AbstractMesh((2, 1), ("data", "model")), rcfg, "decode")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rparams = rplan.attach_params(ref_model.init_params(jax.random.PRNGKey(0), rcfg))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams), _fsdp_cfg(), device="cpu")
    assert params["layers"]["wq"].plan == WeightPlan("column", axis="model", fsdp="data")
    plan = make_plan(abstract_mesh(data=2, model=1), _fsdp_cfg(), "decode")
    local = plan.shard_params(params)
    wq = local["layers"]["wq"]
    assert wq.plan == WeightPlan("column", axis="model", fsdp="data", mesh=plan.mesh)
    assert wq.data.shape[-2] * 2 == params["layers"]["wq"].data.shape[-2]
    torch.testing.assert_close(wq.data, params["layers"]["wq"].data[:, :wq.data.shape[-2]], rtol=0, atol=0)
    assert plan.shard_params(local)["layers"]["wq"] is wq  # the rank's slice passes through
    back = tree.unflatten(local, tree.leaves(local))
    assert back["layers"]["wo"].plan == local["layers"]["wo"].plan
    path = str(tmp_path / "ck")
    save_pytree(path, local)
    got = restore_pytree(path, tree.unflatten(local, [torch.zeros_like(t) for t in tree.leaves(local)]))
    assert got["layers"]["w_down"].plan == local["layers"]["w_down"].plan
    assert torch.equal(got["layers"]["w_down"].data, local["layers"]["w_down"].data)
    bad = WeightPlan("column", axis="model", fsdp=None, mesh=plan.mesh)
    with pytest.raises(ValueError, match="ShardingPlan mismatch"):
        restore_pytree(path, dict(local, lm_head=local["lm_head"].with_plan(bad)))


def test_moe_under_fsdp_and_the_sp_model_path_raise(capsys):
    """What stays refused around the two paths this test once held
    refused: fsdp over a model axis, the moe family under ``sp``, training
    under an ``fsdp`` plan.  The moe family under ``fsdp`` now serves:
    ``launch.serve --sharded fsdp`` with DeepSeek-V2-Lite serves the
    unsharded launcher's tokens."""
    dense = _fsdp_cfg()
    with pytest.raises(NotImplementedError, match="fsdp over"):  # a model axis under fsdp
        tf_model.decode_step_fn(dense, plan=make_plan(abstract_mesh(data=1, model=2), dense, "decode"))
    moe = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(), **F32)
    moe_sp = dataclasses.replace(moe, sharding="sp", matmul_backend="dip_sp")
    with pytest.raises(NotImplementedError, match="Distributed"):
        tf_model.param_template(moe_sp)
    with pytest.raises(NotImplementedError, match="Distributed"):  # the plan refuses the family too
        tf_model.paged_decode_step_fn(moe, plan=make_plan(abstract_mesh(data=1, model=2), moe_sp, "decode"))
    moe_fsdp = dataclasses.replace(moe, sharding="fsdp", matmul_backend="dip_fsdp")
    with pytest.raises(NotImplementedError, match="Distributed"):  # a model axis under fsdp; the moe family trains now
        tf_model.train_step_fn(moe_fsdp, None, plan=make_plan(abstract_mesh(data=2, model=2), moe_fsdp, "train"))
    from repro_torch.launch import serve

    argv = ["--arch", "deepseek-v2-lite-16b", "--reduced", "--dtype", "float32", "--requests", "2", "--max-new",
            "3", "--slots", "2", "--max-seq", "64", "--prefill-chunk", "16", "--device", "cpu", "--temperature", "0"]
    want = serve.main(argv)
    got = serve.main(argv + ["--sharded", "fsdp"])
    assert got == want and sorted(got) == [0, 1]
    assert '"transport": "gloo"' in capsys.readouterr().out


def test_launch_serve_sharded_fsdp_on_cpu(capsys):
    from repro_torch.launch import serve

    argv = ["--arch", "llama3-8b", "--reduced", "--dtype", "float32", "--requests", "2", "--max-new", "3",
            "--slots", "2", "--max-seq", "64", "--prefill-chunk", "16", "--device", "cpu", "--temperature", "0"]
    want = serve.main(argv)
    got = serve.main(argv + ["--sharded", "fsdp"])
    assert got == want and sorted(got) == [0, 1]
    assert '"transport": "gloo"' in capsys.readouterr().out
