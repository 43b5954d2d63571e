"""The MoE family under a sharding plan (``ep`` and ``tp``) over a 2-rank
gloo world against the reference's single-device layer and engine.

* The reference's ``ep`` contract configuration
  (``tests/test_sharded_backends.py:296-299``): ``moe_ffn`` under an ``ep``
  plan equals the reference's ``moe_ffn`` with the batch split (4 x 16) and
  the sequence split (1 x 32) at zero drops (atol / rtol 2e-3, aux within
  1e-3); at ``capacity_factor`` 1.0, where pairs drop, it equals the
  reference's ``moe_ffn`` run on each sequence half, drops included; a call
  counts 2 ``all_to_all``, 1 ``psum``, the local view's 1 ``all_gather``
  and the 2 plan-free shared-expert launches, the dispatch scheduled before
  them (``:323-327``); with neither B nor S dividing the axis it falls back
  to the expert-split layer.
* The same layer under ``tp`` equals the reference at finite capacity,
  with one psum for the routed experts' partial outputs, and the shared
  experts' collectives as their plans place them.
* The reduced DeepSeek-V2-Lite (MLA, a shared expert) and Qwen3-MoE (GQA)
  in f32 through ``Engine(plan=)`` under ``ep`` (capacity raised so that
  no pair drops on either side) and ``tp``: the reference single-device
  ``Engine``'s tokens, the whole latent pools, a decode step's collectives.
* ``make_plan`` under ``ep`` for every configuration: the reference's
  ``WeightPlan`` kinds, ``param_pspec``, ``paged_cache_pspec`` and
  ``expert_plan`` (abstract meshes, no world).
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.configs.base import ArchConfig as RefArchConfig
from repro.distributed.plan import make_plan as ref_make_plan
from repro.models import moe as ref_moe
from repro.models import transformer as ref_model
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.device import make_generator
from repro_torch.distributed import abstract_mesh, make_plan, run_world
from repro_torch.models import transformer as tf_model

import _torch_sharded_ranks as ranks

CONTRACT = dict(name="m", family="moe", n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0, vocab_size=64,
                head_dim=32, n_experts=8, moe_top_k=2, n_shared_experts=1, d_ff_expert=32, capacity_factor=2.0,
                remat="none", compute_dtype="float32", param_dtype="float32")
# the shared experts two experts wide (128 columns), so that their plans split
WIDE_SHARED = dict(CONTRACT, n_shared_experts=2, d_ff_expert=64)
BACKEND = {"ep": "dip_ep", "tp": "dip_tp"}
# name: (configuration, strategy, capacity factor, x shape)
LAYERS = {
    "ep_batch": (CONTRACT, "ep", 2.0, (4, 16)),
    "ep_seq": (CONTRACT, "ep", 2.0, (1, 32)),
    "ep_seq_drops": (CONTRACT, "ep", 1.0, (1, 64)),
    "ep_fallback": (CONTRACT, "ep", 2.0, (3, 5)),
    "tp": (CONTRACT, "tp", 1.0, (2, 32)),
    "tp_shared_split": (WIDE_SHARED, "tp", 1.0, (2, 32)),
}
PROMPTS = [np.arange(2, 9, dtype=np.int32), np.arange(40, 51, dtype=np.int32)]
MAX_NEW = 4
# name: (arch, strategy, capacity factor); ep's capacity keeps every pair on both sides
ENGINES = {
    "deepseek_ep": ("deepseek_v2_lite_16b", "ep", 8.0),
    "deepseek_tp": ("deepseek_v2_lite_16b", "tp", None),
    "qwen3_ep": ("qwen3_moe_235b_a22b", "ep", 8.0),
    "qwen3_tp": ("qwen3_moe_235b_a22b", "tp", None),
}
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _ref_layer0(params):
    return jax.tree_util.tree_map(lambda t: t[0], params["layers"])


@pytest.fixture(scope="module")
def world():
    key = jax.random.PRNGKey(0)
    layer_cases, want_layers = [], {}
    params = {}
    for name, (fields, strategy, cf, shape) in LAYERS.items():
        ref_cfg = RefArchConfig(**dict(fields, capacity_factor=cf), matmul_backend="xla", dip_weights=True)
        pkey = (id(fields), cf)
        if pkey not in params:
            params[pkey] = ref_model.init_params(key, ref_cfg)
        lp = _ref_layer0(params[pkey])
        layer = jax.jit(lambda x, lp, c=ref_cfg: ref_moe.moe_ffn(x, lp, c))
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(len(layer_cases) + 1), shape + (fields["d_model"],)))
        out, aux, drop = layer(x, lp)
        want = {"out": np.asarray(out), "aux": float(aux), "dropped": int(drop)}
        if name == "ep_seq_drops":  # the reference's ep semantics for a sequence split: each half alone
            halves = [layer(h, lp) for h in np.split(x, 2, axis=1)]
            want["halves"] = {"out": np.concatenate([np.asarray(h[0]) for h in halves], 1),
                              "aux": float(np.mean([float(h[1]) for h in halves])),
                              "dropped": sum(int(h[2]) for h in halves)}
        want_layers[name] = want
        layer_cases.append({"name": name, "x": x, "params": _np_tree(params[pkey]),
                            "cfg": dict(fields, capacity_factor=cf, matmul_backend=BACKEND[strategy],
                                        sharding=strategy)})

    engine_cases, want_tokens = [], {}
    for name, (arch, strategy, cf) in ENGINES.items():
        extra = {} if cf is None else {"capacity_factor": cf}
        rcfg = dataclasses.replace(ref_config(arch).reduced(), dip_weights=True, **F32, **extra)
        rparams = ref_model.init_params(key, rcfg)
        eng = RefEngine(rcfg, rparams, engine_cfg=RefEngineConfig(slots=2, max_seq=32, prefill_chunk=8))
        for rid, p in enumerate(PROMPTS):
            eng.add_request(p, RefSamplingParams(max_new_tokens=MAX_NEW), rid=rid)
        want_tokens[name] = {rid: list(map(int, v)) for rid, v in eng.run().items()}
        engine_cases.append({"name": name, "params": _np_tree(rparams), "prompts": [p.tolist() for p in PROMPTS],
                             "max_new": MAX_NEW, "cfg": dict(arch=arch, sharding=strategy,
                                                             matmul_backend=BACKEND[strategy], **F32, **extra)})
    out = run_world(ranks.moe_rank, 2, layer_cases, engine_cases, timeout=240)
    return dict(want_layers=want_layers, want_tokens=want_tokens, ranks=out)


def _layer(world, name):
    return [r[0][name] for r in world["ranks"]], world["want_layers"][name]


@pytest.mark.parametrize("name", ["ep_batch", "ep_seq", "ep_fallback"])
def test_ep_layer_matches_the_reference_at_zero_drops(world, name):
    got, want = _layer(world, name)
    assert want["dropped"] == 0
    for g in got:
        assert g["dropped"] == 0 and g["expert_plan"] == "expert" and g["experts"] == 4
        np.testing.assert_allclose(g["out"], want["out"], atol=2e-3, rtol=2e-3)
        assert abs(g["aux"] - want["aux"]) < 1e-3  # per-rank stats, averaged
    np.testing.assert_array_equal(got[0]["out"], got[1]["out"])


def test_ep_sequence_split_at_finite_capacity_is_each_half_alone(world):
    got, want = _layer(world, "ep_seq_drops")
    halves = want["halves"]
    assert halves["dropped"] > 0
    for g in got:
        assert g["dropped"] == halves["dropped"]
        np.testing.assert_allclose(g["out"], halves["out"], atol=2e-3, rtol=2e-3)
        assert abs(g["aux"] - halves["aux"]) < 1e-6
        assert g["ids"].shape == (1, 32, 2)  # the rank's own tokens' choices


@pytest.mark.parametrize("name", ["ep_batch", "ep_seq", "ep_seq_drops"])
def test_ep_layer_collectives_and_dispatch_order(world, name):
    got, _ = _layer(world, name)
    for g in got:
        c = g["counts"]
        assert (c["all_to_all"], c["psum"], c["all_gather"], c["reduce_scatter"], c["ppermute"]) == (2, 1, 1, 0, 0), c
        assert c["launch"] == 2, c  # the shared experts' gate+up and down, plan-free
        # the dispatch before the shared-expert launches it overlaps, then the
        # combine, the stats' psum and the tokens' all-gather
        assert g["schedule"] == ["all_to_all", "launch", "launch", "all_to_all", "psum", "all_gather"], g["schedule"]


def test_ep_fallback_is_the_expert_split_layer(world):
    got, _ = _layer(world, "ep_fallback")  # B = 3, S = 5: neither divides the axis
    for g in got:
        c = g["counts"]
        assert (c["all_to_all"], c["psum"], c["all_gather"], c["launch"]) == (0, 1, 0, 2), c
        assert g["schedule"] == ["psum", "launch", "launch"]


@pytest.mark.parametrize("name", ["tp", "tp_shared_split"])
def test_tp_layer_matches_the_reference_at_finite_capacity(world, name):
    got, want = _layer(world, name)
    assert want["dropped"] > 0
    for g in got:
        assert g["dropped"] == want["dropped"] and g["expert_plan"] is None and g["experts"] == 4
        np.testing.assert_allclose(g["out"], want["out"], atol=2e-3, rtol=2e-3)
        assert abs(g["aux"] - want["aux"]) < 1e-6  # every rank routes every token
        assert g["ids"].shape == (2, 32, 2)


def test_tp_layer_collectives(world):
    # the contract's 32-column shared expert replicates (the width fallback):
    # one psum for the routed partials, the shared FFN on the whole width
    c = _layer(world, "tp")[0][0]["counts"]
    assert (c["psum"], c["all_to_all"], c["all_gather"], c["launch"]) == (1, 0, 0, 0), c
    # 128 shared columns split: gate+up column-parallel, down row-parallel
    # with its own psum
    g = _layer(world, "tp_shared_split")[0][0]
    c = g["counts"]
    assert (c["psum"], c["all_to_all"], c["all_gather"], c["launch"]) == (2, 0, 0, 2), c
    assert g["schedule"] == ["psum", "launch", "launch", "psum"]


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_serves_the_reference_tokens(world, name):
    want = world["want_tokens"][name]
    for r in world["ranks"]:
        got = {rid: list(map(int, v)) for rid, v in r[1][name]["tokens"].items()}
        assert got == want and all(len(v) == MAX_NEW for v in got.values())


def test_engine_pools_and_decode_collectives(world):
    n = 2  # the reduced models' layers
    e = world["ranks"][0][1]
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    for name in ("deepseek_ep", "deepseek_tp"):
        pools = e[name]["pools"]
        # whole latent pools on every rank
        assert pools["c_kv"][-1] == cfg.kv_lora_rank and pools["k_rope"][-1] == cfg.qk_rope_head_dim
        assert e[name]["bytes_per_block"] == n * 16 * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 4
    assert e["qwen3_ep"]["pools"]["k"][3] == 1  # 2 KV heads over 2 ranks
    for name in ENGINES:
        assert e[name]["captured"] is False and e[name]["experts"] == 4
    # per layer: wo's psum, then ep's two all-to-alls, stats psum and token
    # all-gather (the 2 slots split by batch); the embedding's psum, the
    # logits' all-gather (the reduced MLA's latent projection replicates)
    for name in ("deepseek_ep", "qwen3_ep"):
        c = e[name]["decode_counts"]
        assert (c["psum"], c["all_to_all"], c["all_gather"]) == (2 * n + 1, 2 * n, n + 1), (name, c)
    for name in ("deepseek_tp", "qwen3_tp"):
        c = e[name]["decode_counts"]
        assert (c["psum"], c["all_to_all"], c["all_gather"]) == (2 * n + 1, 0, 1), (name, c)


# ------------------------------------------------------- plans, no world ---
def _walk_kinds(tree_, out, path=()):
    if isinstance(tree_, dict):
        for k, v in tree_.items():
            _walk_kinds(v, out, path + (k,))
    elif getattr(tree_, "plan", None) is not None:
        out[path] = (tree_.plan.kind, tree_.plan.axis, tree_.plan.fsdp)
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_ep_plan_matches_the_reference(arch):
    rcfg = dataclasses.replace(ref_config(arch).reduced(), sharding="ep", matmul_backend="dip_ep")
    ref_plan = ref_make_plan(AbstractMesh((1, 2), ("data", "model")), rcfg, "decode")
    cfg = dataclasses.replace(get_config(arch).reduced(), sharding="ep", matmul_backend="dip_ep")
    plan = make_plan(abstract_mesh(data=1, model=2), cfg, "decode")
    assert plan.explicit_backend == ref_plan.explicit_backend == "dip_ep"
    assert (plan.expert_plan.kind, plan.expert_plan.axis) == (ref_plan.expert_plan.kind, ref_plan.expert_plan.axis)
    single = dataclasses.replace(cfg, matmul_backend="dip", sharding="gspmd")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _walk_kinds(ref_plan.attach_params(ref_model.param_specs(rcfg)), {})
        got = _walk_kinds(plan.attach_params(tf_model.init_params(single, make_generator(0, "cpu"), "cpu")), {})
        assert got == want and len(got) > 1

        def leaves(t):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from leaves(v)
                else:
                    yield k, tuple(v[0])

        for leaf, shape in leaves(tf_model.param_template(single)):
            assert plan.param_pspec(leaf, shape) == tuple(ref_plan.param_pspec(leaf, shape)), leaf
    pools = tf_model.init_paged_cache(single, 3, 4, slots=2, device="cpu")["layers"]
    for nm, t in pools.items():
        if nm != "attn":
            shape = tuple(t.shape)
            assert plan.paged_cache_pspec(nm, shape) == tuple(ref_plan.paged_cache_pspec(nm, shape)), nm


def test_init_params_under_ep_draws_whole_banks_and_keeps_the_rank_experts():
    """Rank r's experts are experts [r E / T, (r + 1) E / T) of the
    single-rank draw from the same seed; the shared experts stay whole with
    their plans, every other leaf is ``shard_params`` of the whole draw."""
    from repro_torch import api, tree
    from repro_torch.distributed import comm

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(), sharding="ep", matmul_backend="dip_ep",
                              **F32)
    whole = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu")
    for rank in (0, 1):
        plan = make_plan(comm.Mesh({"data": 1, "model": 2}, rank=rank), cfg, "decode")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mine = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu", plan=plan)
            cut = plan.shard_params(whole)
        for nm in ("w_gate", "w_up", "w_down"):
            assert mine["layers"][nm].shape[1] == cfg.n_experts // 2
            assert np.array_equal(mine["layers"][nm].numpy(),
                                  whole["layers"][nm][:, rank * 4:(rank + 1) * 4].numpy())
        sw = mine["layers"]["shared_w_gate"]
        assert isinstance(sw, api.DipWeight) and sw.data.shape == whole["layers"]["shared_w_gate"].data.shape
        assert sw.plan.kind == plan.weight_plan("shared_w_gate", tuple(sw.data.shape), sw.perm_tile).kind
        for a, b in zip(tree.leaves(mine), tree.leaves(cut)):
            assert np.array_equal(a.numpy(), b.numpy())
