"""The moe family under ``fsdp`` (ZeRO-3 over a 2-rank gloo world, data 2 x
model 1) against the reference's single-device model, on the reference's
parameters (``params_from_jax``).

The configs are the reduced DeepSeek-V2-Lite (MLA, a shared expert) and
Qwen3-MoE (GQA) with the overrides of the reference's fleet ``fsdp`` cells
(``benchmarks/fleet.py`` ``cell_config``: f32 compute, ``dip_fsdp``); the
reference runs single-device on the same DiP storage (``dip_weights=True``).
Each rank holds K / 2 rows of every projection's storage, its half of
each expert bank's contraction dim (d of gate / up, ffe of down) and of the
router's d, as the reference's ``expert_bank`` / ``router`` specs cut them.
Held:

* layer 0's ``moe_ffn`` at ``capacity_factor`` 1.0, where pairs drop, on a
  (2, 32) batch split 1 / 1 (each rank its own sequence): each rank's
  output rows, expert ids and drops are the single-rank layer's for that
  sequence (routing is per sequence), the ranks' drops add up to the
  reference's, and the call gathers the router and the three banks (one
  all-gather a leaf) and the shared experts' storage (``dip_fsdp``: gate
  and up, then down, one launch each);
* the logits of a (2, 12) batch (split 1 / 1, the logits' rows gathered)
  and of a (1, 12) one (whole on both ranks) within ``MODEL_TOL`` (1e-4 of
  max(1, max|reference|), f32: one launch on the gathered storage is the
  single-rank launch, so only the reference's XLA order of the sums
  differs), with the exact all-gathers and launches;
* the ``Engine``'s greedy tokens, a decode step's all-gathers, the whole
  latent / KV pools on every rank;
* the rank's draw (``init_params(plan=)``) against its slice of the whole
  draw, and its slice through a checkpoint (restored; into whole banks it
  raises).

``launch.serve --sharded fsdp`` with the moe family runs in
``test_torch_sharded_fsdp.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_close
from repro.configs import get_config as ref_config
from repro.models import moe as ref_moe
from repro.models import transformer as ref_model
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams

from repro_torch.distributed import run_world

import _torch_sharded_ranks as ranks

MODEL_TOL = 1e-4
LAYER_TOL = 2e-5
F32 = dict(compute_dtype="float32", param_dtype="float32")
FSDP = dict(sharding="fsdp", matmul_backend="dip_fsdp", **F32)
CASES = {"deepseek": ("deepseek_v2_lite_16b", "deepseek-v2-lite-16b"),
         "qwen3": ("qwen3_moe_235b_a22b", "qwen3-moe-235b-a22b")}
PROMPTS = [np.arange(2, 9, dtype=np.int32), np.arange(40, 51, dtype=np.int32)]
MAX_NEW = 4
LAYER_X = (2, 32)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    layer_cases, model_cases, want = [], [], {}
    for i, (name, (ref_arch, arch)) in enumerate(CASES.items()):
        rcfg = dataclasses.replace(ref_config(ref_arch).reduced(), dip_weights=True, **F32)
        params = ref_model.init_params(jax.random.PRNGKey(50 + i), rcfg)
        lcfg = dataclasses.replace(rcfg, capacity_factor=1.0)
        lp = jax.tree_util.tree_map(lambda t: t[0], params["layers"])
        x = rng.normal(0, 1, LAYER_X + (rcfg.d_model,)).astype(np.float32)
        out, _, _ = ref_moe.moe_ffn(jnp.asarray(x), lp, lcfg)
        # each sequence alone through the reference layer: its drops, and
        # the top-k ids of its tokens
        alone = [ref_moe.moe_ffn(jnp.asarray(x[j:j + 1]), lp, lcfg) for j in range(2)]
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), lp["router"]), axis=-1)
        ids = np.asarray(jax.lax.top_k(probs, rcfg.moe_top_k)[1])
        batches = [rng.integers(0, rcfg.vocab_size, (2, 12)), rng.integers(0, rcfg.vocab_size, (1, 12))]
        eng = RefEngine(rcfg, params, engine_cfg=RefEngineConfig(slots=2, max_seq=32, prefill_chunk=8))
        for rid, p in enumerate(PROMPTS):
            eng.add_request(p, RefSamplingParams(max_new_tokens=MAX_NEW), rid=rid)
        want[name] = {"cfg": rcfg, "out": np.asarray(out), "dropped": [int(a[2]) for a in alone], "ids": ids,
                      "logits": [np.asarray(ref_model.forward(params, rcfg, tokens=jnp.asarray(t))[0])
                                 for t in batches],
                      "tokens": {rid: list(map(int, v)) for rid, v in eng.run().items()}}
        np_params = _np_tree(params)
        layer_cases.append(dict(name=name, x=x, params=np_params,
                                cfg=dict(arch=arch, capacity_factor=1.0, **FSDP)))
        model_cases.append(dict(name=name, params=np_params, cfg=dict(arch=arch, **FSDP), tokens=batches,
                                prompts=[p.tolist() for p in PROMPTS], max_new=MAX_NEW))
    return want, run_world(ranks.moe_fsdp_rank, 2, layer_cases, model_cases, timeout=300)


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_moe_layer_is_the_single_rank_layer_on_each_sequence(world, name):
    want, outs = world
    cfg = want[name]["cfg"]
    assert sum(want[name]["dropped"]) > 0  # capacity 1.0 drops pairs
    for r, out in enumerate(outs):
        g = out[0][name]
        assert_close(g["out"], want[name]["out"][r:r + 1], LAYER_TOL)
        np.testing.assert_array_equal(g["ids"], want[name]["ids"][r:r + 1])
        assert g["dropped"] == want[name]["dropped"][r]
        d, ffe, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
        assert g["banks"] == {"router": (d // 2, e), "w_gate": (e, d // 2, ffe), "w_up": (e, d // 2, ffe),
                              "w_down": (e, ffe // 2, d)}
        c = g["counts"]
        # the router and the three banks, then the shared experts' gate, up and
        # down storage; gate+up one launch, down one
        shared = 3 if cfg.n_shared_experts else 0
        assert (c["all_gather"], c["launch"], c["psum"], c["all_to_all"]) == (4 + shared, 2 * bool(shared), 0, 0), c
        assert g["schedule"][:4] == ["all_gather"] * 4, g["schedule"]


def _gathers(cfg) -> int:
    """All-gathers a layer: the router and three banks, the attention's
    projections (MLA: wq, w_dkv, w_krope, wo, and w_uk / w_uv before their
    de-shear; GQA: wq, wk, wv, wo) and the shared experts' three."""
    attn = 6 if cfg.use_mla else 4
    return 4 + attn + (3 if cfg.n_shared_experts else 0)


def _launches(cfg) -> int:
    attn = 4  # MLA's wq, w_dkv, w_krope, wo; GQA's wq, wk, wv, wo
    return attn + (2 if cfg.n_shared_experts else 0)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_under_fsdp_matches_the_reference(world, name):
    want, outs = world
    cfg = want[name]["cfg"]
    for out in outs:
        for (logits, c), ref, split in zip(out[1][name]["forward"], want[name]["logits"], (True, False)):
            assert_close(logits, ref, MODEL_TOL)
            # per layer, the embedding's columns, the lm_head's storage, and
            # (split batch) the logits' rows
            assert c["all_gather"] == cfg.n_layers * _gathers(cfg) + 2 + int(split), c
            assert c["launch"] == cfg.n_layers * _launches(cfg) + 1, c
            assert c["psum"] == c["reduce_scatter"] == c["ppermute"] == c["all_to_all"] == 0, c
    for k in range(2):
        np.testing.assert_array_equal(outs[0][1][name]["forward"][k][0], outs[1][1][name]["forward"][k][0])


@pytest.mark.parametrize("name", list(CASES))
def test_engine_under_fsdp_serves_the_reference_tokens(world, name):
    want, outs = world
    cfg = want[name]["cfg"]
    for out in outs:
        rec = out[1][name]
        assert {rid: list(map(int, v)) for rid, v in rec["tokens"].items()} == want[name]["tokens"]
        c = rec["decode_counts"]  # the 2 slots split 1 / 1: the logits' rows gathered
        assert (c["all_gather"], c["psum"]) == (cfg.n_layers * _gathers(cfg) + 3, 0), c
        if cfg.use_mla:  # the whole latent pools on every rank
            assert rec["pools"]["c_kv"][-1] == cfg.kv_lora_rank
        else:
            assert rec["pools"]["k"][3] == cfg.n_kv_heads


@pytest.mark.parametrize("name", list(CASES))
def test_rank_draw_and_checkpoint_of_the_cut_banks(world, name):
    want, outs = world
    cfg = want[name]["cfg"]
    for out in outs:
        rec = out[1][name]
        assert rec["leaves"]["layers/w_gate"][0] == (cfg.n_layers, cfg.n_experts, cfg.d_model // 2, cfg.d_ff_expert)
        assert rec["leaves"]["layers/w_down"][0] == (cfg.n_layers, cfg.n_experts, cfg.d_ff_expert // 2,
                                                     cfg.d_model)
        assert rec["leaves"]["layers/router"][0] == (cfg.n_layers, cfg.d_model // 2, cfg.n_experts)
        assert rec["leaves"]["layers/wq"][2:] == ("model", "data")
        assert rec["draw_equal"]
        assert rec["restored_equal"]
        assert "in the restore target" in rec["whole_bank_restore"]
