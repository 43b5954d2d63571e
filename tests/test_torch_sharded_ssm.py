"""The SSM and hybrid families under a tensor-parallel plan (``tp`` over a
2-rank gloo world, data 1 x model 2) against the reference's single-device
model, on the reference's parameters (``params_from_jax``).

The configs are the reduced ones with the overrides of the reference's
fleet ``tp`` cells (``benchmarks/fleet.py`` ``cell_config``: f32 compute,
``dip_tp``); the reference runs single-device on the same DiP storage
(``dip_weights=True``).  Three cases:

* ``zamba2``: the reduced Zamba2, whose ``in_proj`` replicates (576 / 2 =
  288 storage columns are no 64-tile shard);
* ``zamba2_col``: the reduced Zamba2 with ``ssm_state=32`` (``in_dim`` 584,
  storage 640, 320 a rank): ``in_proj`` column-parallel, its output
  all-gathered;
* ``mamba2``: the reduced Mamba2, its tied head the rank's vocab rows of
  the embedding, the logits all-gathered.

Each holds layer 0's Mamba2 block (a 40-token chunked prefill into a cache,
then one O(1) decode token; the rank's heads of the state and their conv
channels against the reference's), the forward's logits, the ``Engine``'s
greedy tokens on prompts that leave a 3-token SSM tail (chunk 8), the exact
collective and launch counts of a forward and of a decode step, and the
pools' shapes (H / T heads).  Tolerance, of max(1, max|reference|): the
block ``TOL["float32"]`` (1e-5), the logits ``MODEL_TOL`` (1e-4) as the
unsharded SSM tests hold them: the same f32 arithmetic in another
summation order, the gated norm's row sums of squares now summed over the
ranks (one psum) and ``out_proj``'s partial products over them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import TOL, assert_close
from repro.configs import get_config as ref_config
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_model
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams

from repro_torch.distributed import run_world

import _torch_sharded_ranks as ranks

MODEL_TOL = 1e-4
F32 = dict(compute_dtype="float32", param_dtype="float32")
# name -> (reference arch, port arch, overrides)
CASES = {"zamba2": ("zamba2_2_7b", "zamba2-2.7b", {}),
         "zamba2_col": ("zamba2_2_7b", "zamba2-2.7b", {"ssm_state": 32}),
         "mamba2": ("mamba2_370m", "mamba2-370m", {})}
PROMPTS = [np.arange(2, 13, dtype=np.int32), np.arange(40, 59, dtype=np.int32)]  # 8 + 3 and 2 x 8 + 3
MAX_NEW = 4


def _ref(name):
    ref_arch, _, kw = CASES[name]
    return dataclasses.replace(ref_config(ref_arch).reduced(), dip_weights=True, **F32, **kw)


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(29)
    cases, want = [], {}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    for i, (name, (_, arch, kw)) in enumerate(CASES.items()):
        rcfg = _ref(name)
        params = ref_model.init_params(jax.random.PRNGKey(i), rcfg)
        x = rng.normal(0, 1, (2, 41, rcfg.d_model)).astype(np.float32)
        toks = rng.integers(0, rcfg.vocab_size, (2, 12))
        rl = jax.tree_util.tree_map(lambda t: t[0], params["layers"])
        c0 = ref_ssm.init_ssm_cache(2, rcfg, jnp.float32)
        y0, c0 = ref_ssm.ssd_block(jnp.asarray(x[:, :-1]), rl, rcfg, cache=c0)
        y1, c1 = ref_ssm.ssd_block(jnp.asarray(x[:, -1:]), rl, rcfg, cache=c0)
        eng = RefEngine(rcfg, params, engine_cfg=RefEngineConfig(slots=2, max_seq=32, prefill_chunk=8))
        for rid, p in enumerate(PROMPTS):
            eng.add_request(p, RefSamplingParams(max_new_tokens=MAX_NEW), rid=rid)
        want[name] = {"block": {"chunk out": y0, "chunk state": c0["state"], "chunk conv": c0["conv"],
                                "decode out": y1, "decode state": c1["state"], "decode conv": c1["conv"]},
                      "logits": np.asarray(ref_model.forward(params, rcfg, tokens=jnp.asarray(toks))[0]),
                      "tokens": eng.run(), "cfg": rcfg}
        cases.append(dict(name=name, cfg=dict(arch=arch, sharding="tp", matmul_backend="dip_tp", **F32, **kw),
                          params=to_np(params), x=x, tokens=[toks], prompts=[p.tolist() for p in PROMPTS],
                          max_new=MAX_NEW))
    return want, run_world(ranks.sharded_model_rank, 2, "tp", cases, timeout=300)


def _own(ref, name, key, cfg, rank):
    """The rank's part of a reference block output: the state's heads, the
    conv history's channels of those heads and the whole B and C; the block
    output whole."""
    a = np.asarray(ref)
    hl = cfg.n_ssm_heads // 2
    if "state" in key:
        return a[:, rank * hl:(rank + 1) * hl]
    if "conv" in key:
        di, p = cfg.d_inner, cfg.ssm_headdim
        return np.concatenate([a[..., rank * hl * p:(rank + 1) * hl * p], a[..., di:]], axis=-1)
    return a


@pytest.mark.parametrize("name", list(CASES))
def test_ssd_block_under_tp_matches_the_reference(served, name):
    want, outs = served
    cfg = want[name]["cfg"]
    kind = "column" if name == "zamba2_col" else "replicated"
    for r, out in enumerate(outs):
        rec = out[name]
        assert rec["leaves"]["layers/in_proj"][1] == kind
        assert rec["ssm_heads"] == (r * cfg.n_ssm_heads // 2, cfg.n_ssm_heads // 2)
        for key, got in rec["block"].items():
            assert_close(got, _own(want[name]["block"][key], name, key, cfg, r), TOL["float32"])
        c = rec["block_counts"]  # in_proj's all-gather (column only), the gated norm's and out_proj's psums
        assert (c["psum"], c["all_gather"], c["launch"]) == (2, int(kind == "column"), 1 + int(kind == "column")), c


# (psum, all_gather, launch) of one forward: the embedding's psum; per Mamba2
# layer the gated norm's and out_proj's psums, in_proj's all-gather where
# column-parallel, out_proj's launch (and in_proj's); per hybrid site wo's and
# w_down's psums and the launches of wq, wo, gate+up and w_down (wk and wv
# replicate at 64 / 2 columns); the logits' all-gather; the lm_head's launch
# (a tied head is no DiP launch)
COUNTS = {"zamba2": (1 + 4 * 2 + 2 * 2, 1, 4 + 2 * 4 + 1),
          "zamba2_col": (1 + 4 * 2 + 2 * 2, 1 + 4, 4 * 2 + 2 * 4 + 1),
          "mamba2": (1 + 2 * 2, 1, 2)}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_under_tp_matches_the_reference(served, name):
    want, outs = served
    for out in outs:
        logits, c = out[name]["forward"][0]
        assert_close(logits, want[name]["logits"], MODEL_TOL)
        assert (c["psum"], c["all_gather"], c["launch"]) == COUNTS[name], c
        assert c["reduce_scatter"] == c["ppermute"] == c["all_to_all"] == 0
    np.testing.assert_array_equal(outs[0][name]["forward"][0][0], outs[1][name]["forward"][0][0])


@pytest.mark.parametrize("name", list(CASES))
def test_engine_under_tp_serves_the_reference_tokens(served, name):
    want, outs = served
    ref = {rid: list(map(int, v)) for rid, v in want[name]["tokens"].items()}
    for out in outs:
        rec = out[name]
        assert {rid: list(map(int, v)) for rid, v in rec["tokens"].items()} == ref
        assert rec["prefill_chunks"] == 2 + 3  # 8 tokens, then the 3-token tail in one call; 8, 8, then 3
        c = rec["decode_counts"]
        assert (c["psum"], c["all_gather"], c["launch"]) == COUNTS[name], c


@pytest.mark.parametrize("name", list(CASES))
def test_pools_hold_the_rank_heads_and_the_draw_is_the_slice(served, name):
    want, outs = served
    cfg = want[name]["cfg"]
    hl, n = cfg.n_ssm_heads // 2, cfg.ssm_state
    for out in outs:
        rec = out[name]
        assert rec["pools"]["state"] == (cfg.n_layers, 2, hl, cfg.ssm_headdim, n)
        assert rec["pools"]["conv"] == (cfg.n_layers, 2, cfg.ssm_conv - 1, hl * cfg.ssm_headdim + 2 * n)
        if cfg.n_heads:  # the hybrid's shared-block pools: the rank's KV heads
            assert rec["attn_pools"]["k"][3] == cfg.n_kv_heads // 2
        leaves = rec["leaves"]
        assert leaves["layers/A_log"][0] == (cfg.n_layers, hl)
        assert leaves["layers/norm"][0] == (cfg.n_layers, hl * cfg.ssm_headdim)
        assert leaves["embed"][0] == (cfg.padded_vocab // 2, cfg.d_model)
        assert rec["draw_equal"]


def test_launch_serve_sharded_tp_hybrid_on_cpu(capsys):
    from repro_torch.launch import serve

    argv = ["--arch", "zamba2-2.7b", "--reduced", "--dtype", "float32", "--requests", "2", "--max-new", "3",
            "--max-seq", "64", "--prefill-chunk", "16", "--prompt-len", "20", "40", "--device", "cpu",
            "--temperature", "0"]
    want = serve.main(argv)
    got = serve.main(argv + ["--sharded", "tp"])
    assert got == want and sorted(got) == [0, 1]
    assert '"transport": "gloo"' in capsys.readouterr().out
