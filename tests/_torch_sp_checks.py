"""The ``sp`` model path's cases and checks, shared by
``test_torch_sharded_sp.py`` (the dense and ssm families) and
``test_torch_sharded_sp_hybrid.py`` (the hybrid family): one 2-rank gloo
world a file, its cases held against the reference's single-device block,
``forward`` and ``Engine`` (the first file's doc says what and how)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from _torch_parity import TOL, assert_close
from repro.configs import get_config as ref_config
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_model
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams

from repro_torch.distributed import run_world

import _torch_sharded_ranks as ranks

MODEL_TOL = 1e-4
F32 = dict(compute_dtype="float32", param_dtype="float32")
SP = dict(sharding="sp", matmul_backend="dip_sp", **F32)
# name -> (reference arch, port arch, overrides)
CASES = {"llama3": ("llama3_8b", "llama3-8b", {}),
         "mamba2": ("mamba2_370m", "mamba2-370m", {}),
         "zamba2": ("zamba2_2_7b", "zamba2-2.7b", {}),
         "zamba2_col": ("zamba2_2_7b", "zamba2-2.7b", {"ssm_state": 32})}
# M = 1, 3 and 5 (prefixes of one 1 x 5 batch: a causal forward's rows of
# a prefix are the prefix's own) and a 2 x 12 chunk
PREFIXES = (1, 3, 5)
PROMPTS = [np.arange(2, 13, dtype=np.int32), np.arange(40, 59, dtype=np.int32)]  # 8 + 3 and 2 x 8 + 3
MAX_NEW = 4

# (reduce_scatter, ppermute, all_gather, psum, launch, replicated) of one
# forward on 2 ranks: the embedding's reduce-scatter; per dense layer (or
# hybrid site) wq's and gate+up's hops and launches (2 each), wo's and
# w_down's launch and reduce-scatter, wk and wv replicated (an all-gather of
# rows each); per Mamba2 layer out_proj's launch and reduce-scatter, the
# gated norm's psum, in_proj's gather of rows (replicated) or its hop, 2
# launches and gather of columns (column); the head: a separate one's hop,
# 2 launches and gather of vocab, a tied one's gather of rows and of vocab
COUNTS = {"llama3": (1 + 2 * 2, 2 * 2 + 1, 2 * 2 + 1, 0, 2 * 6 + 2, 2 * 2),
          "mamba2": (1 + 2, 0, 2 + 2, 2, 2, 2),
          "zamba2": (1 + 4 + 2 * 2, 2 * 2 + 1, 4 + 2 * 2 + 1, 4, 4 + 2 * 6 + 2, 4 + 2 * 2),
          "zamba2_col": (1 + 4 + 2 * 2, 4 + 2 * 2 + 1, 4 + 2 * 2 + 1, 4, 4 * 3 + 2 * 6 + 2, 2 * 2)}


def ref_cfg(name):
    ref_arch, _, kw = CASES[name]
    return dataclasses.replace(ref_config(ref_arch).reduced(), dip_weights=True, **F32, **kw)


def _ref_block(rcfg, params, x):
    """The reference's layer-0 block on x: the dense block on the whole
    chunk, or the Mamba2 block's chunked prefill into a cache and one O(1)
    decode token."""
    rl = jax.tree_util.tree_map(lambda t: t[0], params["layers"])
    if rcfg.ssm_state:
        c0 = ref_ssm.init_ssm_cache(x.shape[0], rcfg, jnp.float32)
        y0, c0 = ref_ssm.ssd_block(jnp.asarray(x[:, :-1]), rl, rcfg, cache=c0)
        y1, c1 = ref_ssm.ssd_block(jnp.asarray(x[:, -1:]), rl, rcfg, cache=c0)
        return {"chunk out": y0, "chunk state": c0["state"], "chunk conv": c0["conv"],
                "decode out": y1, "decode state": c1["state"], "decode conv": c1["conv"]}
    pos = jnp.arange(x.shape[1])
    rope = ref_layers.rope_tables(pos, rcfg.resolved_head_dim, rcfg.rope_theta)
    y, _, _ = ref_model._transformer_block(jnp.asarray(x), rl, rcfg, positions=pos, rope=rope, cache=None,
                                          kv_chunk=0, constrain=lambda t, tag: t)
    return {"out": y}


def serve(names, seed):
    """The reference's block, logits and engine tokens for each case of
    ``names``, and the 2-rank world's records (``ranks.sp_model_rank``)."""
    rng = np.random.default_rng(seed)
    cases, want = [], {}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    for i, name in enumerate(names):
        _, arch, kw = CASES[name]
        rcfg = ref_cfg(name)
        params = ref_model.init_params(jax.random.PRNGKey(seed + i), rcfg)
        x = rng.normal(0, 1, (2, 41 if rcfg.ssm_state else 12, rcfg.d_model)).astype(np.float32)
        five, chunk = rng.integers(0, rcfg.vocab_size, (1, 5)), rng.integers(0, rcfg.vocab_size, (2, 12))
        toks = [five[:, :n] for n in PREFIXES] + [chunk]
        logits5, logits_chunk = (np.asarray(ref_model.forward(params, rcfg, tokens=jnp.asarray(t))[0])
                                 for t in (five, chunk))
        eng = RefEngine(rcfg, params, engine_cfg=RefEngineConfig(slots=2, max_seq=32, prefill_chunk=8))
        for rid, p in enumerate(PROMPTS):
            eng.add_request(p, RefSamplingParams(max_new_tokens=MAX_NEW), rid=rid)
        want[name] = {"block": _ref_block(rcfg, params, x), "tokens": eng.run(), "cfg": rcfg,
                      "logits": [logits5[:, :n] for n in PREFIXES] + [logits_chunk]}
        cases.append(dict(name=name, cfg=dict(arch=arch, **SP, **kw), params=to_np(params), x=x, tokens=toks,
                          prompts=[p.tolist() for p in PROMPTS], max_new=MAX_NEW, draw=name == "zamba2_col"))
    return want, run_world(ranks.sp_model_rank, 2, cases, timeout=300)


def _rows(parts, shape):
    """The ranks' rows (each m of them) as the real (B, S, .) batch."""
    b, s = shape
    whole = np.concatenate(parts, axis=0)[:b * s]
    return whole.reshape(b, s, whole.shape[-1])


def _own_state(ref, key, cfg, rank):
    """The rank's part of a reference cache: the state's heads, the conv
    history's channels of those heads and the whole B and C."""
    a = np.asarray(ref)
    hl = cfg.n_ssm_heads // 2
    if "state" in key:
        return a[:, rank * hl:(rank + 1) * hl]
    di, p = cfg.d_inner, cfg.ssm_headdim
    return np.concatenate([a[..., rank * hl * p:(rank + 1) * hl * p], a[..., di:]], axis=-1)


def check_block(served, name):
    """Layer 0's block on the ranks' rows against the reference's (the
    output's rows assembled; each rank's heads of the caches), and its
    collectives and launches."""
    want, outs = served
    cfg = want[name]["cfg"]
    ref = want[name]["block"]
    for key in ref:
        if "out" in key:
            shape = np.asarray(ref[key]).shape[:2]
            assert_close(_rows([o[name]["block"][key] for o in outs], shape), np.asarray(ref[key]),
                         TOL["float32"])
        else:
            for r, out in enumerate(outs):
                assert_close(out[name]["block"][key], _own_state(ref[key], key, cfg, r), TOL["float32"])
    for out in outs:
        c = out[name]["block_counts"]
        if cfg.ssm_state:
            # in_proj's hop and gather of columns (or its gather of rows), the
            # gated norm's psum, out_proj's reduce-scatter
            col = name == "zamba2_col"
            assert (c["ppermute"], c["all_gather"], c["psum"], c["reduce_scatter"], c["launch"]) == (
                int(col), 1, 1, 1, 1 + 2 * int(col)), c
        else:
            assert (c["ppermute"], c["all_gather"], c["reduce_scatter"], c["launch"]) == (2, 2, 2, 6), c


def check_forward(served, name):
    """The logits at M = 1, 3, 5 and a chunk against the reference's, equal
    on both ranks, with the collectives, launches and replicated
    dispatches of :data:`COUNTS`."""
    want, outs = served
    for out in outs:
        for (logits, c, rep), ref in zip(out[name]["forward"], want[name]["logits"]):
            assert logits.shape == ref.shape
            assert_close(logits, ref, MODEL_TOL)
            got = (c["reduce_scatter"], c["ppermute"], c["all_gather"], c["psum"], c["launch"], rep)
            assert got == COUNTS[name], (ref.shape, c, rep)
            assert c["all_to_all"] == 0
    for (a, _, _), (b, _, _) in zip(outs[0][name]["forward"], outs[1][name]["forward"]):
        np.testing.assert_array_equal(a, b)


def check_engine(served, name):
    """``Engine(plan=)``'s greedy tokens equal the reference ``Engine``'s;
    a decode step counts the forward's collectives and launches."""
    want, outs = served
    ref = {rid: list(map(int, v)) for rid, v in want[name]["tokens"].items()}
    for out in outs:
        rec = out[name]
        assert {rid: list(map(int, v)) for rid, v in rec["tokens"].items()} == ref
        if want[name]["cfg"].ssm_state:
            assert rec["prefill_chunks"] == 2 + 3  # 8 tokens, then the 3-token tail in one call; 8, 8, then 3
        c = rec["decode_counts"]  # 2 slots, one row a rank
        assert (c["reduce_scatter"], c["ppermute"], c["all_gather"], c["psum"], c["launch"]) == COUNTS[name][:5], c


def check_pools(served, name):
    """The pools and leaves are ``tp``'s: the rank's SSM heads and KV heads,
    its vocab rows of the embedding; the rank's draw is its slice."""
    want, outs = served
    cfg = want[name]["cfg"]
    for out in outs:
        rec = out[name]
        if cfg.ssm_state:
            hl = cfg.n_ssm_heads // 2
            assert rec["pools"]["state"] == (cfg.n_layers, 2, hl, cfg.ssm_headdim, cfg.ssm_state)
            assert rec["pools"]["conv"] == (cfg.n_layers, 2, cfg.ssm_conv - 1,
                                            hl * cfg.ssm_headdim + 2 * cfg.ssm_state)
            assert rec["leaves"]["layers/in_proj"][1] == ("column" if name == "zamba2_col" else "replicated")
        if cfg.n_heads:
            pool = rec["attn_pools"] if cfg.ssm_state else rec["pools"]
            assert pool["k"][3] == cfg.n_kv_heads // 2
        assert rec["leaves"]["embed"][0] == (cfg.padded_vocab // 2, cfg.d_model)
        if name == "zamba2_col":
            assert rec["draw_equal"]
