"""The port's MoE models served against the reference, on ``reduced()`` of
``deepseek-v2-lite-16b`` (MLA + routed and shared experts) and
``qwen3-moe-235b-a22b`` (GQA + routed experts) in float32, with the
reference's weights loaded through ``params_from_jax``: the whole-model
forward (logits and the summed router aux loss), two chunks of prefill
through the latent / KV cache, paged decode steps, greedy streams of the
``Engine`` against the reference ``Engine``, and packed-vs-solo streams of
the ``Server`` against the reference ``Server``; plus the KV bytes per
block, the storage ``params_from_jax`` keeps, and what the slice refuses.

Tolerance: ``MODEL_TOL`` (1e-4) of max(1, max|reference logit|), as in
test_torch_model.py — two layers of f32 arithmetic in another summation
order; the routing decisions are the reference's (test_torch_moe.py), so
no token changes experts between the two sides.  Token streams are
compared exactly: greedy argmax over logits that agree to about 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import assert_close
from repro.configs import get_config as ref_get
from repro.models import transformer as ref_tf
from repro.runtime import Request as RefRequest
from repro.runtime import Server as RefServer
from repro.runtime import ServerConfig as RefServerConfig
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import kv_cache as ref_kvc
from repro_torch.api import DipWeight, QuantizedDipWeight
from repro_torch.configs import get_config as port_get
from repro_torch.convert import params_from_jax
from repro_torch.device import make_generator
from repro_torch.models import transformer as tf_model
from repro_torch.optim import AdamW
from repro_torch.runtime import Request, Server, ServerConfig
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving import kv_cache as kvc

MODEL_TOL = 1e-4
ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
BACKENDS = [("pallas_dip", "dip"), ("xla", "torch")]


def _configs(name, backends=("pallas_dip", "dip")):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(ref_get(name).reduced(), matmul_backend=backends[0], **kw),
            dataclasses.replace(port_get(name).reduced(), matmul_backend=backends[1], **kw))


def _model(name, backends=("pallas_dip", "dip"), seed=0):
    ref_cfg, cfg = _configs(name, backends)
    params = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


@pytest.fixture(scope="module", params=[(a, b) for a in ARCHS for b in BACKENDS],
                ids=[f"{a}-{b[1]}" for a in ARCHS for b in BACKENDS])
def pair(request):
    return _model(request.param[0], request.param[1])


@pytest.fixture(scope="module", params=ARCHS)
def dip_model(request):
    return _model(request.param)


def _logits_close(got, want, cfg):
    v = cfg.vocab_size
    assert_close(got[..., :v], np.asarray(want)[..., :v], MODEL_TOL)
    assert (got[..., v:] == -1e30).all() and (np.asarray(want)[..., v:] == -1e30).all()


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(2, vocab, size=shape).astype(np.int32)


def test_converted_parameters_keep_their_storage(pair):
    """The MLA projections and the shared experts keep DiP storage byte for
    byte; the router and the expert banks stay plain, as in the reference."""
    ref_cfg, cfg, params, tparams = pair
    lay, rlay = tparams["layers"], params["layers"]
    dip_names = ["lm_head"] + [nm for nm in ("wq", "wk", "wv", "w_dkv", "w_krope", "w_uk", "w_uv", "wo",
                                             "shared_w_gate", "shared_w_up", "shared_w_down") if nm in lay]
    if cfg.use_mla:
        assert {"w_dkv", "w_krope", "w_uk", "w_uv", "shared_w_gate"} <= set(lay) and "wk" not in lay
    for nm in dip_names:
        w, rw = tparams.get(nm, lay.get(nm)), params.get(nm, rlay.get(nm))
        assert isinstance(w, DipWeight) == cfg.uses_dip_storage, nm
        if cfg.uses_dip_storage:
            assert w.storage_shape == rw.storage_shape
            np.testing.assert_array_equal(w.data.numpy(), np.asarray(rw.data))
    for nm in ("router", "w_gate", "w_up", "w_down"):
        assert isinstance(lay[nm], torch.Tensor)
        np.testing.assert_array_equal(lay[nm].numpy(), np.asarray(rlay[nm]))
    assert set(lay) == set(rlay) and tuple(lay["w_gate"].shape) == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                                                   cfg.d_ff_expert)


def test_param_template_matches_reference(dip_model):
    """Every leaf the reference's template has, with its storage shape."""
    ref_cfg, cfg, _, _ = dip_model
    ref_t, t = ref_tf.param_template(ref_cfg), tf_model.param_template(cfg)
    assert set(t["layers"]) == set(ref_t["layers"])
    for nm, leaf in ref_t["layers"].items():
        assert tuple(t["layers"][nm][0]) == tuple(leaf[0]), nm


def test_forward_logits_and_aux(pair):
    ref_cfg, cfg, params, tparams = pair
    toks = _tokens((2, 13), cfg.vocab_size, 0)
    want, _, aux = ref_tf.forward(params, ref_cfg, tokens=jnp.asarray(toks))
    stats = {}
    got, _ = tf_model.forward(tparams, cfg, tokens=torch.as_tensor(toks, dtype=torch.long), moe_trace=stats)
    _logits_close(got, want, cfg)
    assert len(stats["aux"]) == len(stats["dropped"]) == len(stats["ids"]) == cfg.n_layers
    assert_close(sum(stats["aux"]), aux, 1e-5)
    # replaying this run's expert choices gives this run's logits
    again, _ = tf_model.forward(tparams, cfg, tokens=torch.as_tensor(toks, dtype=torch.long),
                                moe_trace={"replay_ids": stats["ids"]})
    assert torch.equal(again, got)


def test_chunked_prefill(pair):
    """Two 8-token chunks through the engine's prefill step (the flash
    route, which MLA's absorbed form ignores) match the reference's chunks
    and its cache.  (A chunk is a routing group of its own, with its own
    capacity, so unlike the dense model it need not equal one whole-prompt
    forward where tokens are dropped.)"""
    ref_cfg, cfg, params, tparams = pair
    toks = _tokens((1, 16), cfg.vocab_size, 1)
    ref_step = ref_tf.decode_step_fn(ref_cfg, attn_backend="flash")
    step = tf_model.decode_step_fn(cfg, attn_backend="flash")
    rcache = ref_tf.init_cache(ref_cfg, 1, 32)
    cache = tf_model.init_cache(cfg, 1, 32, device="cpu")
    assert set(cache["layers"]) == set(rcache["layers"])
    for c in range(2):
        chunk = toks[:, 8 * c: 8 * (c + 1)]
        want, rcache = ref_step(params, rcache, jnp.asarray(chunk))
        got, cache = step(tparams, cache, torch.as_tensor(chunk, dtype=torch.long))
        _logits_close(got, want, cfg)
    for nm, t in cache["layers"].items():
        assert tuple(t.shape) == tuple(rcache["layers"][nm].shape)
        assert_close(t, rcache["layers"][nm], MODEL_TOL)


def test_paged_decode_steps(pair):
    ref_cfg, cfg, params, tparams = pair
    nb, bs = 9, 4
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    rcache = ref_tf.init_paged_cache(ref_cfg, nb, bs, slots=2)
    cache = tf_model.init_paged_cache(cfg, nb, bs, device="cpu")
    ref_step = jax.jit(ref_tf.paged_decode_step_fn(ref_cfg))
    step = tf_model.paged_decode_step_fn(cfg)
    rng = np.random.default_rng(2)
    for t in range(5):
        toks = rng.integers(2, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.array([t, 3 + t], np.int32)
        want, rcache = ref_step(params, rcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables))
        got, cache = step(tparams, cache, torch.as_tensor(toks, dtype=torch.long),
                          torch.as_tensor(pos, dtype=torch.long), torch.as_tensor(tables, dtype=torch.long))
        _logits_close(got, want, cfg)
    assert set(cache["layers"]) == set(rcache["layers"])
    for nm, t in cache["layers"].items():
        assert_close(t, rcache["layers"][nm], MODEL_TOL)


def _prompts(n, lo=3, hi=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, size=int(rng.integers(lo, hi))).astype(np.int32) for _ in range(n)]


def test_greedy_streams_match_reference_engine(dip_model):
    ref_cfg, cfg, params, tparams = dip_model
    prompts = _prompts(4)
    ecfg = dict(slots=3, max_seq=32, prefill_chunk=8)   # 4 requests > 3 slots
    ref_eng = RefEngine(ref_cfg, params, engine_cfg=RefEngineConfig(**ecfg))
    for i, p in enumerate(prompts):
        ref_eng.add_request(p, RefSamplingParams(max_new_tokens=6), rid=i)
    want = ref_eng.run()
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(**ecfg), device="cpu")
    for i, p in enumerate(prompts):
        eng.add_request(p, SamplingParams(max_new_tokens=6), rid=i)
    assert eng.run() == want
    assert eng.last_stats["requests"] == 4 and eng.last_stats["prefill_chunks"] >= 4


def test_server_packed_and_solo_match_reference_server(dip_model):
    """The Server's greedy streams with 3 requests packed into 3 slots
    equal the reference Server's, and each request served alone gives the
    same stream: decode routes each slot's token in a group of its own."""
    ref_cfg, cfg, params, tparams = dip_model
    prompts = _prompts(3, seed=4)
    kw = dict(batch_slots=3, max_seq=32, max_new_tokens=5, temperature=0.0, prefill_chunk=8)
    want = RefServer(ref_cfg, RefServerConfig(**kw), params).serve(
        [RefRequest(rid=i, prompt=p) for i, p in enumerate(prompts)])
    packed = Server(cfg, ServerConfig(**kw), tparams, device="cpu").serve(
        [Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert packed == want
    for i, p in enumerate(prompts):
        solo = Server(cfg, ServerConfig(**dict(kw, batch_slots=1)), tparams, device="cpu")
        assert solo.serve([Request(rid=i, prompt=p)])[i] == packed[i]


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCHS)
def test_bytes_per_block_matches_reference(name, reduced):
    ref_cfg, cfg = ref_get(name), port_get(name)
    if reduced:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    for bs in (4, 16):
        for kvq in ("none", "int8"):
            assert kvc.bytes_per_block(cfg, bs, kvq) == ref_kvc.bytes_per_block(ref_cfg, bs, kvq)
    if name == "deepseek-v2-lite-16b" and not reduced:
        # (kv_lora_rank + rope) x 2 bytes x 27 layers x 16 tokens; int8: x 1 byte, plus an f32
        # scale per token for c_kv and for k_rope
        assert kvc.bytes_per_block(cfg) == (512 + 64) * 2 * 27 * 16 == 497_664
        assert kvc.bytes_per_block(cfg, kv_quant="int8") == 27 * 16 * (512 + 64 + 2 * 4) == 252_288


def test_paged_pool_shapes_and_import(dip_model):
    """A finished prefill's rows land in the slot's blocks of the paged pool
    (the latent pools for MLA), bit for bit."""
    _, cfg, _, tparams = dip_model
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(slots=1, max_seq=32, prefill_chunk=8, block_size=4),
                 device="cpu")
    eng.add_request(np.arange(2, 13, dtype=np.int32), SamplingParams(max_new_tokens=4))
    eng._try_admit()
    while eng._prefilling is not None:
        cache = eng._prefill_cache
        eng._advance_prefill()
    pools, row = eng.kv.pools["layers"], eng.kv.table_row(0)
    names = ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")
    assert set(pools) == set(names)
    for nm in names:
        for p in range(11):
            torch.testing.assert_close(pools[nm][:, row[p // 4], p % 4], cache["layers"][nm][:, 0, p], rtol=0, atol=0)


@pytest.mark.parametrize("what", ["loss", "train_step", "quantize", "kv_int8", "serve_quantize", "serve_kv_int8"])
def test_what_the_slice_refuses(what):
    """Nothing here is refused any more: the loss and a training step run
    (their parity with the reference is in test_torch_train_families.py),
    and the quantized cases serve (test_torch_quant_families.py)."""
    _, cfg = _configs("deepseek-v2-lite-16b", ("xla", "torch"))
    from repro_torch.launch import serve
    if what in ("loss", "train_step"):  # refused until the families trained (test_torch_train_families.py)
        params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")
        toks = torch.arange(2, 10, dtype=torch.long)[None]
        batch = {"tokens": toks, "labels": toks}
        if what == "loss":
            assert torch.isfinite(tf_model.loss_fn(params, cfg, batch))
        else:
            opt = AdamW()
            state, metrics = tf_model.train_step_fn(cfg, opt)({"params": params, "opt_state": opt.init(params),
                                                               "step": 0}, batch)
            assert state["step"] == 1 and torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0
        return
    small = ["--reduced", "--device", "cpu", "--dtype", "float32", "--requests", "2", "--max-new", "3",
             "--max-seq", "32", "--prefill-chunk", "8", "--temperature", "0"]
    if what == "quantize":
        qcfg = dataclasses.replace(cfg, quantization="int8", matmul_backend="dip_int8w")
        lay = tf_model.init_params(qcfg, make_generator(0, "cpu"), device="cpu")["layers"]
        for nm in ("wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo", "shared_w_gate", "shared_w_up",
                   "shared_w_down"):
            assert isinstance(lay[nm], QuantizedDipWeight) and lay[nm].data.dtype == torch.int8, nm
        for nm in ("router", "w_gate", "w_up", "w_down", "attn_norm", "ffn_norm"):
            assert isinstance(lay[nm], torch.Tensor) and lay[nm].dtype == torch.float32, nm
    elif what == "kv_int8":
        params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=1, max_seq=16, kv_quant="int8"), device="cpu")
        pools = eng.kv.pools["layers"]
        assert {nm: t.dtype for nm, t in pools.items()} == {"c_kv": torch.int8, "k_rope": torch.int8,
                                                           "c_kv_scale": torch.float32,
                                                           "k_rope_scale": torch.float32}
        assert pools["c_kv_scale"].shape == pools["c_kv"].shape[:3]
    elif what == "serve_quantize":
        out = serve.main(["--arch", "qwen3-moe-235b-a22b", "--quantize", "fp8_e4m3"] + small)
        assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    else:
        out = serve.main(["--arch", "deepseek-v2-lite-16b", "--kv-quant", "int8"] + small)
        assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())


@pytest.mark.parametrize("name", ARCHS)
def test_launch_serve_moe_on_cpu(name, capsys):
    from repro_torch.launch import serve
    results = serve.main(["--arch", name, "--reduced", "--dtype", "float32", "--requests", "2", "--max-new", "3",
                          "--max-seq", "64", "--prefill-chunk", "16", "--device", "cpu", "--temperature", "0"])
    assert sorted(results) == [0, 1] and all(len(v) == 3 for v in results.values())
    assert '"serve"' in capsys.readouterr().out
