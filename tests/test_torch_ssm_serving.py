"""The port's SSM and hybrid models served against the reference, on
``reduced()`` of ``mamba2-370m`` (2 Mamba2 layers, tied embeddings) and
``zamba2-2.7b`` (4 Mamba2 layers, the shared attention+FFN block after
layers 2 and 4) in float32, with the reference's weights loaded through
``params_from_jax``: the parameter layout leaf for leaf, the whole-model
forward (the tied head included), two chunks of prefill through the
state and KV caches, paged decode steps over the per-slot state pools,
prompts of ``chunk - 1``, ``chunk`` and ``chunk + 1`` tokens through the
engine's single-token prefill tail, greedy streams of the ``Engine``
against the reference ``Engine``, and packed-vs-solo streams of the
``Server`` against the reference ``Server``; plus the KV bytes per block,
``blocks_for_budget``, the prefill import into the per-slot pools, and what
the slice refuses.

Tolerance: ``MODEL_TOL`` (1e-4) of max(1, max|reference logit|), as in
test_torch_model.py: a few layers of f32 arithmetic in another summation
order, carried through the recurrent state; the caches and pools (conv
history, f32 state, K/V) are held to the same bound.  Token streams are
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
ARCHS = ["mamba2-370m", "zamba2-2.7b"]
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


def _tree_close(got, want, tol):
    """Every leaf of a (nested) cache dict, shape for shape."""
    assert set(got) == set(want)
    for nm, t in got.items():
        if isinstance(t, dict):
            _tree_close(t, want[nm], tol)
        else:
            assert tuple(t.shape) == tuple(want[nm].shape), nm
            assert_close(t, want[nm], tol)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_param_template_matches_reference(name, reduced):
    """Every leaf of the reference's template, with its storage shape: no
    ``lm_head`` under tied embeddings, the unstacked ``shared_attn`` subtree
    for the hybrid, the padded DiP storage of in_proj (10448 -> 10496
    columns for zamba2, 4384 -> 4416 for mamba2)."""
    ref_cfg, cfg = ref_get(name), port_get(name)
    if reduced:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    ref_cfg, cfg = (dataclasses.replace(c, matmul_backend=b) for c, b in ((ref_cfg, "pallas_dip"), (cfg, "dip")))
    ref_t, t = ref_tf.param_template(ref_cfg), tf_model.param_template(cfg)
    assert set(t) == set(ref_t)
    assert ("lm_head" in t) == (not cfg.tie_embeddings) and ("shared_attn" in t) == cfg.is_hybrid
    for sub in [k for k in t if isinstance(t[k], dict)]:
        assert set(t[sub]) == set(ref_t[sub])
        for nm, leaf in ref_t[sub].items():
            assert tuple(t[sub][nm][0]) == tuple(leaf[0]), (sub, nm)
            assert (t[sub][nm][3] is None) == (len(leaf) < 4 or leaf[3] is None), (sub, nm)
    if not reduced:
        width = {"zamba2-2.7b": (2560, 10496), "mamba2-370m": (1024, 4416)}[name]
        assert tuple(t["layers"]["in_proj"][0]) == (cfg.n_layers,) + width


def test_converted_parameters_keep_their_storage(pair):
    """in_proj / out_proj (and the shared block's linears) keep DiP storage
    byte for byte; the SSM scalars, norms and conv stay plain tensors; a
    tied model has no lm_head."""
    ref_cfg, cfg, params, tparams = pair
    assert set(tparams) == set(params)
    lay, rlay = tparams["layers"], params["layers"]
    for nm in ("in_proj", "out_proj"):
        assert isinstance(lay[nm], DipWeight) == cfg.uses_dip_storage
        if cfg.uses_dip_storage:
            np.testing.assert_array_equal(lay[nm].data.numpy(), np.asarray(rlay[nm].data))
    for nm in ("A_log", "dt_bias", "D", "conv_w", "conv_b", "norm", "norm_in"):
        assert isinstance(lay[nm], torch.Tensor)
        np.testing.assert_array_equal(lay[nm].numpy(), np.asarray(rlay[nm]))
    assert ("lm_head" in tparams) == (not cfg.tie_embeddings)
    if cfg.is_hybrid:
        assert set(tparams["shared_attn"]) == set(params["shared_attn"])
        assert isinstance(tparams["shared_attn"]["w_gate"], DipWeight) == cfg.uses_dip_storage


def test_forward_logits(pair):
    ref_cfg, cfg, params, tparams = pair
    toks = _tokens((2, 45), cfg.vocab_size, 0)  # 45: one chunk of 32 and a padded one
    want, _, _ = ref_tf.forward(params, ref_cfg, tokens=jnp.asarray(toks))
    got, _ = tf_model.forward(tparams, cfg, tokens=torch.as_tensor(toks, dtype=torch.long))
    _logits_close(got, want, cfg)


def test_chunked_prefill(pair):
    """Two 8-token chunks and one single token through the engine's prefill
    step (flash-routed shared attention for the hybrid) match the
    reference's logits and its caches: conv history, state and K/V."""
    ref_cfg, cfg, params, tparams = pair
    toks = _tokens((1, 17), cfg.vocab_size, 1)
    ref_step = ref_tf.decode_step_fn(ref_cfg, attn_backend="flash")
    step = tf_model.decode_step_fn(cfg, attn_backend="flash")
    rcache = ref_tf.init_cache(ref_cfg, 1, 32)
    cache = tf_model.init_cache(cfg, 1, 32, device="cpu")
    for lo, hi in ((0, 8), (8, 16), (16, 17)):
        chunk = toks[:, lo:hi]
        want, rcache = ref_step(params, rcache, jnp.asarray(chunk))
        got, cache = step(tparams, cache, torch.as_tensor(chunk, dtype=torch.long))
        _logits_close(got, want, cfg)
        assert cache["pos"] == int(rcache["pos"]) == hi
    _tree_close(cache["layers"], rcache["layers"], MODEL_TOL)


def test_paged_decode_steps(pair):
    """Decode steps over two slots: each slot's row of the state pools, and
    the hybrid's paged K/V, as the reference's."""
    ref_cfg, cfg, params, tparams = pair
    nb, bs = 9, 4
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    rcache = ref_tf.init_paged_cache(ref_cfg, nb, bs, slots=2)
    cache = tf_model.init_paged_cache(cfg, nb, bs, slots=2, device="cpu")
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
    _tree_close(cache["layers"], rcache["layers"], MODEL_TOL)


def _prompts(n, lo=3, hi=12, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    lengths = lengths or [int(rng.integers(lo, hi)) for _ in range(n)]
    return [rng.integers(2, 512, size=m).astype(np.int32) for m in lengths]


def _engine_streams(ref_cfg, cfg, params, tparams, prompts, ecfg, max_new=6):
    ref_eng = RefEngine(ref_cfg, params, engine_cfg=RefEngineConfig(**ecfg))
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(**ecfg), device="cpu")
    for e, sp in ((ref_eng, RefSamplingParams), (eng, SamplingParams)):
        for i, p in enumerate(prompts):
            e.add_request(p, sp(max_new_tokens=max_new), rid=i)
    return ref_eng, ref_eng.run(), eng, eng.run()


def test_greedy_streams_match_reference_engine(dip_model):
    ref_cfg, cfg, params, tparams = dip_model
    ecfg = dict(slots=3, max_seq=32, prefill_chunk=8)   # 4 requests > 3 slots
    _, want, eng, got = _engine_streams(ref_cfg, cfg, params, tparams, _prompts(4), ecfg)
    assert got == want
    assert eng.last_stats["requests"] == 4 and eng.last_stats["prefill_chunks"] >= 4


def test_prefill_tail_runs_token_by_token(dip_model):
    """Prompts of chunk - 1, chunk and chunk + 1 tokens (chunk 8): the tail
    past the last whole chunk goes through the O(1) path one token at a
    time, never padded; the streams equal the reference Engine's, and the
    prefill calls are counted by their widths."""
    ref_cfg, cfg, params, tparams = dip_model
    ecfg = dict(slots=3, max_seq=32, prefill_chunk=8)
    prompts = _prompts(3, lengths=[7, 8, 9], seed=5)
    ref_eng = RefEngine(ref_cfg, params, engine_cfg=RefEngineConfig(**ecfg))
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(**ecfg), device="cpu")
    widths, fwd = [], eng._prefill_fwd

    def counted(params_, cache, tokens):
        widths.append(int(tokens.shape[1]))
        return fwd(params_, cache, tokens)

    eng._prefill_fwd = counted
    for e, sp in ((ref_eng, RefSamplingParams), (eng, SamplingParams)):
        for i, p in enumerate(prompts):
            e.add_request(p, sp(max_new_tokens=5), rid=i)
    assert eng.run() == ref_eng.run()
    assert widths == [1] * 7 + [8] + [8, 1]


def test_server_packed_and_solo_match_reference_server(dip_model):
    """The Server's greedy streams with 3 requests packed into 3 slots
    equal the reference Server's, and each request served alone gives the
    same stream: every slot's state is its own row of the pools."""
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
    if not reduced:
        # zamba2: 9 shared-attention instances x 16 tokens x (k, v) x 32 heads x 80 x 2 bytes; int8:
        # x 1 byte, plus an f32 scale per (token, head) for k and v
        assert kvc.bytes_per_block(cfg) == (9 * 16 * 2 * 32 * 80 * 2 if cfg.is_hybrid else 0)
        assert 9 * 16 * (2 * 32 * 80 + 2 * 32 * 4) == 774_144
        assert kvc.bytes_per_block(cfg, kv_quant="int8") == (774_144 if cfg.is_hybrid else 0)
    if cfg.is_ssm:
        with pytest.raises(ValueError, match="no paged KV bytes"):
            kvc.blocks_for_budget(cfg, 2**30)
        with pytest.raises(ValueError):
            ref_kvc.blocks_for_budget(ref_cfg, 2**30)
    else:
        assert kvc.blocks_for_budget(cfg, 2**30) == ref_kvc.blocks_for_budget(ref_cfg, 2**30)


@pytest.mark.parametrize("name", ARCHS)
def test_state_pools_cost_what_the_reference_says(name):
    """Per-slot state bytes at full width, from the pool shapes (no
    allocation): zamba2 54 x (3 x 5248 x 2 + 80 x 64 x 64 x 4), mamba2 48 x
    (3 x 2304 x 2 + 32 x 64 x 128 x 4)."""
    cfg = dataclasses.replace(port_get(name), param_dtype="bfloat16", compute_dtype="bfloat16")
    pools = tf_model.init_paged_cache(cfg, 2, 16, slots=1, device="meta")["layers"]
    per_slot = sum(pools[nm].numel() * pools[nm].element_size() for nm in ("conv", "state"))
    assert per_slot == {"zamba2-2.7b": 72_479_232, "mamba2-370m": 50_995_200}[name]
    assert ("attn" in pools) == cfg.is_hybrid
    if cfg.is_hybrid:
        assert tuple(pools["attn"]["k"].shape) == (9, 2, 16, 32, 80)


def test_paged_pools_and_import(dip_model):
    """A finished prefill's conv history and state land in the slot's row of
    the per-slot pools bit for bit (another slot's row untouched), and the
    hybrid's shared-block K/V rows in the slot's blocks; a pure SSM model
    allocates no block."""
    _, cfg, _, tparams = dip_model
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(slots=2, max_seq=32, prefill_chunk=8, block_size=4),
                 device="cpu")
    eng.add_request(np.arange(2, 13, dtype=np.int32), SamplingParams(max_new_tokens=4))
    eng._try_admit()
    while eng._prefilling is not None:
        cache = eng._prefill_cache
        eng._advance_prefill()
    pools = eng.kv.pools["layers"]
    assert set(pools) == ({"conv", "state", "attn"} if cfg.is_hybrid else {"conv", "state"})
    for nm in ("conv", "state"):
        torch.testing.assert_close(pools[nm][:, 0], cache["layers"][nm][:, 0], rtol=0, atol=0)
        assert not pools[nm][:, 1].any()
    if cfg.is_hybrid:
        row = eng.kv.table_row(0)
        for nm in ("k", "v"):
            for p in range(11):
                torch.testing.assert_close(pools["attn"][nm][:, row[p // 4], p % 4],
                                           cache["layers"]["attn"][nm][:, 0, p], rtol=0, atol=0)
    else:
        assert eng.kv.owned == [[], []] and eng.kv.allocator.num_free == eng.kv.num_blocks - 1


@pytest.mark.parametrize("what", ["loss", "train_step", "quantize", "kv_int8", "serve_quantize", "serve_kv_int8",
                                  "no_slots"])
@pytest.mark.parametrize("name", ARCHS)
def test_what_the_slice_refuses(name, what):
    """A pool without slots is refused; the loss and a training step run
    (their parity with the reference is in test_torch_train_families.py),
    and the quantized cases serve (test_torch_quant_families.py)."""
    _, cfg = _configs(name, ("xla", "torch"))
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
    if what == "no_slots":
        with pytest.raises(ValueError, match="slots"):
            tf_model.init_paged_cache(cfg, 4, 4, device="cpu")
        return
    small = ["--arch", name, "--reduced", "--device", "cpu", "--dtype", "float32", "--requests", "2",
             "--max-new", "3", "--max-seq", "32", "--prefill-chunk", "8", "--temperature", "0"]
    if what == "quantize":
        # the projections are quantized; the SSM scalars, conv, norms and embedding stay float
        qcfg = dataclasses.replace(cfg, quantization="int8", matmul_backend="dip_int8w")
        params = tf_model.init_params(qcfg, make_generator(0, "cpu"), device="cpu")
        lay = params["layers"]
        for nm in ("in_proj", "out_proj"):
            assert isinstance(lay[nm], QuantizedDipWeight) and lay[nm].data.dtype == torch.int8, nm
        for nm in ("A_log", "D", "dt_bias", "conv_w", "conv_b", "norm", "norm_in"):
            assert isinstance(lay[nm], torch.Tensor) and lay[nm].dtype == torch.float32, nm
        assert params["embed"].dtype == torch.float32
        # mamba2's tied head is the embedding; zamba2's separate head is a projection
        assert isinstance(params["lm_head"], QuantizedDipWeight) if not cfg.tie_embeddings else "lm_head" not in params
        if cfg.is_hybrid:
            assert all(isinstance(params["shared_attn"][nm], QuantizedDipWeight)
                       for nm in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    elif what == "kv_int8":
        params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=1, max_seq=16, kv_quant="int8"), device="cpu")
        pools = eng.kv.pools["layers"]
        # a pure SSM model pages nothing: int8 KV changes nothing there
        assert pools["state"].dtype == torch.float32 and eng.kv_quant == "int8"
        if cfg.is_hybrid:
            assert {nm: t.dtype for nm, t in pools["attn"].items()} == {
                "k": torch.int8, "v": torch.int8, "k_scale": torch.float32, "v_scale": torch.float32}
        else:
            assert "attn" not in pools
    elif what == "serve_quantize":
        out = serve.main(small + ["--quantize", "int8"])
        assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    else:
        out = serve.main(small + ["--kv-quant", "int8"])
        assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())


def test_stub_frontends_stay_refused():
    """No longer refused: a frontend only changes what training feeds the
    model (embeddings), so the template is the configuration's own."""
    _, cfg = _configs("zamba2-2.7b", ("xla", "torch"))
    shapes = {k: v[0] for k, v in tf_model.param_template(cfg)["layers"].items()}
    stub = tf_model.param_template(dataclasses.replace(cfg, frontend="vision_stub"))
    assert {k: v[0] for k, v in stub["layers"].items()} == shapes and "shared_attn" in stub


@pytest.mark.parametrize("name", ARCHS)
def test_launch_serve_ssm_on_cpu(name, capsys):
    from repro_torch.launch import serve
    results = serve.main(["--arch", name, "--reduced", "--dtype", "float32", "--requests", "2", "--max-new", "3",
                          "--max-seq", "64", "--prefill-chunk", "16", "--device", "cpu", "--temperature", "0"])
    assert sorted(results) == [0, 1] and all(len(v) == 3 for v in results.values())
    assert '"serve"' in capsys.readouterr().out
