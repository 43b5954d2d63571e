"""The quantized MoE/MLA, SSM and hybrid families against the reference:
``reduced()`` deepseek-v2-lite-16b, zamba2-2.7b and mamba2-370m in float32,
each with int8 weights (``dip_int8w``) and the int8 KV pool, and with fp8
weights (``dip_fp8``).  The reference's float weights go through its
``quantize_params``; the port gets that quantized tree through
``convert.params_from_jax`` and, separately, quantizes the same float tree
with its own ``quantize_params``.  The int8 models run the reference's
``dip_int8w`` kernel (Pallas in interpret mode); the fp8 ones its ``xla``
path on the same quantized weights, which it dequantizes: fp8 is
weight-only, so both multiply the same f32 activations by the same
dequantized weights, the port's kernel scaling after the sum and the
reference's before it (the reference's fp8 kernel itself is held to the
port's in test_torch_dip_matmul_q.py), which keeps this file's time down.

Tolerances.  Storage, scales, pool codes written from the same rows and the
quantizers are compared byte for byte.  Logits: ``MODEL_TOL`` (1e-4) of
max(1, max|reference logit|), as the float families (test_torch_moe_serving.py,
test_torch_ssm_serving.py), plus, for int8, one quantization step of every
lm_head input (``x_scale * sum_k |Q[k, n]| * w_scale[n]`` at the largest
``x_scale`` an RMS-normed row allows), where an activation code flips
because the two frameworks' f32 sums differ in the last bit — the bound and
its reason as in test_torch_quant_serving.py.  An int8 KV pool's codes may
likewise sit one code (its row's scale) apart; its scales within 1e-5
relative.  The MLA int8 is held against the reference's int8 output, not
against its float model.  Greedy tokens are compared exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import as_np, assert_close
from repro.configs import get_config as ref_get
from repro.models import transformer as ref_tf
from repro.runtime import Request as RefRequest
from repro.runtime import Server as RefServer
from repro.runtime import ServerConfig as RefServerConfig
from repro_torch import api
from repro_torch.api import QuantizedDipWeight
from repro_torch.configs import get_config as port_get
from repro_torch.convert import params_from_jax
from repro_torch.core import permute
from repro_torch.models import transformer as tf_model
from repro_torch.runtime import Request, Server, ServerConfig
from repro_torch.serving import Engine, EngineConfig, SamplingParams

MODEL_TOL = 1e-4
FAMILIES = ["deepseek-v2-lite-16b", "zamba2-2.7b", "mamba2-370m"]
# (scheme, backend, kv_quant): a pure SSM model pages nothing, so its int8 KV changes nothing
SCHEMES = [("int8", "dip_int8w", "int8"), ("fp8_e4m3", "dip_fp8", "none")]
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module", params=FAMILIES)
def float_model(request):
    """The reference's float weights of one family (pallas_dip storage)."""
    name = request.param
    ref_cfg = dataclasses.replace(ref_get(name).reduced(), matmul_backend="pallas_dip", **F32)
    return name, ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)


@pytest.fixture(scope="module", params=SCHEMES, ids=[s[1] for s in SCHEMES])
def model(request, float_model):
    name, float_params = float_model
    scheme, backend, kvq = request.param
    kw = dict(F32, matmul_backend=backend, quantization=scheme, kv_quant=kvq)
    ref_cfg = dataclasses.replace(ref_get(name).reduced(), **kw)
    cfg = dataclasses.replace(port_get(name).reduced(), **kw)
    params = ref_tf.quantize_params(float_params, scheme)
    return ref_cfg, cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


def _ref_run(ref_cfg):
    """The reference configuration the model tests run (see the module
    docstring): int8 on its kernel, fp8 on its dequantizing xla path."""
    return ref_cfg if ref_cfg.quantization == "int8" else dataclasses.replace(ref_cfg, matmul_backend="xla")


def _leaves(t, prefix=""):
    """(path, leaf) pairs of a nested dict whose DiP nodes are leaves."""
    if isinstance(t, dict):
        return [pl for k in sorted(t) for pl in _leaves(t[k], f"{prefix}/{k}")]
    return [(prefix, t)]


def _head_step(tparams, cfg):
    """Per-logit change when every lm_head activation code moves one step
    (0 for fp8, which keeps activations float, and for a tied head, which
    is the float embedding)."""
    head = tparams.get("lm_head")
    if cfg.quantization != "int8" or head is None:
        return 0.0
    x_scale = cfg.d_model ** 0.5 * float(tparams["final_norm"].abs().max()) / 127.0
    colsum = permute.unpermute_tiled(head.data, head.perm_tile).float().abs().sum(0)
    return (x_scale * colsum * head.scale[0]).numpy()[: cfg.vocab_size]


def _logits_within_bound(got, want, cfg, tparams):
    v = cfg.vocab_size
    g, w = as_np(got)[..., :v], np.asarray(want)[..., :v]
    err, tol = np.abs(g - w), MODEL_TOL * max(1.0, float(np.abs(w).max()))
    assert (err <= tol + _head_step(tparams, cfg)).all(), f"max|err| {err.max():.3e} > {tol:.3e}"
    assert (as_np(got)[..., v:] == -1e30).all()


def _pools_close(got, want):
    """Pools leaf for leaf: float ones within MODEL_TOL, int8 codes within
    one code of their row's scale, the scales within 1e-5 relative."""
    assert set(got) == set(want)
    for nm, t in got.items():
        if isinstance(t, dict):
            _pools_close(t, want[nm])
        elif t.dtype == torch.int8:
            sc = got[f"{nm}_scale"][..., None].numpy()
            want_v = np.asarray(want[nm], np.float32) * np.asarray(want[f"{nm}_scale"])[..., None]
            err = np.abs(t.float().numpy() * sc - want_v)
            assert (err <= MODEL_TOL * max(1.0, np.abs(want_v).max()) + sc).all(), nm
        elif nm.endswith("_scale"):
            np.testing.assert_allclose(t.numpy(), np.asarray(want[nm]), rtol=1e-5, atol=1e-7)
        else:
            assert_close(t, want[nm], MODEL_TOL)


def test_param_template_matches_reference(model):
    """The quantized template: every leaf the reference's has, with its
    storage shape; the DiP linears are the quantized ones."""
    ref_cfg, cfg, _, _ = model
    ref_t, t = ref_tf.param_template(ref_cfg), tf_model.param_template(cfg)
    want = {p: tuple(leaf[0]) for p, leaf in _leaves(ref_t)}
    got = {p: tuple(leaf[0]) for p, leaf in _leaves(t)}
    assert got == want


def test_converted_weights_stay_quantized(model):
    """Every reference ``QuantizedDipWeight`` arrives as one of the same
    scheme with its codes and scales byte for byte; everything else (the
    router and expert banks, the SSM scalars, conv and norms, the
    embeddings) stays a float tensor."""
    _, cfg, params, tparams = model
    ref = dict(_leaves(params))
    got = dict(_leaves(tparams))
    assert set(got) == set(ref)
    n_q = 0
    for path, w in got.items():
        rw = ref[path]
        if isinstance(w, QuantizedDipWeight):
            n_q += 1
            assert w.scheme == cfg.quantization and (w.d_in, w.d_out) == (rw.d_in, rw.d_out), path
            np.testing.assert_array_equal(w.data.view(torch.uint8).numpy(), np.asarray(rw.data).view(np.uint8))
            np.testing.assert_array_equal(w.scale.numpy(), np.asarray(rw.scale))
        else:
            assert isinstance(w, torch.Tensor) and w.dtype.is_floating_point, path
            np.testing.assert_array_equal(w.numpy(), np.asarray(rw, np.float32))
    assert n_q > 0
    lay = tparams["layers"]
    if cfg.is_moe:
        for nm in ("wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo", "shared_w_gate", "shared_w_up", "shared_w_down"):
            assert isinstance(lay[nm], QuantizedDipWeight), nm
        for nm in ("router", "w_gate", "w_up", "w_down"):
            assert isinstance(lay[nm], torch.Tensor), nm
    else:
        for nm in ("A_log", "D", "dt_bias", "conv_w", "conv_b", "norm", "norm_in"):
            assert isinstance(lay[nm], torch.Tensor), nm
        assert isinstance(lay["in_proj"], QuantizedDipWeight) and isinstance(lay["out_proj"], QuantizedDipWeight)


def test_port_quantize_params_matches_reference(model, float_model):
    """The port's ``quantize_params`` of the same float weights gives the
    reference's tree, byte for byte: the same nodes quantized, the same
    codes and scales (the in_proj's padded columns at scale 1.0)."""
    ref_cfg, cfg, params, tparams = model
    fcfg = dataclasses.replace(cfg, matmul_backend="dip", quantization="none")
    mine = tf_model.quantize_params(
        params_from_jax(jax.tree_util.tree_map(np.asarray, float_model[1]), fcfg, device="cpu"), cfg.quantization)
    want = dict(_leaves(tparams))
    for path, w in _leaves(mine):
        assert type(w) is type(want[path]), path
        if isinstance(w, QuantizedDipWeight):
            assert torch.equal(w.data.view(torch.uint8), want[path].data.view(torch.uint8)), path
            assert torch.equal(w.scale, want[path].scale), path
            pad = w.scale[..., w.d_out:]
            assert (pad == 1.0).all(), path
        else:
            assert torch.equal(w, want[path]), path


def test_forward_logits(model):
    ref_cfg, cfg, params, tparams = model
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    want = ref_tf.forward(params, _ref_run(ref_cfg), tokens=jnp.asarray(toks))[0]
    got, _ = tf_model.forward(tparams, cfg, tokens=torch.as_tensor(toks, dtype=torch.long))
    _logits_within_bound(got, want, cfg, tparams)


def test_chunked_prefill(model):
    """Two 8-token chunks (and, for the SSM families, one tail token)
    through the engine's prefill step against the reference's, logits and
    caches."""
    ref_cfg, cfg, params, tparams = model
    toks = np.random.default_rng(1).integers(2, cfg.vocab_size, size=(1, 17)).astype(np.int32)
    ref_step = jax.jit(ref_tf.decode_step_fn(_ref_run(ref_cfg), attn_backend="flash"))
    step = tf_model.decode_step_fn(cfg, attn_backend="flash")
    rcache = ref_tf.init_cache(ref_cfg, 1, 32)
    cache = tf_model.init_cache(cfg, 1, 32, device="cpu")
    cuts = [(0, 8), (8, 16)] + ([(16, 17)] if cfg.ssm_state else [])
    for lo, hi in cuts:
        want, rcache = ref_step(params, rcache, jnp.asarray(toks[:, lo:hi]))
        got, cache = step(tparams, cache, torch.as_tensor(toks[:, lo:hi], dtype=torch.long))
        _logits_within_bound(got, want, cfg, tparams)
    _pools_close(cache["layers"], rcache["layers"])


def test_paged_decode_steps_with_int8_pools(model):
    """Paged decode steps over the int8 latent (MLA) or shared-attention
    (hybrid) pools, or the per-slot state pools (SSM), against the
    reference's step: logits, then every pool."""
    ref_cfg, cfg, params, tparams = model
    nb, bs = 9, 4
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    rcache = ref_tf.init_paged_cache(ref_cfg, nb, bs, slots=2, kv_quant=ref_cfg.kv_quant)
    cache = tf_model.init_paged_cache(cfg, nb, bs, kv_quant=cfg.kv_quant, slots=2, device="cpu")
    ref_step = jax.jit(ref_tf.paged_decode_step_fn(_ref_run(ref_cfg)))
    step = tf_model.paged_decode_step_fn(cfg)
    rng = np.random.default_rng(2)
    for t in range(3):
        toks = rng.integers(2, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.array([t, 3 + t], np.int32)
        want, rcache = ref_step(params, rcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables))
        got, cache = step(tparams, cache, torch.as_tensor(toks, dtype=torch.long),
                          torch.as_tensor(pos, dtype=torch.long), torch.as_tensor(tables, dtype=torch.long))
        _logits_within_bound(got, want, cfg, tparams)
    _pools_close(cache["layers"], rcache["layers"])
    if cfg.kv_quant == "int8" and not cfg.is_ssm:
        paged = cache["layers"].get("attn", cache["layers"])
        assert any(t.dtype == torch.int8 for t in paged.values())


def test_server_packed_and_solo_match_reference_server(model):
    """The Server's greedy streams with 3 requests in 2 slots equal the
    reference Server's, and each request served alone gives the same."""
    ref_cfg, cfg, params, tparams = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, size=int(n)).astype(np.int32) for n in (5, 11, 7)]
    kw = dict(batch_slots=2, max_seq=32, max_new_tokens=5, temperature=0.0, prefill_chunk=8)
    want = RefServer(_ref_run(ref_cfg), RefServerConfig(**kw), params).serve(
        [RefRequest(rid=i, prompt=p) for i, p in enumerate(prompts)])
    server = Server(cfg, ServerConfig(**kw), tparams, device="cpu")
    packed = server.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert server.engine.kv_quant == cfg.kv_quant
    assert {k: list(v) for k, v in packed.items()} == {k: [int(t) for t in v] for k, v in want.items()}
    for i, p in enumerate(prompts):
        solo = Server(cfg, ServerConfig(**dict(kw, batch_slots=1)), tparams, device="cpu")
        assert solo.serve([Request(rid=i, prompt=p)])[i] == packed[i]


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "zamba2-2.7b"])
def test_prefill_import_quantizes_the_rows(name):
    """A finished prefill's rows land in the slot's int8 blocks as the
    codes and scales of ``quantize_rows`` of the prefill cache's rows, byte
    for byte: one scale per token for MLA's latent rows, per (token, head)
    for the hybrid's shared-attention k and v."""
    cfg = dataclasses.replace(port_get(name).reduced(), matmul_backend="dip_int8w", quantization="int8",
                              kv_quant="int8", **F32)
    params = tf_model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=1, max_seq=32, prefill_chunk=8, block_size=4),
                 device="cpu")
    eng.add_request(np.arange(2, 13, dtype=np.int32), SamplingParams(max_new_tokens=2))
    eng._try_admit()
    while eng._prefilling is not None:
        cache = eng._prefill_cache
        eng._advance_prefill()
    pools, rows = eng.kv.pools["layers"], cache["layers"]
    if cfg.is_hybrid:
        pools, rows = pools["attn"], rows["attn"]
    row = eng.kv.table_row(0)
    names = ("c_kv", "k_rope") if cfg.use_mla else ("k", "v")
    for nm in names:
        q, sc = api.quant.quantize_rows(rows[nm][:, 0, :11], "int8")
        for p in range(11):
            blk, off = row[p // 4], p % 4
            assert torch.equal(pools[nm][:, blk, off], q[:, p]), (nm, p)
            assert torch.equal(pools[f"{nm}_scale"][:, blk, off], sc[:, p, ..., 0]), (nm, p)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8_e4m3"])
def test_mla_latent_pool_write_and_read_match_reference(kv_quant):
    """MLA's latent pools (no head axis, one scale per token) store each
    row's codes and scale as the reference does, byte for byte, and read
    back the same values."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention

    cfg = port_get("deepseek-v2-lite-16b").reduced()
    ref_cfg = ref_get("deepseek-v2-lite-16b").reduced()
    nb, bs = 5, 4
    phys = np.array([4, 5, 9, 12, 13, 19])
    idx = np.array([[4, 9, 19], [5, 12, 13]])
    rpool = ref_attn.init_paged_mla_cache(nb, bs, ref_cfg, jnp.float32, kv_quant)
    pool = attention.init_paged_mla_cache(nb, bs, cfg, torch.float32, kv_quant, device="cpu")
    assert {nm: tuple(t.shape) for nm, t in pool.items()} == {nm: tuple(t.shape) for nm, t in rpool.items()}
    for nm, width in (("c_kv", cfg.kv_lora_rank), ("k_rope", cfg.qk_rope_head_dim)):
        vals = np.random.default_rng(5).normal(size=(6, width)).astype(np.float32)
        vals[2] = 0.0  # an all-zero row takes the amax floor
        rp, rps = ref_attn.paged_write(rpool[nm], jnp.asarray(phys), jnp.asarray(vals),
                                       scale_pool=rpool[f"{nm}_scale"], kv_quant=kv_quant)
        attention.paged_write(pool[nm], torch.as_tensor(phys), torch.from_numpy(vals),
                              scale_pool=pool[f"{nm}_scale"], kv_quant=kv_quant)
        np.testing.assert_array_equal(pool[nm].view(torch.uint8).numpy(), np.asarray(rp).view(np.uint8))
        np.testing.assert_array_equal(pool[f"{nm}_scale"].numpy(), np.asarray(rps))
        want = ref_attn.paged_read(rp, jnp.asarray(idx), scale_pool=rps)
        got = attention.paged_read(pool[nm], torch.as_tensor(idx), scale_pool=pool[f"{nm}_scale"])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("d_out", [10448, 4384])
def test_padded_columns_match_reference(d_out, scheme):
    """Zamba2's and Mamba2's in_proj widths are not 64-multiples: the
    quantized storage is padded to 10496 / 4416 columns whose scale is 1.0,
    as the reference's ``_pad_cols`` pads it, codes and scales byte for
    byte."""
    from repro import api as ref_api

    w = np.random.default_rng(6).normal(size=(64, d_out)).astype(np.float32)
    rq = ref_api.quant.quantize(jnp.asarray(w), scheme)
    q = api.quant.quantize(torch.from_numpy(w), scheme)
    assert tuple(q.data.shape) == tuple(rq.data.shape) == (64, -(-d_out // 64) * 64)
    np.testing.assert_array_equal(q.data.view(torch.uint8).numpy(), np.asarray(rq.data).view(np.uint8))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(rq.scale))
    assert (q.scale[:, d_out:] == 1.0).all()
