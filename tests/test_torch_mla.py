"""The port's multi-head latent attention against ``repro.models.attention``
on ``deepseek_v2_lite_16b.reduced()`` (4 heads, kv_lora_rank 64, nope 32,
rope 16, v 32) in float32, with the reference's layer-0 weights loaded
through ``params_from_jax``: the naive cache-less form (dense, KV-chunked
and flash-routed attention core), the absorbed form over two chunks of a
dense latent cache, and the paged form over decode steps, each with the
fused rmsnorm prologue and residual the blocks use; and the whole reduced
model's no-cache forward through the engine's flash-routed step function;
``pallas_dip`` against the port's ``dip`` and ``xla`` against ``torch``.

Tolerance: ``TOL["float32"]`` (1e-5) of max(1, max|reference|) — one layer
of f32 arithmetic in another summation order.  The latent caches and
pools are compared with the same bound; the whole model's logits with
``MODEL_TOL`` (1e-4, every layer's f32 roundings carried on).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import TOL, assert_close
from repro.configs import get_config as ref_get
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tf
from repro_torch.api import DipWeight
from repro_torch.configs import get_config as port_get
from repro_torch.convert import params_from_jax
from repro_torch.models import attention
from repro_torch.models import transformer as tf_model

BACKENDS = [("pallas_dip", "dip"), ("xla", "torch")]
MODEL_TOL = 1e-4


@pytest.fixture(scope="module", params=BACKENDS, ids=[b for _, b in BACKENDS])
def layer(request):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_get("deepseek_v2_lite_16b").reduced(), matmul_backend=request.param[0], **kw)
    cfg = dataclasses.replace(port_get("deepseek-v2-lite-16b").reduced(), matmul_backend=request.param[1], **kw)
    params = ref_tf.init_params(jax.random.PRNGKey(5), ref_cfg)
    rl = jax.tree_util.tree_map(lambda t: t[0], params["layers"])
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, cfg, rl, tf_model._layers(tparams["layers"], cfg.n_layers)[0]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.as_tensor(x)


def _fused(cfg, rl, tl, x):
    """The block's kwargs: the attn_norm gain as a prologue where the
    backend fuses it (else x normalized up front) and the residual x."""
    fuse = tf_model._fuses_rmsnorm(cfg)
    if fuse:
        return dict(norm=rl["attn_norm"], residual=jnp.asarray(x)), dict(norm=tl["attn_norm"],
                                                                          residual=torch.as_tensor(x))
    return dict(residual=jnp.asarray(x)), dict(residual=torch.as_tensor(x))


def test_mla_projections_keep_dip_storage(layer):
    _, cfg, rl, tl = layer
    for nm in ("wq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"):
        assert isinstance(tl[nm], DipWeight) == cfg.uses_dip_storage, nm
    if cfg.uses_dip_storage:  # the rope key's 16 columns are padded to one 64-wide tile
        assert tl["w_krope"].storage_shape == (128, 64) and tl["w_krope"].d_out == cfg.qk_rope_head_dim


@pytest.mark.parametrize("route", ["dense", "kv_chunk", "flash"])
def test_naive_prefill_matches_reference(layer, route):
    ref_cfg, cfg, rl, tl = layer
    x = _x((2, 16, cfg.d_model), seed=1)
    (jx, tx), pos = _both(x), np.arange(16)
    rk, tk = _fused(cfg, rl, tl, x)
    kw = dict(kv_chunk=8) if route == "kv_chunk" else dict(attn_backend="flash") if route == "flash" else {}
    want, wc = ref_attn.mla_attention(jx, rl, ref_cfg, positions=jnp.asarray(pos, jnp.int32), **rk, **kw)
    got, c = attention.mla_attention(tx, tl, cfg, positions=torch.as_tensor(pos), **tk, **kw)
    assert wc is None and c is None
    assert_close(got, want, TOL["float32"])


def test_absorbed_form_over_a_latent_cache_matches_reference(layer):
    """Two 8-token chunks into a 32-position cache: the outputs, the
    written latent rows and the untouched tail all match; the absorbed form
    over the cache equals the naive form over the whole prompt."""
    ref_cfg, cfg, rl, tl = layer
    x = _x((1, 16, cfg.d_model), seed=2)
    rcache = ref_attn.init_mla_cache(1, 32, ref_cfg, jnp.float32)
    cache = attention.init_mla_cache(1, 32, cfg, torch.float32, "cpu")
    outs = []
    for c in range(2):
        xc = x[:, 8 * c: 8 * (c + 1)]
        pos = np.arange(8 * c, 8 * (c + 1))
        rk, tk = _fused(cfg, rl, tl, xc)
        want, rcache = ref_attn.mla_attention(jnp.asarray(xc), rl, ref_cfg, positions=jnp.asarray(pos, jnp.int32),
                                              cache=rcache, **rk)
        got, cache = attention.mla_attention(torch.as_tensor(xc), tl, cfg, positions=torch.as_tensor(pos),
                                             cache=cache, attn_backend="flash", **tk)
        assert_close(got, want, TOL["float32"])
        assert cache["pos"] == int(rcache["pos"]) == 8 * (c + 1)
        outs.append(got)
    for nm in ("c_kv", "k_rope"):
        assert_close(cache[nm], rcache[nm], TOL["float32"])
        assert (cache[nm][:, 16:] == 0).all()
    rk, tk = _fused(cfg, rl, tl, x)
    naive, _ = attention.mla_attention(torch.as_tensor(x), tl, cfg, positions=torch.arange(16), **tk)
    torch.testing.assert_close(torch.cat(outs, 1), naive, rtol=1e-4, atol=1e-4)


def test_paged_decode_matches_reference(layer):
    """Five decode steps of two slots with their own positions and block
    tables (slot 0 from position 0, slot 1 from 3), against the reference's
    paged form: outputs and the whole latent pool."""
    ref_cfg, cfg, rl, tl = layer
    nb, bs = 9, 4
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    rpool = ref_attn.init_paged_mla_cache(nb, bs, ref_cfg, jnp.float32)
    pool = attention.init_paged_mla_cache(nb, bs, cfg, torch.float32, device="cpu")
    for t in range(5):
        x = _x((2, 1, cfg.d_model), seed=10 + t)
        pos = np.array([t, 3 + t], np.int32)
        rk, tk = _fused(cfg, rl, tl, x)
        want, rpool = ref_attn.paged_mla_attention(jnp.asarray(x), rl, ref_cfg, positions=jnp.asarray(pos),
                                                   cache=rpool, block_tables=jnp.asarray(tables), **rk)
        got, pool = attention.paged_mla_attention(torch.as_tensor(x), tl, cfg, positions=torch.as_tensor(pos).long(),
                                                  cache=pool, block_tables=torch.as_tensor(tables).long(), **tk)
        assert_close(got, want, TOL["float32"])
    for nm in ("c_kv", "k_rope"):
        assert tuple(pool[nm].shape) == tuple(rpool[nm].shape)
        assert_close(pool[nm], rpool[nm], TOL["float32"])


def test_int8_latent_pools_raise(layer):
    """The int8 latent pools, refused until quantized MLA was ported, now
    serve: one f32 scale per token for c_kv and for k_rope (no head axis),
    and five paged decode steps over them match the reference's paged form
    with the same int8 pools (outputs within TOL; the pools' codes within
    one code of their row's scale, where an f32 sum's last bit moves a
    value across a rounding midpoint; the scales within 1e-5 relative)."""
    ref_cfg, cfg, rl, tl = layer
    nb, bs = 9, 4
    pool = attention.init_paged_mla_cache(nb, bs, cfg, torch.float32, "int8", device="cpu")
    assert {nm: (t.dtype, tuple(t.shape)) for nm, t in pool.items()} == {
        "c_kv": (torch.int8, (nb, bs, cfg.kv_lora_rank)), "k_rope": (torch.int8, (nb, bs, cfg.qk_rope_head_dim)),
        "c_kv_scale": (torch.float32, (nb, bs)), "k_rope_scale": (torch.float32, (nb, bs))}
    stacked = tf_model.init_paged_cache(cfg, nb, bs, kv_quant="int8", device="cpu")["layers"]
    assert {nm: tuple(t.shape) for nm, t in stacked.items()} == {
        nm: (cfg.n_layers,) + tuple(t.shape) for nm, t in pool.items()}
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    rpool = ref_attn.init_paged_mla_cache(nb, bs, ref_cfg, jnp.float32, "int8")
    for t in range(5):
        x = _x((2, 1, cfg.d_model), seed=10 + t)
        pos = np.array([t, 3 + t], np.int32)
        rk, tk = _fused(cfg, rl, tl, x)
        want, rpool = ref_attn.paged_mla_attention(jnp.asarray(x), rl, ref_cfg, positions=jnp.asarray(pos),
                                                   cache=rpool, block_tables=jnp.asarray(tables), kv_quant="int8",
                                                   **rk)
        got, pool = attention.paged_mla_attention(torch.as_tensor(x), tl, cfg, positions=torch.as_tensor(pos).long(),
                                                  cache=pool, block_tables=torch.as_tensor(tables).long(),
                                                  kv_quant="int8", **tk)
        assert_close(got, want, TOL["float32"])
    assert set(pool) == set(rpool)
    for nm in ("c_kv", "k_rope"):
        sc = pool[f"{nm}_scale"][..., None].numpy()
        want_v = np.asarray(rpool[nm], np.float32) * np.asarray(rpool[f"{nm}_scale"])[..., None]
        assert (np.abs(pool[nm].float().numpy() * sc - want_v) <= TOL["float32"] * max(1.0, np.abs(want_v).max())
                + sc).all()
        np.testing.assert_allclose(pool[f"{nm}_scale"].numpy(), np.asarray(rpool[f"{nm}_scale"]), rtol=1e-5)


@pytest.fixture(scope="module", params=BACKENDS, ids=[b for _, b in BACKENDS])
def model(request):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_get("deepseek_v2_lite_16b").reduced(), matmul_backend=request.param[0], **kw)
    cfg = dataclasses.replace(port_get("deepseek-v2-lite-16b").reduced(), matmul_backend=request.param[1], **kw)
    params = ref_tf.init_params(jax.random.PRNGKey(7), ref_cfg)
    return ref_cfg, cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


def test_whole_prompt_forward_without_a_cache_matches_reference(model):
    """The whole-prompt forward with no cache through the engine's step
    function, ``decode_step_fn(cfg, attn_backend="flash")(params, None,
    tokens)``: every layer runs the naive MLA form, whose attention core
    takes the flash route (q and k of nope + rope columns, v of v_head_dim;
    at full width the (192, 128) pair of the tensor-core kernels).  Logits
    against the reference's same call, no cache back; the MoE layers route
    freely (f32 on both sides)."""
    ref_cfg, cfg, params, tparams = model
    toks = np.random.default_rng(3).integers(2, cfg.vocab_size, size=(2, 19)).astype(np.int32)
    want, wc = ref_tf.decode_step_fn(ref_cfg, attn_backend="flash")(params, None, jnp.asarray(toks))
    got, c = tf_model.decode_step_fn(cfg, attn_backend="flash")(tparams, None, torch.as_tensor(toks, dtype=torch.long))
    assert wc is None and c is None
    v = cfg.vocab_size
    assert got.shape == tuple(want.shape)
    assert_close(got[..., :v], np.asarray(want)[..., :v], MODEL_TOL)
    assert (got[..., v:] == -1e30).all()
