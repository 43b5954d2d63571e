"""The quantized serving path against the reference: ``llama3_8b.reduced()``
in float32 with the reference's own quantized weights (through
``convert.params_from_jax``), served by the port and by ``repro``, for
``dip_int8w`` with the int8 paged KV cache and for ``dip_fp8``.

Tolerances.  fp8 (weight-only, f32 compute on the CPU): 1e-4 of max(1,
max|reference logit|), as the float model (test_torch_model.py).  int8
(W8A8-dynamic): the same 1e-4, except where an activation code flips — the
two frameworks' f32 norms and sums differ in the last bit, and a value at a
rounding midpoint then lands one code apart — so each logit may also move by
one quantization step of every lm_head input,
``x_scale * sum_k |Q[k, n]| * w_scale[n]``, with ``x_scale`` at its largest:
the lm_head input is RMS-normed, so ``|x| <= sqrt(d) * max|gain|`` and
``x_scale <= sqrt(d) * max|gain| / 127``.  How many logits needed more than
1e-4 is printed.  Greedy tokens are compared exactly, and so are the
KV capacity figures (``bytes_per_block``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import as_np, reduced_configs, reference_params
from repro.models import transformer as ref_tf
from repro.runtime import Server as RefServer
from repro.runtime import ServerConfig as RefServerConfig
from repro.runtime.server import Request as RefRequest
from repro.serving import kv_cache as ref_kvc
from repro_torch.api import QuantizedDipWeight
from repro_torch.convert import params_from_jax
from repro_torch.core import permute
from repro_torch.models import transformer as tf_model
from repro_torch.runtime import Request, Server, ServerConfig
from repro_torch.serving import kv_cache as kvc

MODEL_TOL = 1e-4
CASES = [("int8", "dip_int8w", "int8"), ("fp8_e4m3", "dip_fp8", "none")]


@pytest.fixture(scope="module", params=CASES, ids=[c[1] for c in CASES])
def model(request):
    scheme, backend, kvq = request.param
    ref_cfg, cfg = reduced_configs(backend, backend, quantization=scheme, kv_quant=kvq)
    params, np_params = reference_params(ref_cfg)
    return ref_cfg, cfg, params, params_from_jax(np_params, cfg, device="cpu")


def _head_step(tparams, cfg):
    """Per-logit change when every lm_head activation code moves one step,
    at the largest x_scale an RMS-normed row allows (0 for fp8, which does
    not quantize activations)."""
    head = tparams["lm_head"]
    if cfg.quantization != "int8":
        return 0.0
    x_scale = cfg.d_model ** 0.5 * float(tparams["final_norm"].abs().max()) / 127.0
    colsum = permute.unpermute_tiled(head.data, head.perm_tile).float().abs().sum(0)
    return (x_scale * colsum * head.scale[0]).numpy()[: cfg.vocab_size]


def _logits_within_bound(got, want, cfg, tparams, what):
    v = cfg.vocab_size
    g, w = as_np(got)[..., :v], np.asarray(want)[..., :v]
    err, tol = np.abs(g - w), MODEL_TOL * max(1.0, float(np.abs(w).max()))
    step = _head_step(tparams, cfg)
    print(f"{cfg.quantization} {what}: max|err| {err.max():.3e}, {int((err > tol).sum())} of {err.size} "
          f"logits above {tol:.3e}")
    assert (err <= tol + step).all()
    assert (as_np(got)[..., v:] == -1e30).all()


def test_converted_weights_stay_quantized(model):
    _, cfg, params, tparams = model
    for name in ("wq", "w_gate", "w_down"):
        tw, rw = tparams["layers"][name], params["layers"][name]
        assert isinstance(tw, QuantizedDipWeight) and tw.scheme == cfg.quantization
        assert tw.storage_shape == tuple(rw.storage_shape) and tw.scale.shape == rw.scale.shape
    assert isinstance(tparams["lm_head"], QuantizedDipWeight)


def test_forward_logits(model):
    ref_cfg, cfg, params, tparams = model
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    want, _, _ = ref_tf.forward(params, ref_cfg, tokens=jnp.asarray(toks))
    got, _ = tf_model.forward(tparams, cfg, tokens=torch.as_tensor(toks, dtype=torch.long))
    _logits_within_bound(got, want, cfg, tparams, "forward")


def test_paged_decode_steps_and_int8_pool(model):
    ref_cfg, cfg, params, tparams = model
    nb, bs = 9, 4
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    rcache = ref_tf.init_paged_cache(ref_cfg, nb, bs, slots=2, kv_quant=ref_cfg.kv_quant)
    cache = tf_model.init_paged_cache(cfg, nb, bs, kv_quant=cfg.kv_quant, device="cpu")
    assert sorted(cache["layers"]) == sorted(rcache["layers"])
    ref_step = jax.jit(ref_tf.paged_decode_step_fn(ref_cfg))
    step = tf_model.paged_decode_step_fn(cfg)
    rng = np.random.default_rng(2)
    for t in range(5):
        toks = rng.integers(2, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.array([t, 3 + t], np.int32)
        want, rcache = ref_step(params, rcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables))
        got, cache = step(tparams, cache, torch.as_tensor(toks, dtype=torch.long),
                          torch.as_tensor(pos, dtype=torch.long), torch.as_tensor(tables, dtype=torch.long))
        _logits_within_bound(got, want, cfg, tparams, f"decode step {t}")
    layers = cache["layers"]
    if cfg.kv_quant == "int8":
        for nm in ("k", "v"):
            assert layers[nm].dtype == torch.int8 and layers[f"{nm}_scale"].dtype == torch.float32
            got_kv = layers[nm].float() * layers[f"{nm}_scale"][..., None]
            want_kv = np.asarray(rcache["layers"][nm], np.float32) * np.asarray(rcache["layers"][f"{nm}_scale"])[..., None]
            # one code step (the row's scale) where a code flipped, 1e-4 elsewhere
            step_kv = layers[f"{nm}_scale"][..., None].numpy()
            assert (np.abs(got_kv.numpy() - want_kv) <= MODEL_TOL * max(1.0, np.abs(want_kv).max()) + step_kv).all()
            np.testing.assert_allclose(layers[f"{nm}_scale"].numpy(), np.asarray(rcache["layers"][f"{nm}_scale"]),
                                       rtol=1e-5, atol=1e-7)


def test_server_greedy_tokens_match_reference(model):
    ref_cfg, cfg, params, tparams = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, size=int(n)).astype(np.int32) for n in (5, 11, 7)]
    kw = dict(batch_slots=2, max_seq=48, max_new_tokens=6, temperature=0.0, prefill_chunk=8)
    want = RefServer(ref_cfg, RefServerConfig(**kw), params).serve(
        [RefRequest(rid=i, prompt=p) for i, p in enumerate(prompts)])
    server = Server(cfg, ServerConfig(**kw), tparams, device="cpu")
    got = server.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert server.engine.kv_quant == cfg.kv_quant
    assert {k: list(v) for k, v in got.items()} == {k: [int(t) for t in v] for k, v in want.items()}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_kv_capacity_matches_reference(kv_quant):
    for dtype in ("float32", "bfloat16"):
        ref_cfg, cfg = reduced_configs("pallas_dip", "dip", dtype=dtype, kv_quant=kv_quant)
        assert kvc.bytes_per_block(cfg) == ref_kvc.bytes_per_block(ref_cfg)
        assert kvc.bytes_per_block(cfg, 32, "int8") == ref_kvc.bytes_per_block(ref_cfg, 32, "int8")
        assert kvc.blocks_for_budget(cfg, 10 ** 7) == ref_kvc.blocks_for_budget(ref_cfg, 10 ** 7)
        assert kvc.max_concurrent(cfg, 100, 61) == ref_kvc.max_concurrent(ref_cfg, 100, 61)
        pools = tf_model.init_paged_cache(cfg, 3, cfg.kv_block_size, kv_quant=kv_quant, device="cpu")["layers"]
        # the pools hold exactly bytes_per_block per block
        assert sum(t.numel() * t.element_size() for t in pools.values()) == 3 * kvc.bytes_per_block(cfg)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8_e4m3"])
def test_paged_write_and_read_match_reference(kv_quant):
    """A quantized pool stores each (token, head) row's codes and scale as
    the reference does, byte for byte (fp8 codes move through a byte view:
    torch has no float8 ``index_copy_``), and reads back the same values."""
    from repro.models import attention as ref_attn
    from repro_torch.api import quant
    from repro_torch.models import attention

    nb, bs, kv, hd = 5, 4, 2, 32
    vals = np.random.default_rng(4).normal(size=(6, kv, hd)).astype(np.float32)
    phys = np.array([4, 5, 9, 12, 13, 19])
    rpool = ref_attn.init_paged_gqa_cache(nb, bs, kv, hd, jnp.float32, kv_quant)
    rk, rks = ref_attn.paged_write(rpool["k"], jnp.asarray(phys), jnp.asarray(vals),
                                   scale_pool=rpool["k_scale"], kv_quant=kv_quant)
    pool = attention.init_paged_gqa_cache(nb, bs, kv, hd, torch.float32, kv_quant, device="cpu")
    attention.paged_write(pool["k"], torch.as_tensor(phys), torch.from_numpy(vals),
                          scale_pool=pool["k_scale"], kv_quant=kv_quant)
    assert pool["k"].dtype == quant.scheme_info(kv_quant).storage_dtype
    np.testing.assert_array_equal(pool["k"].view(torch.uint8).numpy(), np.asarray(rk).view(np.uint8))
    np.testing.assert_array_equal(pool["k_scale"].numpy(), np.asarray(rks))
    idx = np.array([[4, 9, 19], [5, 12, 13]])
    want = ref_attn.paged_read(rk, jnp.asarray(idx), scale_pool=rks)
    got = attention.paged_read(pool["k"], torch.as_tensor(idx), scale_pool=pool["k_scale"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
