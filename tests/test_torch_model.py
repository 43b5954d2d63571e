"""The port's dense transformer against ``repro.models.transformer`` on
``llama3_8b.reduced()`` in float32, with the reference's own weights loaded
through ``repro_torch.convert.params_from_jax``: the forward logits, two
chunks of flash-attention prefill, and a run of paged decode steps.

Tolerance: 1e-4 of max(1, max|reference logit|) over the real vocabulary
lanes — two layers of f32 arithmetic in another summation order (each
matmul agrees to about 1e-5, see test_torch_dip_matmul.py).  The padded
vocabulary lanes must be -1e30 on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import assert_close, reduced_configs, reference_params
from repro.models import transformer as ref_tf
from repro_torch.api import DipWeight
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tf_model

MODEL_TOL = 1e-4
BACKENDS = [("pallas_dip", "dip"), ("xla", "torch")]


@pytest.fixture(scope="module", params=BACKENDS, ids=[b for _, b in BACKENDS])
def pair(request):
    ref_cfg, cfg = reduced_configs(*request.param)
    params, np_params = reference_params(ref_cfg)
    return ref_cfg, cfg, params, params_from_jax(np_params, cfg, device="cpu")


def _logits_close(got, want, cfg):
    v = cfg.vocab_size
    assert_close(got[..., :v], np.asarray(want)[..., :v], MODEL_TOL)
    assert (got[..., v:] == -1e30).all() and (np.asarray(want)[..., v:] == -1e30).all()


def test_converted_parameters_keep_dip_storage(pair):
    ref_cfg, cfg, params, tparams = pair
    assert isinstance(tparams["lm_head"], DipWeight) == cfg.uses_dip_storage
    if cfg.uses_dip_storage:
        wq = tparams["layers"]["wq"]
        assert wq.storage_shape == params["layers"]["wq"].storage_shape
        np.testing.assert_array_equal(wq.data.numpy(), np.asarray(params["layers"]["wq"].data))


def test_forward_logits(pair):
    ref_cfg, cfg, params, tparams = pair
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    want, _, _ = ref_tf.forward(params, ref_cfg, tokens=jnp.asarray(toks))
    got, _ = tf_model.forward(tparams, cfg, tokens=torch.as_tensor(toks, dtype=torch.long))
    assert got.shape == want.shape
    _logits_close(got, want, cfg)


def test_chunked_prefill_through_flash(pair):
    ref_cfg, cfg, params, tparams = pair
    toks = np.random.default_rng(1).integers(2, cfg.vocab_size, size=(1, 16)).astype(np.int32)
    ref_step = ref_tf.decode_step_fn(ref_cfg, attn_backend="flash")
    step = tf_model.decode_step_fn(cfg, attn_backend="flash")
    rcache = ref_tf.init_cache(ref_cfg, 1, 32)
    cache = tf_model.init_cache(cfg, 1, 32, device="cpu")
    for c in range(2):
        chunk = toks[:, 8 * c: 8 * (c + 1)]
        want, rcache = ref_step(params, rcache, jnp.asarray(chunk))
        got, cache = step(tparams, cache, torch.as_tensor(chunk, dtype=torch.long))
        _logits_close(got, want, cfg)
        assert cache["pos"] == int(rcache["pos"]) == 8 * (c + 1)
    assert_close(cache["layers"]["k"], rcache["layers"]["k"], MODEL_TOL)
    # the prefill chunks equal one dense forward over the whole prompt
    full, _ = tf_model.forward(tparams, cfg, tokens=torch.as_tensor(toks, dtype=torch.long))
    torch.testing.assert_close(got, full[:, 8:], rtol=1e-4, atol=1e-4)


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
    for nm in ("k", "v"):
        assert_close(cache["layers"][nm], rcache["layers"][nm], MODEL_TOL)
