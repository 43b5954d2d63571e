"""The port's configurations and permutation helpers against the reference.

* Every architecture of the reference resolves through
  ``repro_torch.configs.get_config`` with the same fields and values, full
  and ``reduced()``; ``ShapeCell`` / ``SHAPE_CELLS``, ``shape_cells_for``,
  ``linear_dims``, ``matmul_shapes`` and ``stage_matmul_shapes`` give the
  reference's answers (exact).
* The new dense configurations serve: ``yi-9b`` (GQA kv = 4) and
  ``codeqwen1.5-7b`` (MHA with QKV bias) at ``reduced()`` in float32 on the
  ``dip`` path with the reference's DiP-stored weights, greedy tokens packed
  and solo equal to the reference ``Server``'s (exact), which serves the
  same weights on its ``xla`` path (it de-shears them; the DiP kernels
  themselves are held to the reference's in test_torch_dip_matmul.py).  The stub-frontend
  configurations (``phi-3-vision-4.2b``, ``musicgen-medium``) serve from
  tokens the same way, as the reference's ``Server`` serves them.
* ``permute_weights``, ``unpermute_weights`` and ``rotate_rows_left`` equal
  the reference's, bit for bit (they move elements only).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.core import permute as ref_permute
from repro.models import transformer as ref_tf
from repro.runtime import Request as RefRequest
from repro.runtime import Server as RefServer
from repro.runtime import ServerConfig as RefServerConfig
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core import permute
from repro_torch.runtime import Request, Server, ServerConfig

NAMES = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "mamba2-370m", "llama3-8b", "codeqwen1.5-7b", "yi-9b",
         "qwen2-72b", "phi-3-vision-4.2b", "musicgen-medium", "zamba2-2.7b"]


def test_registry_lists_every_reference_architecture():
    assert configs.ALL_ARCHS == ref_configs.ALL_ARCHS
    assert sorted(NAMES) == sorted(ref_configs._ALIASES) == sorted(configs._ALIASES)
    with pytest.raises(KeyError, match="unknown architecture"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_match_reference(name):
    ref, cfg = ref_configs.get_config(name), configs.get_config(name)
    assert configs.get_config(configs._ALIASES[name]) is cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced())
    for attr in ("padded_vocab", "is_moe", "is_ssm", "is_hybrid", "sub_quadratic"):
        assert getattr(cfg, attr) == getattr(ref, attr), attr
    if cfg.n_heads:
        assert cfg.resolved_head_dim == ref.resolved_head_dim
    assert cfg.param_count() == ref.param_count()


@pytest.mark.parametrize("name", NAMES)
def test_shapes_match_reference(name):
    ref, cfg = ref_configs.get_config(name), configs.get_config(name)
    assert configs.SHAPE_CELLS == tuple(configs.ShapeCell(*dataclasses.astuple(c)) for c in ref_configs.SHAPE_CELLS)
    assert [dataclasses.astuple(c) for c in configs.shape_cells_for(cfg)] == [
        dataclasses.astuple(c) for c in ref_configs.shape_cells_for(ref)]
    assert configs.linear_dims(cfg) == ref_configs.linear_dims(ref)
    assert [tuple(s) for s in configs.matmul_shapes(cfg, tokens=256)] == [
        tuple(s) for s in ref_configs.matmul_shapes(ref, tokens=256)]
    from repro.configs.shapes import stage_matmul_shapes as ref_stage
    from repro_torch.configs.shapes import stage_matmul_shapes
    kw = dict(train_tokens=4096, prefill_tokens=256, decode_slots=4)
    assert {k: [tuple(s) for s in v] for k, v in stage_matmul_shapes(cfg, **kw).items()} == {
        k: [tuple(s) for s in v] for k, v in ref_stage(ref, **kw).items()}


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "musicgen-medium"])
def test_stub_frontends_are_refused_for_serving(name):
    """No longer refused: the stub-frontend configurations serve from tokens,
    as the reference's ``Server`` serves them (their frontends stay stubs:
    training feeds precomputed embeddings, test_torch_train_families.py)."""
    _serves_as_the_reference_server(name, requests=2)


@pytest.mark.parametrize("name", ["yi-9b", "codeqwen1.5-7b"])
def test_dense_configs_serve_as_the_reference_server(name):
    _serves_as_the_reference_server(name)


def _serves_as_the_reference_server(name, requests=3):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_configs.get_config(name).reduced(), matmul_backend="pallas_dip", **kw)
    cfg = dataclasses.replace(configs.get_config(name).reduced(), matmul_backend="dip", **kw)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    if cfg.qkv_bias:
        assert {"bq", "bk", "bv"} <= set(tparams["layers"])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, size=int(n)).astype(np.int32) for n in (5, 11, 7)[:requests]]
    kw = dict(batch_slots=2, max_seq=32, max_new_tokens=5, temperature=0.0, prefill_chunk=8)
    want = RefServer(dataclasses.replace(ref_cfg, matmul_backend="xla"), RefServerConfig(**kw), params).serve(
        [RefRequest(rid=i, prompt=p) for i, p in enumerate(prompts)])
    packed = Server(cfg, ServerConfig(**kw), tparams, device="cpu").serve(
        [Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert {k: list(v) for k, v in packed.items()} == {k: [int(t) for t in v] for k, v in want.items()}
    for i, p in enumerate(prompts):
        solo = Server(cfg, ServerConfig(**dict(kw, batch_slots=1)), tparams, device="cpu")
        assert solo.serve([Request(rid=i, prompt=p)])[i] == packed[i]


@pytest.mark.parametrize("shape", [(7, 5), (64, 64), (100, 130), (3, 48, 40)])
def test_permute_weights_match_reference(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    p = permute.permute_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref_permute.permute_weights(jnp.asarray(w))))
    back = permute.unpermute_weights(p)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref_permute.unpermute_weights(jnp.asarray(p.numpy()))))
    np.testing.assert_array_equal(back.numpy(), w)
    if len(shape) == 2:
        np.testing.assert_array_equal(p.numpy(), permute.permute_weights_np(w))


def test_permute_weights_moves_fp8_and_int8_codes():
    w = torch.randint(-127, 128, (70, 66), dtype=torch.int8)
    f8 = (w.float() / 64).to(torch.float8_e4m3fn)
    for t in (w, f8):
        p = permute.permute_weights(t)
        assert p.dtype == t.dtype
        assert torch.equal(permute.unpermute_weights(p).view(torch.uint8), t.view(torch.uint8))
        want = ref_permute.permute_weights(jnp.asarray(t.view(torch.uint8).numpy()))
        np.testing.assert_array_equal(p.view(torch.uint8).numpy(), np.asarray(want))


@pytest.mark.parametrize("shift", [0, 1, 5, 64, 70])
def test_rotate_rows_left_matches_reference(shift):
    x = np.arange(2 * 3 * 64, dtype=np.float32).reshape(2, 3, 64)
    got = permute.rotate_rows_left(torch.from_numpy(x), shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_permute.rotate_rows_left(jnp.asarray(x), shift)))
