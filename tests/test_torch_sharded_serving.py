"""The tensor-parallel model path (``dip_tp`` over a 2-rank gloo world)
against the reference's single-device model.

* The tiny dense config of ``tests/test_sharded_backends.py:349-352``: the
  port's forward through ``dip_tp`` on the reference's parameters gives the
  reference's single-device logits (atol 5e-2, rtol 5e-3, as ``:374-375``),
  with 2 x n_layers + 2 collectives (one all-reduce after ``wo`` and one
  after ``w_down`` per layer, the embedding's all-reduce, the logits'
  all-gather).
* The reduced llama3-8b in f32: the port's ``Engine(plan=)`` serves the
  reference single-device ``Engine``'s tokens exactly (as
  ``tests/test_serving.py:350-365``), from pools of the rank's KV heads,
  eagerly.
* ``launch.serve --sharded tp`` on the CPU serves the unsharded launcher's
  tokens.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import transformer as ref_model
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams

from repro_torch.distributed import run_world

import _torch_sharded_ranks as ranks

TINY = dict(name="t", family="dense", n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
            head_dim=64, remat="none", compute_dtype="float32", param_dtype="float32", matmul_backend="dip_tp",
            sharding="tp")
REDUCED = dict(compute_dtype="float32", param_dtype="float32")
PROMPTS = [np.arange(2, 9, dtype=np.int32), np.arange(40, 51, dtype=np.int32)]
MAX_NEW = 4


@pytest.fixture(scope="module")
def served():
    key = jax.random.PRNGKey(0)
    tiny = RefArchConfig(**TINY)
    tiny_params = ref_model.init_params(key, tiny)
    toks = np.asarray(jax.random.randint(key, (2, 8), 0, 512), np.int64)
    ref_logits = np.asarray(ref_model.forward(tiny_params, dataclasses.replace(tiny, matmul_backend="xla",
                                                                             sharding="gspmd"), tokens=toks)[0])

    rcfg = dataclasses.replace(ref_config("llama3_8b").reduced(), dip_weights=True, **REDUCED)
    rparams = ref_model.init_params(key, rcfg)
    eng = RefEngine(rcfg, rparams, engine_cfg=RefEngineConfig(slots=2, max_seq=32, prefill_chunk=8))
    for rid, p in enumerate(PROMPTS):
        eng.add_request(p, RefSamplingParams(max_new_tokens=MAX_NEW), rid=rid)
    want = eng.run()

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out = run_world(ranks.serving_rank, 2, TINY, to_np(tiny_params), toks,
                    dict(arch="llama3-8b", sharding="tp", matmul_backend="dip_tp", **REDUCED), to_np(rparams),
                    [p.tolist() for p in PROMPTS], MAX_NEW, timeout=240)
    return dict(ref_logits=ref_logits, want=want, ranks=out, n_layers=tiny.n_layers)


def test_tiny_forward_through_dip_tp_matches_the_reference(served):
    for r in served["ranks"]:
        assert r["kinds"] == {"wq": "column", "wk": "column", "wo": "row", "w_gate": "column", "w_down": "row"}
        np.testing.assert_allclose(r["tiny_logits"], served["ref_logits"], atol=5e-2, rtol=5e-3)
    # every rank holds the whole (all-gathered) logits
    np.testing.assert_array_equal(served["ranks"][0]["tiny_logits"], served["ranks"][1]["tiny_logits"])


def test_tiny_forward_collectives(served):
    n = served["n_layers"]
    for r in served["ranks"]:
        c = r["tiny_counts"]
        assert (c["psum"], c["all_gather"], c["reduce_scatter"], c["ppermute"]) == (2 * n + 1, 1, 0, 0), c
        assert c["launch"] == 6 * n + 1, c  # wq, wk, wv, wo, gate+up, down a layer, and the head


def test_engine_over_two_ranks_serves_the_reference_tokens(served):
    want = {rid: list(map(int, v)) for rid, v in served["want"].items()}
    for r in served["ranks"]:
        got = {rid: list(map(int, v)) for rid, v in r["tokens"].items()}
        assert got == want and all(len(v) == MAX_NEW for v in got.values())


def test_engine_pools_hold_the_rank_heads_and_run_eagerly(served):
    for r in served["ranks"]:
        assert r["pool_heads"] == 1  # the reduced model's 2 KV heads over 2 ranks
        assert r["captured"] is False and "gloo" in r["eager_reason"]
        c = r["decode_counts"]
        assert (c["psum"], c["all_gather"]) == (2 * 2 + 1, 1), c  # 2 layers


def test_launch_serve_sharded_tp_on_cpu(capsys):
    from repro_torch.launch import serve

    argv = ["--arch", "llama3-8b", "--reduced", "--dtype", "float32", "--requests", "2", "--max-new", "3",
            "--max-seq", "64", "--prefill-chunk", "16", "--device", "cpu", "--temperature", "0"]
    want = serve.main(argv)
    got = serve.main(argv + ["--sharded", "tp"])
    assert got == want and sorted(got) == [0, 1]
    assert '"transport": "gloo"' in capsys.readouterr().out
