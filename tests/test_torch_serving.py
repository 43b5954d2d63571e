"""The port's serving engine against ``repro.serving``: the block
allocator's and the paged cache's bookkeeping, the sampler, and greedy token
streams identical to the reference ``Engine`` on the same requests and
weights (``llama3_8b.reduced()`` in float32, ``pallas_dip`` against the
port's ``dip``), with and without preemption.

Token streams are compared exactly: greedy argmax over logits that agree to
about 1e-5 (test_torch_model.py) picks the same tokens unless two logits
tie within that margin, which these seeded inputs do not do.
"""

import numpy as np
import pytest
import torch

from _torch_parity import reduced_configs, reference_params
from repro.serving import BlockAllocator as RefBlockAllocator
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import sampling as ref_sampling
from repro_torch.convert import params_from_jax
from repro_torch.runtime import Request, Server, ServerConfig
from repro_torch.serving import BlockAllocator, Engine, EngineConfig, PagedKVCache, SamplingParams
from repro_torch.serving import sampling


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = reduced_configs("pallas_dip", "dip")
    params, np_params = reference_params(ref_cfg)
    return ref_cfg, cfg, params, params_from_jax(np_params, cfg, device="cpu")


def _prompts(n, lo=3, hi=10, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, size=int(rng.integers(lo, hi))).astype(np.int32) for _ in range(n)]


def _run(engine, prompts, sp):
    for i, p in enumerate(prompts):
        engine.add_request(p, sp, rid=i)
    return engine.run()


# ------------------------------------------------------------ bookkeeping --
@pytest.mark.parametrize("seed", range(6))
def test_allocator_matches_reference_and_keeps_invariants(seed):
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(2, 24))
    port, ref = BlockAllocator(n_blocks), RefBlockAllocator(n_blocks)
    live = []
    for _ in range(40):
        if live and rng.integers(2):
            blocks = live.pop(int(rng.integers(len(live))))
            port.free(blocks)
            ref.free(blocks)
        else:
            n = int(rng.integers(0, n_blocks))
            got, want = port.alloc(n), ref.alloc(n)
            assert got == want
            if got is not None:
                assert BlockAllocator.NULL_BLOCK not in got
                live.append(got)
        flat = [b for blks in live for b in blks]
        assert len(flat) == len(set(flat))
        assert port.num_free == ref.num_free == n_blocks - 1 - len(flat)


def test_allocator_double_free_raises():
    alloc = BlockAllocator(4)
    got = alloc.alloc(2)
    alloc.free(got)
    with pytest.raises(ValueError, match="not currently allocated"):
        alloc.free(got)
    with pytest.raises(ValueError, match="not currently allocated"):
        alloc.free([BlockAllocator.NULL_BLOCK])


def test_block_table_growth_and_release(model):
    _, cfg, _, _ = model
    kv = PagedKVCache(cfg, num_blocks=9, block_size=4, slots=2, max_seq=16, device="cpu")
    assert kv.pools["layers"]["k"].shape == (cfg.n_layers, 9, 4, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert kv.ensure(0, 5) and list(kv.block_tables[0][:2]) != [0, 0]
    assert kv.ensure(0, 8) and len(kv.owned[0]) == 2
    assert kv.ensure(0, 9) and len(kv.owned[0]) == 3
    with pytest.raises(ValueError, match="blocks_per_seq"):
        kv.ensure(0, 17)
    assert kv.ensure(1, 16)
    kv.release(0)
    assert (kv.block_tables[0] == 0).all() and kv.owned[0] == []
    assert kv.allocator.num_free == 4
    assert kv.ensure(0, 16) and not kv.can_allocate(1)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_sampler_matches_reference(temperature):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 64)).astype(np.float32)
    kw = dict(temperature=np.full(4, temperature, np.float32), top_k=np.array([0, 5, 0, 3]),
              top_p=np.array([1.0, 1.0, 0.8, 0.5], np.float32), uniforms=rng.random((4, 64)))
    np.testing.assert_array_equal(sampling.sample_tokens(logits, **kw),
                                  ref_sampling.sample_tokens(logits, **kw))


# ----------------------------------------------------------- token streams --
def test_greedy_streams_match_reference_engine(model):
    ref_cfg, cfg, params, tparams = model
    prompts = _prompts(4)
    ecfg = dict(slots=3, max_seq=32, prefill_chunk=8)   # 4 requests > 3 slots
    want = _run(RefEngine(ref_cfg, params, engine_cfg=RefEngineConfig(**ecfg)), prompts,
                RefSamplingParams(max_new_tokens=6))
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(**ecfg), device="cpu")
    got = _run(eng, prompts, SamplingParams(max_new_tokens=6))
    assert got == want
    assert eng.last_stats["requests"] == 4 and eng.last_stats["prefill_chunks"] >= 4


def test_preemption_recovers_the_reference_streams(model):
    ref_cfg, cfg, params, tparams = model
    prompts = _prompts(3, lo=6, hi=10)   # the reference's own preemption case
    tight = dict(slots=3, max_seq=32, prefill_chunk=8, block_size=4, num_blocks=11)
    ref_eng = RefEngine(ref_cfg, params, engine_cfg=RefEngineConfig(**tight))
    want = _run(ref_eng, prompts, RefSamplingParams(max_new_tokens=8))
    assert ref_eng.last_stats["preemptions"] >= 1
    evicted = []
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(**tight), device="cpu",
                 on_preempt=lambda r: evicted.append(r.rid))
    got = _run(eng, prompts, SamplingParams(max_new_tokens=8))
    assert eng.last_stats["preemptions"] >= 1 and evicted
    assert got == want
    roomy = Engine(cfg, tparams, engine_cfg=EngineConfig(slots=3, max_seq=32, prefill_chunk=8), device="cpu")
    assert _run(roomy, prompts, SamplingParams(max_new_tokens=8)) == got


def test_prefill_import_lands_in_the_slot_blocks(model):
    _, cfg, _, tparams = model
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(slots=1, max_seq=32, prefill_chunk=8, block_size=4),
                 device="cpu")
    eng.add_request(np.arange(2, 13, dtype=np.int32), SamplingParams(max_new_tokens=4))
    eng._try_admit()
    while eng._prefilling is not None:
        cache = eng._prefill_cache
        eng._advance_prefill()
    pools, row = eng.kv.pools["layers"], eng.kv.table_row(0)
    for p in range(11):
        blk, off = row[p // 4], p % 4
        torch.testing.assert_close(pools["k"][:, blk, off], cache["layers"]["k"][:, 0, p], rtol=0, atol=0)


def test_server_matches_engine_and_validates(model):
    _, cfg, _, tparams = model
    prompts = _prompts(2, seed=2)
    server = Server(cfg, ServerConfig(batch_slots=2, max_seq=32, max_new_tokens=4, temperature=0.0,
                                      prefill_chunk=8), tparams, device="cpu")
    out = server.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(slots=2, max_seq=32, prefill_chunk=8), device="cpu")
    assert out == _run(eng, prompts, SamplingParams(max_new_tokens=4))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request(np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="no room"):
        eng.add_request(np.arange(40, dtype=np.int32))
