"""The port's fail-safe serving (``EngineConfig.verify``, the retry ->
degrade -> fail ladder, request TTLs, admission capacity) against the JAX
reference's ``Engine`` on the CPU.

The reduced llama3-8b in f32 on DiP storage (``dip`` / the reference's
``pallas_dip``, so that the degraded ``torch`` / ``xla`` step is another
backend), the reference's weights through ``params_from_jax``, the
reference test's engine (2 slots, ``max_seq`` 96, chunk 32) and prompts,
greedy.  Each drill runs on both engines with the same fault at the same
tick: a NaN in the victim's first KV block (``k``; ``k_scale`` under the
int8 KV pool).  The port's token streams equal the reference's exactly,
``last_stats``' four counters equal, and so do each request's
``retries`` / ``degraded`` / ``deadline_expired`` / ``fault_failed``; the
peer's tokens equal a clean solo run's.
"""

import dataclasses

import numpy as np
import pytest

import jax

from _torch_parity import reduced_configs
from repro import reliability as ref_rel
from repro.models import transformer as ref_tf
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch import reliability as rel
from repro_torch.convert import params_from_jax
from repro_torch.serving import Engine, EngineConfig, SamplingParams

COUNTERS = ("faults_detected", "retries", "deadline_evictions", "degraded_requests")
REQ_STATS = ("retries", "degraded", "deadline_expired", "fault_failed", "new_tokens", "preemptions")
PROMPTS = (np.arange(2, 20, dtype=np.int32), np.arange(5, 30, dtype=np.int32))


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = reduced_configs("pallas_dip", "dip")
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


def _engines(model, **kw):
    ref_cfg, cfg, params, tparams = model
    ekw = dict(slots=2, max_seq=96, prefill_chunk=32, verify=True, max_retries=1)
    ekw.update(kw)
    ref = RefEngine(ref_cfg, params, engine_cfg=RefEngineConfig(**ekw), seed=0)
    port = Engine(cfg, tparams, engine_cfg=EngineConfig(**ekw), device="cpu")
    return ref, port


def _add(eng, ref, prompts=PROMPTS, max_new=8, **kw):
    sp = (RefSamplingParams if ref else SamplingParams)(max_new_tokens=max_new)
    return [eng.add_request(p, sp, **kw) for p in prompts]


def _victim_block(eng, rid):
    req = next(r for r in eng._slots if r is not None and r.rid == rid)
    return eng.kv.owned[req.slot][0]


def _drill(eng, corrupt, rid, ticks):
    for _ in range(ticks):
        eng.step()
    name = corrupt(eng.kv, _victim_block(eng, rid), mode="nan")
    return eng.run(), name


def _same_as_reference(ref, port, got, want):
    assert got == want
    assert {k: port.last_stats[k] for k in COUNTERS} == {k: ref.last_stats[k] for k in COUNTERS}
    for rid in want:
        assert {k: port.request_stats[rid][k] for k in REQ_STATS} == \
            {k: ref.request_stats[rid][k] for k in REQ_STATS}, rid


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_kv_corruption_retried_peers_served_as_reference(model, kv_quant):
    """A poisoned K block mid-decode: one fault, one retry on clean
    blocks, the victim completes and the peer streams on untouched."""
    ref, port = _engines(model, kv_quant=kv_quant)
    r0, r1 = _add(port, False)
    _add(ref, True)
    got, name = _drill(port, rel.corrupt_kv_block, r0, 4)
    want, ref_name = _drill(ref, ref_rel.corrupt_kv_block, r0, 4)
    assert name == ref_name == ("k" if kv_quant == "none" else "k_scale")
    _same_as_reference(ref, port, got, want)
    assert len(got[r0]) == len(got[r1]) == 8
    assert (port.last_stats["faults_detected"], port.last_stats["retries"]) == (1, 1)
    assert port.request_stats[r0]["retries"] == 1 and not port.request_stats[r0]["degraded"]
    assert port.request_stats[r1]["retries"] == 0 and port._decode_xla is None
    solo = _engines(model, kv_quant=kv_quant)[1]
    rs = _add(solo, False, PROMPTS[1:])[0]
    assert solo.run()[rs] == got[r1]


def test_exhausted_retries_degrade_as_reference(model):
    """``max_retries=0``: the first fault degrades the victim; the ticks
    with it run the whole pool through the ``torch`` step, and it completes."""
    ref, port = _engines(model, max_retries=0)
    r0, r1 = _add(port, False, max_new=6)
    _add(ref, True, max_new=6)
    got, _ = _drill(port, rel.corrupt_kv_block, r0, 2)
    want, _ = _drill(ref, ref_rel.corrupt_kv_block, r0, 2)
    _same_as_reference(ref, port, got, want)
    assert len(got[r0]) == len(got[r1]) == 6
    assert port.last_stats["degraded_requests"] == 1 and port.request_stats[r0]["degraded"]
    assert port._decode_xla is not None and port._decode_xla is not port._decode


def test_fault_on_the_degraded_step_fails_the_request_as_reference(model):
    """The bottom rung: a second fault, while the victim decodes degraded,
    finishes it with ``fault_failed``; the peer completes."""
    def drill(eng, corrupt, rid):
        for _ in range(2):
            eng.step()
        corrupt(eng.kv, _victim_block(eng, rid), mode="nan")
        while not any(r is not None and r.rid == rid and r.degraded and r.state == "running" for r in eng._slots):
            eng.step()
        corrupt(eng.kv, _victim_block(eng, rid), mode="nan")
        return eng.run()

    ref, port = _engines(model, max_retries=0)
    r0, r1 = _add(port, False, max_new=8)
    _add(ref, True, max_new=8)
    got, want = drill(port, rel.corrupt_kv_block, r0), drill(ref, ref_rel.corrupt_kv_block, r0)
    _same_as_reference(ref, port, got, want)
    assert port.request_stats[r0]["fault_failed"] and len(got[r1]) == 8
    assert port.last_stats["faults_detected"] == 2 and port.last_stats["degraded_requests"] == 1


def test_verify_off_is_undisturbed(model):
    """``verify=False``: no screen, no degraded step, the counters at 0,
    the same tokens as a verified clean run and as the reference."""
    ref, port = _engines(model, verify=False)
    _add(port, False, max_new=4)
    _add(ref, True, max_new=4)
    got, want = port.run(), ref.run()
    _same_as_reference(ref, port, got, want)
    assert all(port.last_stats[k] == 0 for k in COUNTERS) and port._decode_xla is None
    checked = _engines(model, verify=True)[1]
    _add(checked, False, max_new=4)
    assert checked.run() == got and checked.last_stats["faults_detected"] == 0 and checked._decode_xla is None


def test_deadline_ttl_sweeps_waiting_request_as_reference(model):
    """One slot: a request with ``ttl_s=0`` is swept at the next tick,
    before it is admitted; an engine-wide ``ttl_s=0`` sweeps everything."""
    ref, port = _engines(model, verify=False, slots=1)
    r0 = port.add_request(PROMPTS[0], SamplingParams(max_new_tokens=6))
    r1 = port.add_request(PROMPTS[1], SamplingParams(max_new_tokens=6), ttl_s=0.0)
    ref.add_request(PROMPTS[0], RefSamplingParams(max_new_tokens=6))
    ref.add_request(PROMPTS[1], RefSamplingParams(max_new_tokens=6), ttl_s=0.0)
    got, want = port.run(), ref.run()
    _same_as_reference(ref, port, got, want)
    assert len(got[r0]) == 6 and got[r1] == [] and port.last_stats["deadline_evictions"] == 1
    assert port.request_stats[r1]["deadline_expired"] and not port.request_stats[r0]["deadline_expired"]
    ref, port = _engines(model, verify=False, ttl_s=0.0)
    _add(port, False)
    _add(ref, True)
    got, want = port.run(), ref.run()
    _same_as_reference(ref, port, got, want)
    assert got == {0: [], 1: []} and port.last_stats["deadline_evictions"] == 2


def test_admission_capacity_fail_fast(model):
    """A prompt whose KV need exceeds the whole pool fails at intake, as
    the reference's does; a prompt that fits is unaffected."""
    _, port = _engines(model, verify=False, num_blocks=3)
    with pytest.raises(ValueError, match="can never be admitted"):
        port.add_request(np.arange(2, 90, dtype=np.int32), SamplingParams(max_new_tokens=4))
    rid = port.add_request(PROMPTS[0], SamplingParams(max_new_tokens=2))
    assert len(port.run()[rid]) == 2


def test_engine_config_fields_are_the_reference():
    """The reliability fields and their defaults are the reference's."""
    want = {f.name: f.default for f in dataclasses.fields(RefEngineConfig)}
    got = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    for k in ("verify", "max_retries", "retry_backoff_ticks", "ttl_s"):
        assert got[k] == want[k], k
