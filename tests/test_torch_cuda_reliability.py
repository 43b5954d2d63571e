"""The reliability layer on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false.  On an H100 run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda_reliability.py``.

* ``api.matmul(..., verify=True)`` through each backend (``dip``, ``ws``,
  ``systolic``, ``dip_int8w``, ``dip_fp8``, ``torch``), bf16 and f32 x, the
  probe and the storage rung: the output equals the unverified call bit for
  bit, the audit passes, its scalars stay on the card, and a flipped
  storage bit (14 for bf16, 30 for f32, 6 for int8 and e4m3) is flagged.
  A NaN in one row of x makes exactly that output row NaN on every backend,
  the int8 route's quantizing pass included, and the probe flags that row.
* ``corrupt_kv_block`` under the engine's captured decode step: the pool
  is poisoned in place, so the next replay sees the victim's row nonfinite
  and only that row; the verified engine retries the victim and serves the
  peer the clean run's tokens.
* The degraded step (``matmul_backend="torch"``) as a ``CapturedStep``: its
  replay equals its eager step bit for bit, and the engine builds it on the
  first fault only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api, reliability as rel
from repro_torch.configs import get_config
from repro_torch.device import make_generator
from repro_torch.models import transformer as tf_model
from repro_torch.serving import Engine, EngineConfig, SamplingParams, graphs

pytestmark = pytest.mark.cuda

BACKENDS = ["dip", "ws", "systolic", "dip_int8w", "dip_fp8", "torch"]
LOUD_BIT = {torch.bfloat16: 14, torch.float32: 30, torch.int8: 6, torch.float8_e4m3fn: 6}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weight(backend, w):
    be = api.get_backend(backend)
    if be.layout == "dip_q":
        return rel.attach_checksums(api.quant.quantize(w.float(), be.scheme))
    if be.layout == "dip":
        return rel.attach_checksums(api.DipWeight.from_natural(w))
    return w


@pytest.mark.parametrize("m", [4, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("backend", BACKENDS)
def test_verified_dispatch_bit_identical_on_the_card(dev, backend, dtype, m):
    g = torch.Generator(device="cuda").manual_seed(m)
    k, n = 512, 384
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = torch.randn(k, n, generator=g, device=dev).to(dtype) / k ** 0.5
    wu = torch.randn(k, n, generator=g, device=dev).to(dtype) / k ** 0.5
    wt = _weight(backend, w)
    for epilogue, weights, mode in (("none", wt, "probe"), ("swiglu", (wt, _weight(backend, wu)), "storage")):
        plain = api.matmul(x, weights, backend=backend, epilogue=epilogue)
        out, rep = api.matmul(x, weights, backend=backend, epilogue=epilogue, verify=True)
        assert torch.equal(out, plain), (backend, epilogue)
        assert rep["mode"] == mode and rep["ok"].device.type == "cuda"
        assert bool(rep["ok"]), (backend, epilogue, float(rep["max_excess"]))
    if isinstance(wt, torch.Tensor):
        return
    bad = rel.bitflip(wt.data, seed=3, bit=LOUD_BIT[wt.data.dtype])
    flipped = (wt.with_data(bad, wt.scale, checksum=wt.checksum) if isinstance(wt, api.QuantizedDipWeight)
               else wt.with_data(bad, checksum=wt.checksum))
    for mode in ("storage", True):
        assert not bool(api.matmul(x, flipped, backend=backend, verify=mode)[1]["ok"]), (backend, mode)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("backend", BACKENDS)
def test_a_nan_activation_row_stays_nan_on_the_card(dev, backend, dtype):
    """A NaN in one row of x makes that output row NaN, and only that one,
    on every backend: the int8 route's quantizing pass propagates it into
    the row's scale (its maxima ignored NaNs before, writing -127 codes), as
    the plain version's ``torch.amax`` does."""
    g = torch.Generator(device="cuda").manual_seed(1)
    m, k, n = 8, 512, 384
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = _weight(backend, torch.randn(k, n, generator=g, device=dev).to(dtype) / k ** 0.5)
    clean = api.matmul(x, w, backend=backend)
    x[3, 100] = float("nan")
    out, rep = api.matmul(x, w, backend=backend, verify=True)
    finite = torch.isfinite(out).all(dim=-1)
    assert not finite[3] and torch.isnan(out[3]).all() and finite[torch.arange(m, device=dev) != 3].all()
    assert torch.equal(out[:3], clean[:3]) and torch.equal(out[4:], clean[4:])
    assert not bool(rep["ok"]) and int(rep["rows_flagged"]) == 1


def _engine(dev, **kw):
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip", param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = tf_model.init_params(cfg, make_generator(0, "cuda"), "cuda")
    ekw = dict(slots=2, max_seq=96, prefill_chunk=32, verify=True)
    ekw.update(kw)
    return Engine(cfg, params, engine_cfg=EngineConfig(**ekw), device="cuda")


PROMPTS = (np.arange(2, 20, dtype=np.int32), np.arange(5, 30, dtype=np.int32))


def test_poisoned_block_seen_by_the_captured_decode_step(dev):
    eng = _engine(dev)
    for p in PROMPTS:
        eng.add_request(p, SamplingParams(max_new_tokens=8))
    for _ in range(4):
        eng.step()
    assert isinstance(eng._decode, graphs.CapturedStep) and eng._decode._graphs  # replaying by now
    victim = next(r for r in eng._slots if r is not None and r.rid == 0)
    pool = eng.kv.pools["layers"]["k"]
    ptr = pool.data_ptr()
    assert rel.corrupt_kv_block(eng.kv, eng.kv.owned[victim.slot][0], mode="nan") == "k"
    assert eng.kv.pools["layers"]["k"] is pool and pool.data_ptr() == ptr
    logits = eng._decode(eng.params, eng.kv.pools, eng._tensor(eng._cur), eng._tensor(eng._ctx),
                         eng._tensor(eng.kv.block_tables))[0][:, -1].float().cpu()
    finite = torch.isfinite(logits).all(dim=-1)
    assert not finite[victim.slot] and finite[1 - victim.slot]


def test_verified_engine_retries_and_serves_the_peer_on_the_card(dev):
    clean = _engine(dev)
    rc = [clean.add_request(p, SamplingParams(max_new_tokens=8)) for p in PROMPTS]
    want = clean.run()
    eng = _engine(dev)
    r0, r1 = [eng.add_request(p, SamplingParams(max_new_tokens=8)) for p in PROMPTS]
    for _ in range(4):
        eng.step()
    victim = next(r for r in eng._slots if r is not None and r.rid == r0)
    rel.corrupt_kv_block(eng.kv, eng.kv.owned[victim.slot][0], mode="nan")
    got = eng.run()
    assert got[r1] == want[rc[1]] and len(got[r0]) == 8
    assert (eng.last_stats["faults_detected"], eng.last_stats["retries"]) == (1, 1) and eng._decode_xla is None


def test_degraded_captured_step_replays_its_eager_step(dev):
    """The degraded step's last call with a live slot, replayed from the
    cache as that call found it, against the eager step on a copy: the live
    rows' logits and the caches (but the null block, which every free slot
    writes) bit for bit, the poisoned block's NaNs included."""
    eng = _engine(dev, max_retries=0)
    r0, r1 = [eng.add_request(p, SamplingParams(max_new_tokens=8)) for p in PROMPTS]
    assert eng._decode_xla is None
    calls = []
    get = eng._get_decode_xla

    def recording():
        step = get()

        def run(params, cache, *inputs):
            calls.append((tuple(t.clone() for t in inputs), _clone(cache)))
            return step(params, cache, *inputs)
        return run
    eng._get_decode_xla = recording
    for _ in range(2):
        eng.step()
    victim = next(r for r in eng._slots if r is not None and r.rid == r0)
    rel.corrupt_kv_block(eng.kv, eng.kv.owned[victim.slot][0], mode="nan")
    got = eng.run()
    assert len(got[r0]) == len(got[r1]) == 8 and eng.request_stats[r0]["degraded"]
    step = eng._decode_xla
    assert isinstance(step, graphs.CapturedStep) and step._graphs and step.pool is eng._decode.pool
    assert not step.captures[((2, 1), (2,), (2, eng.kv.blocks_per_seq))]["launches"]  # no counted kernel
    inputs, snap = calls[-1]
    live = (inputs[2] != 0).any(-1)
    assert live.any()
    _copy(eng.kv.pools, snap)
    replayed = step(eng.params, eng.kv.pools, *inputs)[0][live].clone()
    eager = tf_model.paged_decode_step_fn(dataclasses.replace(eng.cfg, matmul_backend="torch"))
    scratch = _clone(snap)
    with torch.no_grad():
        want = eager(eng.params, scratch, *(t.to(dev) for t in inputs))[0][live]
    assert torch.equal(replayed, want)
    for name, t in eng.kv.pools["layers"].items():
        a, b = t[:, 1:].contiguous(), scratch["layers"][name][:, 1:].contiguous()
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name


def _clone(t):
    return {k: _clone(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()


def _copy(dst, src):
    for k, v in src.items():
        _copy(dst[k], v) if isinstance(v, dict) else dst[k].copy_(v)
