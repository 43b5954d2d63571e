"""The engine's captured steps (``serving/graphs.py``) on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (a CUDA graph needs a card).  On an H100 run them with
``python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py``.

On ``reduced()`` of every family and backend the port serves, through an
``Engine`` on the card: a replay of the decode step, of the prefill chunk
and (SSM, hybrid) of the single-token tail forward gives the eager step's
logits and caches bit for bit on clones of the same caches and inputs (the
same kernels in the same order), and the call returns the caller's cache
object; the engine's steps draw on one graph memory pool; once a step is
captured, N replays raise the launch counters by N times the eager step's
launches; each graph's kernel nodes (``CapturedStep.kernel_nodes``) equal
that increase by kernel group; and a
call with another cache, another input shape, another input dtype or a
``moe_trace`` raises instead of running the eager step.  The fp8 model in
f32 compute runs each projection as a cast pass and the e4m3 mainloop with
an f32 output, both inside the graphs.  Single kernels: the bf16 decode
tile with the rmsnorm prologue, the fp8 route with f32 x and flash at
DeepSeek-V2-Lite's (192, 128) head dims, each replayed from a graph bit for
bit equal to its eager call.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.device import make_generator
from repro_torch.kernels.dip_matmul import dip_matmul, dip_matmul_plain
from repro_torch.models import transformer as tf_model
from repro_torch.serving import Engine, EngineConfig, graphs

pytestmark = pytest.mark.cuda

CHUNK = 16
SLOTS = 2
SERVED = [
    ("llama3-8b-f32", "llama3-8b", dict(matmul_backend="dip", param_dtype="float32", compute_dtype="float32")),
    ("llama3-8b-bf16", "llama3-8b", dict(matmul_backend="dip")),
    ("llama3-8b-int8-kv8", "llama3-8b", dict(matmul_backend="dip_int8w", quantization="int8", kv_quant="int8")),
    ("llama3-8b-fp8", "llama3-8b", dict(matmul_backend="dip_fp8", quantization="fp8_e4m3")),
    ("llama3-8b-fp8-f32", "llama3-8b", dict(matmul_backend="dip_fp8", quantization="fp8_e4m3",
                                            param_dtype="float32", compute_dtype="float32")),
    ("llama3-8b-systolic", "llama3-8b", dict(matmul_backend="pallas_systolic")),
    ("deepseek-v2-lite-16b", "deepseek-v2-lite-16b", dict(matmul_backend="dip")),
    ("mamba2-370m", "mamba2-370m", dict(matmul_backend="dip")),
    ("zamba2-2.7b", "zamba2-2.7b", dict(matmul_backend="dip")),
]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module", params=SERVED, ids=[s[0] for s in SERVED])
def engine(request, dev):
    _, arch, fields = request.param
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(dict(param_dtype="bfloat16",
                                                                        compute_dtype="bfloat16"), **fields))
    params = tf_model.init_params(cfg, make_generator(0, "cuda"), "cuda")
    eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=SLOTS, max_seq=64, prefill_chunk=CHUNK), device="cuda")
    yield eng
    del eng
    torch.cuda.empty_cache()


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    return t.clone() if isinstance(t, torch.Tensor) else t


def _equal_trees(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal_trees(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), f"{what}: max|diff| {(a.float() - b.float()).abs().max().item()}"


def _steps(eng):
    """(name, captured step, eager step, cache, host inputs) of the engine's
    steps, the cache set as the engine would hold it before the call."""
    cfg = eng.cfg
    rng = np.random.default_rng(0)
    toks = lambda shape: torch.from_numpy(rng.integers(2, cfg.vocab_size, size=shape).astype(np.int64))  # noqa: E731
    for slot, length in enumerate((9, 21)):
        assert eng.kv.ensure(slot, length + 1)
    tables = torch.from_numpy(eng.kv.block_tables.astype(np.int64))
    decode = ("decode", eng._decode, tf_model.paged_decode_step_fn(cfg), eng.kv.pools,
              (toks((SLOTS, 1)), torch.tensor([9, 21], dtype=torch.long), tables))
    prefill = tf_model.decode_step_fn(cfg, attn_backend="flash")
    cache = eng._prefill_cache
    cache["pos"].fill_(CHUNK)
    out = [decode, ("prefill chunk", eng._prefill_fwd, prefill, cache, (toks((1, CHUNK)),))]
    if cfg.ssm_state:
        out.append(("prefill tail token", eng._prefill_fwd, prefill, cache, (toks((1, 1)),)))
    return out


def test_replay_is_bit_equal_to_the_eager_step(engine, dev):
    with torch.no_grad():
        for name, captured, eager, cache, inputs in _steps(engine):
            assert isinstance(captured, graphs.CapturedStep)
            before = _clone(cache)
            first, ret = captured(engine.params, cache, *inputs)  # runs eagerly, then captures
            assert ret is cache, name
            torch.cuda.synchronize()
            assert torch.isfinite(first[..., :engine.cfg.vocab_size].float()).all(), name
            for nm in cache:                                  # back to the state before the call
                _restore(cache[nm], before[nm])
            scratch = _clone(before)
            want, want_cache = eager(engine.params, scratch, *(t.to(dev) for t in inputs))
            got, got_cache = captured(engine.params, cache, *inputs)
            torch.cuda.synchronize()
            assert got_cache is cache, name
            assert torch.equal(got, want), f"{name}: max|diff| {(got.float() - want.float()).abs().max().item()}"
            _equal_trees(got_cache, want_cache, name)
            assert torch.isfinite(got[..., :engine.cfg.vocab_size].float()).all()


def test_steps_share_one_graph_pool(engine, dev):
    assert engine._decode.pool == engine._prefill_fwd.pool


def _restore(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _restore(dst[k], src[k])
    else:
        dst.copy_(src)


def test_replays_count_their_launches(engine, dev):
    """After a step is captured, N replays add N times the launches one
    eager call counts, by counter (routes included), and the capture
    recorded that increase."""
    with torch.no_grad():
        for name, captured, eager, cache, inputs in _steps(engine):
            before = graphs.launch_counts()
            eager(engine.params, _clone(cache), *(t.to(dev) for t in inputs))
            one = {k: n - before[k] for k, n in graphs.launch_counts().items()}
            assert sum(one.values()) > 0, name
            captured(engine.params, cache, *inputs)  # captured by now
            key = tuple(tuple(t.shape) for t in inputs)
            assert captured.captures[key]["launches"] == {f"{fn.__name__}.{nm}": n for (fn, nm), n in one.items()
                                                          if n}, name
            start, n = graphs.launch_counts(), 5
            for _ in range(n):
                if "pos" in cache:
                    cache["pos"].fill_(CHUNK)
                captured(engine.params, cache, *inputs)
            torch.cuda.synchronize()
            got = {k: v - start[k] for k, v in graphs.launch_counts().items()}
            assert got == {k: n * v for k, v in one.items()}, name


def test_graph_kernel_nodes_equal_the_counters(engine, dev):
    """A captured graph's kernel nodes, counted by function name and
    grouped, equal the counters' increase of one eager call of the step."""
    with torch.no_grad():
        for name, captured, eager, cache, inputs in _steps(engine):
            before = graphs.launch_counts()
            eager(engine.params, _clone(cache), *(t.to(dev) for t in inputs))
            want = graphs.counters_by_group({k: n - before[k] for k, n in graphs.launch_counts().items()})
            captured(engine.params, cache, *inputs)  # captured by now
            nodes = captured.kernel_nodes(tuple(tuple(t.shape) for t in inputs))
            assert sum(want.values()) > 0 and graphs.kernels_by_group(nodes) == want, (name, dict(nodes))


def test_mismatched_calls_raise(engine, dev):
    with torch.no_grad():
        (_, captured, _, cache, inputs), *rest = _steps(engine)
        captured(engine.params, cache, *inputs)
        with pytest.raises(ValueError, match="other than the ones"):
            captured(engine.params, _clone(cache), *inputs)
        with pytest.raises(ValueError, match="input shapes"):
            captured(engine.params, cache, inputs[0][:1], inputs[1][:1], inputs[2][:1])
        with pytest.raises(TypeError):
            captured(engine.params, cache, inputs[0].int(), *inputs[1:])
        with pytest.raises(TypeError):
            captured(engine.params, cache, *inputs, moe_trace={})
        _, prefill, _, pcache, pinputs = rest[0]
        with pytest.raises(ValueError, match="input shapes"):
            prefill(engine.params, pcache, pinputs[0][:, :CHUNK - 1])


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("n", [4096, 1024])
def test_prologue_decode_tile_is_bit_stable_back_to_back(dev, m, n):
    """The bf16 decode tile with the rmsnorm prologue at llama3-8b's widths
    (K = 4096; N = 4096 splits K in 5, N = 1024 in 16): calls queued back to
    back on a side stream and ten replays of a graph of one call equal the
    eager call bit for bit, and that call is within bf16 TOL of the plain
    version.  The wrapper once released its inv_rms tensor before queuing
    the launch, so the split-K workspace allocated next could take that
    memory and the kernel's partial sums overwrote inv_rms while other
    blocks still read it; which call lost depended on where the allocator's
    free blocks lay (a fresh pool: a side stream, a graph)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(m * n)
    x = torch.randn(m, 4096, device=dev, generator=g).to(torch.bfloat16)
    p = (torch.randn(4096, n, device=dev, generator=g) / 64).to(torch.bfloat16)
    kw = dict(prologue="rmsnorm", prologue_operands=(torch.rand(4096, device=dev, generator=g) + 0.5,))
    want = dip_matmul(x, p, **kw)
    plain = dip_matmul_plain(x, p, **kw)
    assert (want.float() - plain.float()).abs().max().item() <= 8e-3 * max(1.0, plain.float().abs().max().item())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs = [dip_matmul(x, p, **kw) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = dip_matmul(x, p, **kw)
    for _ in range(10):
        graph.replay()
        outs.append(out.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)



def _replays_equal_eager(fn, dev):
    """``fn()`` three times back to back on a side stream (the first makes
    whatever per-stream state a launch needs, such as flash's split
    tickets), then captured on that stream and replayed ten times: every
    output equal to the first eager call's bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs = [fn() for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    for _ in range(10):
        graph.replay()
        outs.append(out.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    return outs[0]


@pytest.mark.parametrize("m", [4, 256])
def test_fp8_f32_x_route_replays_bit_equal_to_eager(dev, m):
    """fp8 weights with f32 x: the cast pass and the e4m3 mainloop with an
    f32 output (M = 4: the decode tile with a K split, M = 256: wgmma),
    with the rmsnorm prologue and swiglu at llama3-8b's gate+up, replayed
    from a graph equal to the eager call; two launches a call (cast and
    product) on the tensor-core route; within f32 TOL of the plain version."""
    from repro_torch import api
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain

    g = torch.Generator(device="cuda")
    g.manual_seed(m)
    k, n = 4096, 14336
    x = torch.randn(m, k, device=dev, generator=g)
    qw = [api.quant.quantize(torch.randn(k, n, device=dev, generator=g) / k ** 0.5, "fp8_e4m3") for _ in range(2)]
    kw = dict(epilogue="swiglu", prologue="rmsnorm",
              prologue_operands=(torch.rand(k, device=dev, generator=g) + 0.5,))
    before = (dip_matmul_q.launches_tc, dip_matmul_q.launches_cast)
    got = _replays_equal_eager(lambda: dip_matmul_q(x, qw[0].data, qw[0].scale, qw[1].data, qw[1].scale, **kw), dev)
    assert (dip_matmul_q.launches_tc - before[0], dip_matmul_q.launches_cast - before[1]) == (4, 4)
    plain = dip_matmul_q_plain(x, qw[0].data, qw[0].scale, qw[1].data, qw[1].scale, **kw)
    assert got.dtype == torch.float32
    assert (got - plain).abs().max().item() <= 1e-5 * max(1.0, plain.abs().max().item())


@pytest.mark.parametrize("sq", [1, 256])
def test_flash_mla_pair_replays_bit_equal_to_eager(dev, sq):
    """Flash at D = 192, Dv = 128 in bf16 on its tensor-core routes (Sq =
    256: the 64-row tiles; Sq = 1: split_kv, its partials merged in the
    launch), replayed from a graph equal to the eager call, and within bf16
    TOL of the plain version."""
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    g = torch.Generator(device="cuda")
    g.manual_seed(sq)
    q, k = (torch.randn(16, s, 192, device=dev, generator=g).to(torch.bfloat16) for s in (sq, 1024))
    v = torch.randn(16, 1024, 128, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(q_offset=torch.tensor(700 if sq == 1 else 512, device=dev), kv_len=768 if sq > 1 else 701)
    got = _replays_equal_eager(lambda: flash_attention(q, k, v, **kw), dev)
    plain = attention_plain(q, k, v, **kw).float()
    assert (got.float() - plain).abs().max().item() <= 8e-3 * max(1.0, plain.abs().max().item())
