"""The serving steps are fit to be captured as CUDA graphs, checked on the
CPU; and the engine's one prefill cache (a device ``pos``, reset on
admission) serves as the reference does.

Capture safety: a ``TorchDispatchMode`` watches every operator a step runs
and fails on ``aten.lift_fresh`` (host data becoming a tensor, as
``torch.as_tensor(numpy)`` and ``torch.tensor`` dispatch) and on
``aten._local_scalar_dense`` (a tensor's value read into Python, as
``.item()`` and ``bool(tensor)`` dispatch).  On the card either one inside
a step is a host-to-device copy or a sync that a capture refuses.  The
steps are the engine's: ``paged_decode_step_fn``, the prefill forward at a
chunk and, for the SSM families, at one token, each run once beforehand as
the engine's first, eager call runs it (device constants are made then), at
``reduced()`` of llama3-8b in bf16, with int8 weights and the int8 KV pool,
with fp8 weights, deepseek-v2-lite-16b, mamba2-370m and zamba2-2.7b, and
the last three quantized (int8 weights with the int8 latent or
shared-attention pool, and zamba2-2.7b with fp8 weights).

Parity (float32, the reference's weights through ``params_from_jax``):
chunk by chunk through a prefill cache that first served another prompt
and was reset as the engine resets it, the logits and the caches against
the reference's ``decode_step_fn`` on a fresh cache, within ``MODEL_TOL``
(1e-4 of max(1, max|reference|), as test_torch_model.py states: a few
layers of f32 arithmetic in another summation order); and one ``Engine``
with one slot serving a prompt shorter than a chunk, one of two whole
chunks and one with a tail, in that order, against the reference
``Server``'s greedy tokens (exact), so that a cache left dirty by an
earlier request would show.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from _torch_parity import assert_close
from repro.configs import get_config as ref_get
from repro.models import transformer as ref_tf
from repro.runtime import Request as RefRequest
from repro.runtime import Server as RefServer
from repro.runtime import ServerConfig as RefServerConfig
from repro_torch.configs import get_config as port_get
from repro_torch.convert import params_from_jax
from repro_torch.device import make_generator
from repro_torch.models import transformer as tf_model
from repro_torch.serving import Engine, EngineConfig, SamplingParams

MODEL_TOL = 1e-4
CHUNK = 8
HOST_OPS = ("lift_fresh", "_local_scalar_dense")

# (id, arch, config fields): every family and backend the port serves
SERVED = [
    ("llama3-8b-bf16", "llama3-8b", dict(matmul_backend="dip")),
    ("llama3-8b-int8-kv8", "llama3-8b", dict(matmul_backend="dip_int8w", quantization="int8", kv_quant="int8")),
    ("llama3-8b-fp8", "llama3-8b", dict(matmul_backend="dip_fp8", quantization="fp8_e4m3")),
    ("llama3-8b-systolic", "llama3-8b", dict(matmul_backend="pallas_systolic")),
    ("deepseek-v2-lite-16b", "deepseek-v2-lite-16b", dict(matmul_backend="dip")),
    ("mamba2-370m", "mamba2-370m", dict(matmul_backend="dip")),
    ("zamba2-2.7b", "zamba2-2.7b", dict(matmul_backend="dip")),
    ("deepseek-v2-lite-16b-int8-kv8", "deepseek-v2-lite-16b",
     dict(matmul_backend="dip_int8w", quantization="int8", kv_quant="int8")),
    ("mamba2-370m-int8", "mamba2-370m", dict(matmul_backend="dip_int8w", quantization="int8")),
    ("zamba2-2.7b-int8-kv8", "zamba2-2.7b", dict(matmul_backend="dip_int8w", quantization="int8", kv_quant="int8")),
    ("zamba2-2.7b-fp8", "zamba2-2.7b", dict(matmul_backend="dip_fp8", quantization="fp8_e4m3")),
]
PARITY = ["llama3-8b", "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-2.7b"]


class HostTraffic(TorchDispatchMode):
    """Records every operator that moves a value between host and tensor."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in HOST_OPS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _ints(shape, hi, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(2, hi, size=shape), dtype=torch.long)


def test_graph_dump_kernel_nodes_by_function_name():
    """``dot_kernel_nodes`` counts a ``cuGraphDebugDotPrint`` dump's KERNEL
    nodes by the function's own name (mangled in anonymous namespaces, in
    ``at::native``, templated, or unmangled), skips other nodes and edges,
    and ``kernels_by_group`` sums them into the counters' groups."""
    from repro_torch.kernels import dip_matmul as dm
    from repro_torch.kernels import dip_matmul_q as dq
    from repro_torch.serving import graphs

    assert graphs.function_name("_ZN12_GLOBAL__N_116dip_wgmma_kernelI13__nv_bfloat16Lb1EEEvNS_4ArgsEiPf") \
        == "dip_wgmma_kernel"
    assert graphs.function_name("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_") \
        == "vectorized_elementwise_kernel"
    assert graphs.function_name("_Z20quantize_int8_kernelIfEvPKT_") == "quantize_int8_kernel"
    assert graphs.function_name("flash_tc_kernel") == "flash_tc_kernel"

    def node(i, label):
        return f'"graph_1_node_{i}"[style="solid" shape="record" label="{label}"];\n'

    dot = ("digraph dot {\nsubgraph cluster_1 {\nlabel=\"graph_1\" graph[style=\"dashed\"];\n"
           + node(0, r"{KERNEL | {ID | 0 | _ZN12_GLOBAL__N_116dip_wgmma_kernelI13__nv_bfloat16Lb1EEEvNS_4ArgsEiPf"
                     r"\<\<\<(8,1,1),(384,1,1),1024\>\>\>}}")
           + node(1, r"{KERNEL | {ID | 1 | _ZN12_GLOBAL__N_120splitk_reduce_kernelENS_4ArgsEPKfi\<\<\<4,256,0\>\>\>}}")
           + node(2, "{MEMSET | {ID | 2}}")
           + node(3, "3\nKERNEL\nID: 3\n_Z20quantize_int8_kernelIfEvPKT_\n\\<\\<\\<1,128,0\\>\\>\\>")
           + node(4, r"{KERNEL | {ID | 4 | _ZN12_GLOBAL__N_117dip_mma_s8_kernelENS_6S8ArgsEiPi\<\<\<1,128,0\>\>\>}}")
           + '"graph_1_node_0" -> "graph_1_node_1";\n}\n}\n')
    nodes = graphs.dot_kernel_nodes(dot)
    assert nodes == {"dip_wgmma_kernel": 1, "splitk_reduce_kernel": 1, "quantize_int8_kernel": 1,
                     "dip_mma_s8_kernel": 1}
    groups = graphs.kernels_by_group(nodes)
    assert groups["dip products"] == 2 and groups["quantizing passes"] == 1 and sum(groups.values()) == 3
    delta = {(dm.dip_matmul, "launches"): 1, (dq.dip_matmul_q, "launches"): 1,
             (dq.dip_matmul_q, "launches_quant"): 1, (dq.dip_matmul_q, "launches_tc"): 1}
    assert graphs.counters_by_group(delta) == groups
    with pytest.raises(ValueError, match="without a function name"):
        graphs.dot_kernel_nodes(node(0, "{KERNEL | {ID | 0}}"))


def test_the_mode_sees_host_traffic():
    """The watch itself: a numpy array and a Python list made into tensors,
    and a value read back, are each seen; device-side arithmetic is not."""
    host = np.arange(3)
    t = torch.arange(3)
    with HostTraffic() as mode:
        t + 1
    assert mode.seen == []
    for act in (lambda: torch.as_tensor(host), lambda: torch.tensor([1, 2]), lambda: t.sum().item(),
                lambda: bool(t[0] == 0)):
        with HostTraffic() as mode:
            act()
        assert mode.seen, act


@pytest.fixture(scope="module", params=SERVED, ids=[s[0] for s in SERVED])
def served(request):
    _, arch, fields = request.param
    cfg = dataclasses.replace(port_get(arch).reduced(), param_dtype="bfloat16", compute_dtype="bfloat16", **fields)
    return cfg, tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu")


def _steps(cfg):
    """The engine's steps with their inputs: (name, fn, cache, inputs)."""
    slots, nb, bs = 2, 9, 4
    tables = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0]], dtype=torch.long)
    pools = tf_model.init_paged_cache(cfg, nb, bs, kv_quant=cfg.kv_quant, slots=slots, device="cpu")
    decode = ("decode", tf_model.paged_decode_step_fn(cfg), pools,
              (_ints((slots, 1), cfg.vocab_size, 1), torch.tensor([2, 5], dtype=torch.long), tables))
    prefill = tf_model.decode_step_fn(cfg, attn_backend="flash")
    out = [decode, ("prefill chunk", prefill, tf_model.init_cache(cfg, 1, 4 * CHUNK, device="cpu"),
                    (_ints((1, CHUNK), cfg.vocab_size, 2),))]
    if cfg.ssm_state:
        out.append(("prefill tail token", prefill, tf_model.init_cache(cfg, 1, 4 * CHUNK, device="cpu"),
                    (_ints((1, 1), cfg.vocab_size, 3),)))
    return out


def test_steps_move_nothing_between_host_and_device(served):
    """Every step, after one eager call, runs with no host data made into
    a tensor and no tensor value read by the host; it still advances the
    prefill cache's position on the device (in place)."""
    cfg, params = served
    with torch.no_grad():
        for name, fn, cache, inputs in _steps(cfg):
            fn(params, cache, *inputs)  # the engine's first, eager call
            pos = cache.get("pos")
            before = None if pos is None else int(pos)
            with HostTraffic() as mode:
                logits, new_cache = fn(params, cache, *inputs)
            assert mode.seen == [], f"{name}: {mode.seen}"
            assert torch.isfinite(logits[..., :cfg.vocab_size].float()).all()
            if pos is not None:
                assert new_cache["pos"] is pos and int(pos) == before + inputs[0].shape[1]


def _parity_model(name, seed=0):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_get(name).reduced(), matmul_backend="pallas_dip", **kw)
    cfg = dataclasses.replace(port_get(name).reduced(), matmul_backend="dip", **kw)
    params = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")


@pytest.fixture(scope="module", params=PARITY)
def parity(request):
    return _parity_model(request.param)


def _tree_close(got, want):
    assert set(got) == set(want)
    for nm, t in got.items():
        if isinstance(t, dict):
            _tree_close(t, want[nm])
        else:
            assert_close(t, want[nm], MODEL_TOL)


def test_reset_prefill_cache_matches_reference_chunk_by_chunk(parity):
    """A prefill cache that served another prompt, reset by
    ``reset_cache``, then two chunks (and for the SSM families a tail
    token): logits and caches equal the reference's on a fresh cache, and
    ``pos`` is one 0-dim int64 tensor advanced in place."""
    ref_cfg, cfg, params, tparams = parity
    v = cfg.vocab_size
    step = tf_model.decode_step_fn(cfg, attn_backend="flash")
    ref_step = ref_tf.decode_step_fn(ref_cfg, attn_backend="flash")
    cache = tf_model.init_cache(cfg, 1, 4 * CHUNK, device="cpu")
    pos = cache["pos"]
    assert pos.dim() == 0 and pos.dtype == torch.int64
    with torch.no_grad():
        for chunk in (_ints((1, CHUNK), v, 7), _ints((1, CHUNK), v, 8)):  # the earlier request
            _, cache = step(tparams, cache, chunk)
        tf_model.reset_cache(cfg, cache)
        assert int(cache["pos"]) == 0
        rcache = ref_tf.init_cache(ref_cfg, 1, 4 * CHUNK)
        toks = _ints((1, 2 * CHUNK + 1), v, 9)
        cuts = [(0, CHUNK), (CHUNK, 2 * CHUNK)] + ([(2 * CHUNK, 2 * CHUNK + 1)] if cfg.ssm_state else [])
        for lo, hi in cuts:
            got, cache = step(tparams, cache, toks[:, lo:hi])
            want, rcache = ref_step(params, rcache, jnp.asarray(toks[:, lo:hi].numpy().astype(np.int32)))
            assert_close(got[..., :v], np.asarray(want)[..., :v], MODEL_TOL)
            assert cache["pos"] is pos and int(pos) == int(rcache["pos"]) == hi
    # the K/V rows past pos still hold the earlier request's: the reference's
    # are zeros there, so only the rows below pos are compared
    layers = {nm: t for nm, t in cache["layers"].items()}
    ref_layers = {nm: t for nm, t in rcache["layers"].items()}
    if cfg.ssm_state:
        for nm in ("conv", "state"):
            assert_close(layers[nm], ref_layers[nm], MODEL_TOL)
        layers, ref_layers = layers.get("attn", {}), ref_layers.get("attn", {})
    for nm, t in layers.items():
        assert_close(t[:, :, :hi], np.asarray(ref_layers[nm])[:, :, :hi], MODEL_TOL)


@pytest.mark.parametrize("name", PARITY)
def test_one_slot_engine_serves_prompts_in_turn_as_reference_server(name):
    """One slot, three prompts in turn: shorter than a chunk (5), two whole
    chunks (16) and two chunks with a tail (19); the greedy tokens equal
    the reference Server's with one slot."""
    ref_cfg, cfg, params, tparams = _parity_model(name)
    prompts = [np.random.default_rng(11 + i).integers(2, 512, size=n).astype(np.int32)
               for i, n in enumerate((CHUNK - 3, 2 * CHUNK, 2 * CHUNK + 3))]
    want = RefServer(ref_cfg, RefServerConfig(batch_slots=1, max_seq=32, max_new_tokens=5, temperature=0.0,
                                              prefill_chunk=CHUNK), params).serve(
        [RefRequest(rid=i, prompt=p) for i, p in enumerate(prompts)])
    eng = Engine(cfg, tparams, engine_cfg=EngineConfig(slots=1, max_seq=32, prefill_chunk=CHUNK), device="cpu")
    cache = eng._prefill_cache
    for i, p in enumerate(prompts):
        eng.add_request(p, SamplingParams(max_new_tokens=5), rid=i)
    assert eng.run() == want
    assert eng._prefill_cache["layers"] is cache["layers"]  # one cache for the engine's life
