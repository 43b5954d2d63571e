"""Device memory of the PyTorch port's serving engine, per served
configuration, on one CUDA card.

For each configuration that ``chip_smoke.py`` serves at full width (its
phases 5, 5b, 5c, 5d - 5h, at the same engine sizes and prompts: the
quantized deepseek-v2-lite-16b, zamba2-2.7b and mamba2-370m included), and
for llama3-8b with a pool of 32 slots x 8192 tokens, this
draws the weights on the card from a seed, builds the ``Server``, serves the
requests greedily and prints one JSON line: the GiB allocated by the
weights and by the built server (weights and KV / state pools), the peak
allocated and the peak reserved while serving (the caching allocator's
segments, what the card must hold), what stays reserved after serving, the
memory the engine's CUDA graphs reserved in their pool (0 where the engine
has none), the KV bytes per block and the blocks (and sequences of
``max_seq`` tokens) that a fixed ``BUDGET_GIB`` of KV buys (none for a pure
SSM model, which pages nothing), and the first tokens of every request.

It imports only ``torch`` and ``repro_torch``, from wherever ``PYTHONPATH``
finds it, so one call can measure two trees of the port against each other::

    PYTHONPATH=src python tools/torch_serve_memory.py
    PYTHONPATH=/path/to/other/checkout/src python tools/torch_serve_memory.py --only mamba2-370m
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import make_generator
from repro_torch.models import transformer as tf_model
from repro_torch.runtime import Request, Server, ServerConfig
from repro_torch.serving import kv_cache as kvc

SEED = 0
BUDGET_GIB = 8  # the KV budget whose blocks each configuration reports
# name: (arch, config fields, kv_quant, slots, max_seq, max_new, prompt lengths or None for [200, 601))
CONFIGS = {
    "llama3-8b bf16": ("llama3-8b", dict(matmul_backend="dip"), None, 4, 1024, 16, None),
    "llama3-8b int8 + int8 KV": ("llama3-8b", dict(matmul_backend="dip_int8w", quantization="int8"), "int8",
                                 4, 1024, 16, None),
    "llama3-8b fp8": ("llama3-8b", dict(matmul_backend="dip_fp8", quantization="fp8_e4m3"), None, 4, 1024, 16, None),
    "llama3-8b pallas_systolic": ("llama3-8b", dict(matmul_backend="pallas_systolic"), None, 1, 512, 4, [256]),
    # a production-sized pool: 32 slots x 8192 tokens, 32 GiB of bf16 KV beside 15 GiB of weights
    "llama3-8b bf16 32 x 8192": ("llama3-8b", dict(matmul_backend="dip"), None, 32, 8192, 16,
                                 [541, 318, 365, 434]),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", dict(matmul_backend="dip"), None, 4, 1024, 16, None),
    "zamba2-2.7b": ("zamba2-2.7b", dict(matmul_backend="dip"), None, 4, 1024, 16, None),
    "mamba2-370m": ("mamba2-370m", dict(matmul_backend="dip"), None, 4, 1024, 16, None),
    # the quantized families (the router and expert banks, the SSM scalars and a tied head stay bf16)
    "deepseek-v2-lite-16b int8 + int8 KV": ("deepseek-v2-lite-16b", dict(matmul_backend="dip_int8w",
                                                                         quantization="int8"), "int8",
                                            4, 1024, 16, None),
    "zamba2-2.7b int8 + int8 KV": ("zamba2-2.7b", dict(matmul_backend="dip_int8w", quantization="int8"), "int8",
                                   4, 1024, 16, None),
    "mamba2-370m int8": ("mamba2-370m", dict(matmul_backend="dip_int8w", quantization="int8"), None,
                         4, 1024, 16, None),
}


def gib(n: int) -> float:
    return n / 2**30


def measure(name: str) -> dict:
    arch, fields, kv_quant, slots, max_seq, max_new, plens = CONFIGS[name]
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16", compute_dtype="bfloat16", **fields)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = tf_model.init_params(cfg, make_generator(SEED, "cuda"), "cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    server = Server(cfg, ServerConfig(batch_slots=slots, max_seq=max_seq, max_new_tokens=max_new, temperature=0.0,
                                      prefill_chunk=256, kv_quant=kv_quant), params, device="cuda")
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - base
    rng = np.random.default_rng(SEED)
    lens = plens or [int(rng.integers(200, 601)) for _ in range(slots)]
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=n)) for i, n in enumerate(lens)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = server.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = server.engine
    graph_pool = sum(c["reserved_bytes"] for step in (eng._decode, eng._prefill_fwd)
                     for c in getattr(step, "captures", {}).values())
    per_block = kvc.bytes_per_block(eng.cfg)
    blocks = kvc.blocks_for_budget(eng.cfg, BUDGET_GIB * 2**30) if per_block else None
    out = {"config": name, "prompts": lens, "weights_gib": gib(weights), "built_gib": gib(built),
           "peak_allocated_gib": gib(torch.cuda.max_memory_allocated()),
           "peak_reserved_gib": gib(torch.cuda.max_memory_reserved()),
           "reserved_after_gib": gib(torch.cuda.memory_reserved()), "graph_pool_gib": gib(graph_pool),
           "kv_quant": eng.kv_quant, "kv_bytes_per_block": per_block, "kv_budget_gib": BUDGET_GIB,
           "blocks_for_budget": blocks,
           "sequences_for_budget": None if blocks is None else kvc.max_concurrent(eng.cfg, blocks, max_seq),
           "wall_s": wall, "tokens": {rid: toks[:8] for rid, toks in sorted(results.items())}}
    del server, eng, params, results
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(CONFIGS), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {gpu}; torch {torch.__version__}", flush=True)
    for name in args.only or CONFIGS:
        print(json.dumps(measure(name)), flush=True)


if __name__ == "__main__":
    main()
