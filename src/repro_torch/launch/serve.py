"""Serving driver: random-weight requests through ``Server`` on the card.

Port of ``repro/launch/serve.py`` for the DiP path::

    python -m repro_torch.launch.serve --arch llama3-8b --full --requests 4

Weights are drawn on the device from ``--seed`` and stored DiP-permutated;
every projection runs the DiP kernel and chunked prefill the flash kernel.
``--quantize int8|fp8_e4m3`` quantizes the projections (the lm_head too)
and serves through the matching quantized kernel (``dip_int8w`` /
``dip_fp8``); ``--kv-quant int8`` stores the paged KV cache as int8 rows
with f32 scales.  ``--device cpu`` runs the plain PyTorch versions instead::

    python -m repro_torch.launch.serve --arch llama3-8b --full --quantize int8 --kv-quant int8

The MoE, SSM and hybrid configurations serve the same way, in bf16 or
quantized: their DiP projections go through the quantized kernel, while the
MoE router and expert banks, the SSM scalars and the tied head stay float
(only DiP-stored weights are quantized, as in the reference).  ``--kv-quant
int8`` pages MLA's latent rows with one scale per token and the hybrid's
shared-attention K/V per (token, head); a pure SSM model pages nothing, so
it changes nothing there.  ``qwen3-moe-235b-a22b`` serves at ``--reduced``
only::

    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --full
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --full --quantize int8 --kv-quant int8
    python -m repro_torch.launch.serve --arch zamba2-2.7b --full --quantize int8 --kv-quant int8
    python -m repro_torch.launch.serve --arch mamba2-370m --full --quantize fp8_e4m3

``--sharded tp`` serves tensor-parallel through ``dip_tp`` on a (data 1,
model T) mesh, ``--sharded fsdp`` ZeRO-3 through ``dip_fsdp`` on a (data
T, model 1) mesh (each rank K / T of every projection, gathered per
launch; a decode step's slots split over the ranks), as the reference's
``--sharded`` serves over the local devices: a world of one rank a local
card (over NCCL; on the CPU 2 ranks over gloo), each rank drawing only its
slice of the seeded weights (``init_params(plan=)``) and running the
engine on it; rank 0's results are printed.  Both serve the dense, moe,
ssm and hybrid families (the moe family under ``fsdp``: each rank K / T of
every projection and its block of each expert bank's contraction dim and
of the router, all gathered at the layer).  There is no ``--sharded sp``,
as the reference's launcher has none: the ``sp`` model path serves
through ``Server(plan=make_plan(mesh, cfg_sp, "decode"))``::

    python -m repro_torch.launch.serve --arch llama3-8b --full --sharded tp
    python -m repro_torch.launch.serve --arch zamba2-2.7b --full --sharded fsdp
    python -m repro_torch.launch.serve --arch llama3-8b --reduced --dtype float32 --device cpu --sharded fsdp
    python -m repro_torch.launch.serve --arch zamba2-2.7b --reduced --dtype float32 --device cpu --sharded tp
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --reduced --dtype float32 --device cpu --sharded fsdp
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.api.quant import scheme_info
from repro_torch.configs import get_config
from repro_torch.device import make_generator
from repro_torch.models import transformer as tf_model
from repro_torch.runtime import Request, Server, ServerConfig

_BACKENDS = {"tp": "dip_tp", "fsdp": "dip_fsdp"}


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", dest="reduced", action="store_false",
                      help="the published widths and depth")
    size.add_argument("--reduced", dest="reduced", action="store_true",
                      help="the tiny same-family variant (default)")
    ap.set_defaults(reduced=True)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="parameter and compute dtype")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--prefill-chunk", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, nargs=2, metavar=("LO", "HI"), default=None,
                    help="prompt lengths drawn from [LO, HI) (default [4, min(max_seq / 2, 600)))")
    ap.add_argument("--temperature", type=float, default=ServerConfig.temperature,
                    help="sampling temperature; 0 decodes greedily")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantize", choices=("int8", "fp8_e4m3"), default=None,
                    help="quantize the DiP projections and serve through the matching quantized "
                         "kernel (dip_int8w / dip_fp8)")
    ap.add_argument("--kv-quant", choices=("none", "int8"), default=None,
                    help="KV-cache storage (default cfg.kv_quant); int8 halves the bytes per token")
    ap.add_argument("--sharded", choices=("tp", "fsdp"), default=None,
                    help="serve through the explicit multi-rank backend (dip_tp / dip_fsdp): one rank a "
                         "local card (2 ranks on the CPU)")
    return ap.parse_args(argv)


def _config(args):
    """The served configuration of ``args``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, matmul_backend="dip", param_dtype=args.dtype, compute_dtype=args.dtype)
    if args.quantize:
        cfg = dataclasses.replace(cfg, quantization=args.quantize, matmul_backend=scheme_info(args.quantize).backend)
    if args.sharded:
        cfg = dataclasses.replace(cfg, sharding=args.sharded, matmul_backend=_BACKENDS[args.sharded])
    return cfg


def _setup(args, mesh=None):
    """The configuration, parameters, server config, seeded requests and
    plan of ``args``: the whole parameters, or over ``mesh`` this rank's
    slice of them (``init_params(plan=)``: no rank holds the whole model)
    and the plan that cut it."""
    cfg = _config(args)
    plan = None
    if mesh is not None:
        from repro_torch.distributed import make_plan

        plan = make_plan(mesh, cfg, "decode")
    params = tf_model.init_params(cfg, make_generator(args.seed, args.device), args.device, plan=plan)
    scfg = ServerConfig(batch_slots=args.slots, max_seq=args.max_seq, max_new_tokens=args.max_new,
                        temperature=args.temperature, prefill_chunk=args.prefill_chunk, kv_quant=args.kv_quant)
    rng = np.random.default_rng(args.seed)
    lo, hi = args.prompt_len or (4, max(5, min(args.max_seq // 2, 600)))
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=int(rng.integers(lo, hi))))
            for i in range(args.requests)]
    return cfg, params, scfg, reqs, plan


def _report(results, stats):
    for rid in sorted(results):
        print(f"req {rid}: {len(results[rid])} tokens -> {results[rid][:8]}...")
    print(json.dumps({"serve": stats}))


def _serve_rank(rank: int, argv):
    """One rank of ``--sharded``: its card (or the CPU), the mesh over the
    world (the model axis under ``tp``, the data axis under ``fsdp``), its
    slice of the same seeded weights, the engine on it."""
    from repro_torch.distributed import make_local_mesh

    args = _parse(argv)
    world = torch.distributed.get_world_size()
    axes = dict(data=1, model=world) if args.sharded == "tp" else dict(data=world, model=1)
    if args.device == "cpu":
        mesh = make_local_mesh(**axes)
    else:
        args.device = f"cuda:{rank}"
        mesh = make_local_mesh(**axes, transport="nccl", device=args.device)
    cfg, params, scfg, reqs, plan = _setup(args, mesh)
    server = Server(cfg, scfg, params, device=args.device, plan=plan)
    del params
    results = server.serve(reqs)
    return results, dict(server.last_stats, ranks=world, transport=mesh.transport)


def main(argv=None, on_server=None):
    """Parse ``argv``, build the server, serve the seeded requests, print
    the results and stats, and return ``{rid: tokens}``.  ``on_server``, if
    given, is called with the built ``Server`` and its requests before
    serving (a caller's hook for timing or recording the steps; not under
    ``--sharded``)."""
    args = _parse(argv)
    if args.sharded:
        from repro_torch.distributed import run_world

        if args.device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError(f"--sharded {args.sharded} on device='cuda' but torch.cuda.is_available() is False; "
                               "pass --device cpu to serve over gloo ranks on the CPU")
        # the families the strategy serves, checked here before any rank starts
        tf_model._require_served(_config(args))
        ranks = 2 if args.device == "cpu" else torch.cuda.device_count()
        out = run_world(_serve_rank, ranks, list(argv if argv is not None else sys.argv[1:]), timeout=3600.0)
        results, stats = out[0]
        _report(results, stats)
        return results
    cfg, params, scfg, reqs, _ = _setup(args)
    server = Server(cfg, scfg, params, device=args.device)
    if on_server is not None:
        on_server(server, reqs)
    results = server.serve(reqs)
    _report(results, server.last_stats)
    return results


if __name__ == "__main__":
    main()
