"""Serving driver: random-weight requests through ``Server`` on the card.

Port of ``repro/launch/serve.py`` for the DiP path::

    python -m repro_torch.launch.serve --arch llama3-8b --full --requests 4

Weights are drawn on the device from ``--seed`` and stored DiP-permutated;
every projection runs the DiP kernel and chunked prefill the flash kernel.
``--device cpu`` runs the plain PyTorch versions instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import make_generator
from repro_torch.models import transformer as tf_model
from repro_torch.runtime import Request, Server, ServerConfig


def main(argv=None):
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, matmul_backend="dip", param_dtype=args.dtype,
                              compute_dtype=args.dtype)
    params = tf_model.init_params(cfg, make_generator(args.seed, args.device), args.device)
    server = Server(cfg, ServerConfig(batch_slots=args.slots, max_seq=args.max_seq,
                                      max_new_tokens=args.max_new,
                                      prefill_chunk=args.prefill_chunk),
                    params, device=args.device)
    rng = np.random.default_rng(args.seed)
    hi = max(5, min(args.max_seq // 2, 600))
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=int(rng.integers(4, hi))))
            for i in range(args.requests)]
    results = server.serve(reqs)
    for rid in sorted(results):
        print(f"req {rid}: {len(results[rid])} tokens -> {results[rid][:8]}...")
    print(json.dumps({"serve": server.last_stats}))
    return results


if __name__ == "__main__":
    main()
