"""Training launcher: any configuration through ``Trainer`` on the card.

Port of ``repro/launch/train.py`` for one device::

    python -m repro_torch.launch.train --arch llama3-8b --full --layers 4 \\
        --steps 4 --batch 4 --seq 1024
    python -m repro_torch.launch.train --arch deepseek-v2-lite-16b --full --layers 4 --steps 4 --batch 4 --seq 1024
    python -m repro_torch.launch.train --arch zamba2-2.7b --full --steps 4 --batch 4 --seq 1024
    python -m repro_torch.launch.train --arch mamba2-370m --reduced --device cpu --steps 3

``--arch`` takes every configuration: the dense ones, the MoE ones
(``deepseek-v2-lite-16b``; ``qwen3-moe-235b-a22b`` at ``--reduced`` on one
card), the SSM ``mamba2-370m`` (tied head), the hybrid ``zamba2-2.7b`` and
the stub frontends ``musicgen-medium`` and ``phi-3-vision-4.2b``, which the
trainer feeds the pipeline's precomputed embeddings.  Weights are drawn
from ``--seed`` in the configuration's dtypes (f32 parameters, bf16
compute) and stored DiP-permutated: every projection runs the DiP kernel
forward and the fused lm_head + cross-entropy kernel computes the loss.
``--layers`` cuts the depth (full-width training on one card takes 16 bytes
per parameter: f32 parameters, gradients and two AdamW moments); a
hybrid's cut must be a multiple of its ``attn_every``.  ``--device cpu``
runs the plain PyTorch versions.  Meshes, sharding strategies and gradient
compression come with ROADMAP.md Queue 1 "Distributed".
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import get_config
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", dest="reduced", action="store_false",
                      help="the published widths")
    size.add_argument("--reduced", dest="reduced", action="store_true",
                      help="the tiny same-family variant (default)")
    ap.set_defaults(reduced=True)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=TrainerConfig.ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, matmul_backend="dip")
    if args.layers is not None:
        if cfg.is_hybrid and args.layers % cfg.attn_every:
            raise ValueError(f"--layers {args.layers}: a {cfg.name} cut must be a multiple of its "
                             f"attn_every = {cfg.attn_every} (each shared-block site closes a group)")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    print(f"[train] {cfg.name} {'reduced' if args.reduced else 'full width'}: {cfg.n_layers} layers "
          f"(published {get_config(args.arch).n_layers}), d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"params {cfg.param_dtype}, compute {cfg.compute_dtype}, batch {args.batch} x seq {args.seq}, "
          f"device {args.device}", flush=True)
    trainer = Trainer(
        cfg,
        TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, log_every=1),
        optimizer=AdamW(lr=cosine_schedule(args.lr, 10, args.steps)),
        seq_len=args.seq, global_batch=args.batch, device=args.device,
    )
    out = trainer.run(seed=args.seed)
    print(json.dumps({"train": {"steps": len(out["metrics"]), "wall_s": out["wall_s"],
                                "final_loss": out["metrics"][-1]["loss"] if out["metrics"] else None}}))
    return out


if __name__ == "__main__":
    main()
