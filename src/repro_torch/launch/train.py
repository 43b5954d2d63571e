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
runs the plain PyTorch versions.

``--mesh local --sharding {tp,fsdp,sp,ep}`` trains under a sharding plan,
as the reference's flags do: one rank per local card over ``nccl`` (two
ranks on the CPU over gloo with ``--device cpu``), the mesh's model axis
over the ranks under ``tp`` / ``sp`` / ``ep`` and its data axis under
``fsdp``, each rank drawing its slice of the seeded weights, every
projection through the strategy's sharded backend, the checkpoints whole
(``runtime/trainer.py``)::

    python -m repro_torch.launch.train --arch llama3-8b --reduced --device cpu --mesh local --sharding tp

``--mesh local --sharding pp --stages S`` trains the dense family through
pipeline stages (the reference's ``("stage", "data", "model")`` mesh, data
and model 1: S ranks, S gloo ranks on the CPU), each rank drawing its
stage's layers, every projection on the config's own backend,
``--microbatches`` GPipe microbatches a step (0: 2 x S).
``--compress-grads`` trains with int8 gradient compression and error
feedback (``AdamW(grad_transform=compression_transform())``), with or
without a plan::

    python -m repro_torch.launch.train --arch llama3-8b --reduced --device cpu --mesh local --sharding pp \
        --stages 2 --compress-grads

The production meshes (``--mesh single`` / ``multi``) and ``gspmd`` over
more than one rank raise (ROADMAP.md Queue 1 "Distributed").
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.distributed.compression import compression_transform
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import Trainer, TrainerConfig


_DIST = 'ROADMAP.md Queue 1 "Distributed"'
_EXPLICIT = {"tp": "dip_tp", "fsdp": "dip_fsdp", "sp": "dip_sp", "ep": "dip_ep"}


def _parse(argv):
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
    ap.add_argument("--mesh", default="none", choices=["none", "local", "single", "multi"])
    ap.add_argument("--sharding", default=None, choices=["gspmd", "tp", "fsdp", "sp", "ep", "pp"],
                    help="with --mesh local: the explicit strategy (its sharded backend) over the local ranks")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages for --sharding pp: the local mesh gets a leading 'stage' axis of this size")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="GPipe microbatches per step for --sharding pp (0 = auto: 2x stages)")
    ap.add_argument("--strict-sharding", action="store_true",
                    help="raise (instead of warn-once + replicate) when a weight dim does not divide its axis")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression with error feedback")
    args = ap.parse_args(argv)
    if args.mesh in ("single", "multi"):
        raise NotImplementedError(f"--mesh {args.mesh} (the production pod mesh) is not ported yet ({_DIST})")
    if args.stages > 1 and args.sharding != "pp":
        raise NotImplementedError(f"--stages beside --sharding {args.sharding}: a stage axis under another strategy "
                                  f"is not ported yet ({_DIST})")
    if args.sharding == "pp" and args.stages < 2:
        raise ValueError("--sharding pp needs --stages >= 2 (the mesh's 'stage' axis)")
    if args.sharding not in (None, "gspmd") and args.mesh != "local":
        raise ValueError(f"--sharding {args.sharding} trains over ranks: pass --mesh local")
    return args


def _config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, matmul_backend="dip")
    if args.layers is not None:
        if cfg.is_hybrid and args.layers % cfg.attn_every:
            raise ValueError(f"--layers {args.layers}: a {cfg.name} cut must be a multiple of its "
                             f"attn_every = {cfg.attn_every} (each shared-block site closes a group)")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.sharding in _EXPLICIT:
        cfg = dataclasses.replace(cfg, sharding=args.sharding, matmul_backend=_EXPLICIT[args.sharding])
    elif args.sharding == "pp":  # a stage axis, not a backend: the stages keep the config's
        cfg = dataclasses.replace(cfg, sharding="pp")
    return cfg


def _train(args, plan=None):
    cfg = _config(args)
    print(f"[train] {cfg.name} {'reduced' if args.reduced else 'full width'}: {cfg.n_layers} layers "
          f"(published {get_config(args.arch).n_layers}), d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"params {cfg.param_dtype}, compute {cfg.compute_dtype}, batch {args.batch} x seq {args.seq}, "
          f"device {args.device}" + ("" if plan is None else f", {plan.strategy} over {dict(plan.mesh.shape)} "
                                     f"rank {plan.mesh.rank}"), flush=True)
    gt = compression_transform() if args.compress_grads else None
    trainer = Trainer(
        cfg,
        TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, log_every=1,
                      pipeline_microbatches=args.microbatches),
        optimizer=AdamW(lr=cosine_schedule(args.lr, 10, args.steps), grad_transform=gt),
        seq_len=args.seq, global_batch=args.batch, device=args.device, plan=plan,
    )
    return trainer.run(seed=args.seed)


def _train_rank(rank: int, argv):
    """One rank of ``--mesh local``: its card (or the CPU), the mesh over
    the world (the model axis under ``tp`` / ``sp`` / ``ep``, the data axis
    under ``fsdp``, with ``--stages`` the stage axis and the data axis over
    the rest, as the reference's), the plan, the trainer; returns its
    metrics."""
    from repro_torch.distributed import make_local_mesh, make_plan

    args = _parse(argv)
    world = torch.distributed.get_world_size()
    if args.stages > 1:
        axes = dict(data=world // args.stages, model=1, stage=args.stages)
    elif args.sharding == "fsdp":
        axes = dict(data=world, model=1)
    else:
        axes = dict(data=1, model=world)
    if args.device == "cpu":
        mesh = make_local_mesh(**axes)
    else:
        args.device = f"cuda:{rank}"
        mesh = make_local_mesh(**axes, transport="nccl", device=args.device)
    cfg = _config(args)
    plan = make_plan(mesh, cfg, "train", strict=args.strict_sharding)
    out = _train(args, None if plan.strategy == "gspmd" else plan)  # gspmd: one rank, nothing split
    return {"metrics": out["metrics"], "wall_s": out["wall_s"]}


def main(argv=None):
    """Parse ``argv``, train, print the summary line and return the run
    (under ``--mesh local`` rank 0's metrics and wall)."""
    args = _parse(argv)
    if args.mesh == "local":
        from repro_torch.distributed import run_world
        from repro_torch.models import transformer as tf_model

        if args.device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError("--mesh local on device='cuda' but torch.cuda.is_available() is False; pass "
                               "--device cpu to train over gloo ranks on the CPU")
        cfg = _config(args)
        tf_model._require_trainable(cfg)  # the families the strategy trains, checked before any rank starts
        ranks = (max(2, args.stages) if args.device == "cpu" else torch.cuda.device_count())
        if ranks % args.stages:
            raise SystemExit(f"--stages {args.stages} does not divide {ranks} devices")
        if cfg.sharding == "gspmd" and ranks > 1:
            raise NotImplementedError(f"implicit gspmd partitioning over more than one rank is not ported yet "
                                      f"({_DIST})")
        out = run_world(_train_rank, ranks, list(argv if argv is not None else sys.argv[1:]), timeout=3600.0)[0]
    else:
        out = _train(args)
    print(json.dumps({"train": {"steps": len(out["metrics"]), "wall_s": out["wall_s"],
                                "final_loss": out["metrics"][-1]["loss"] if out["metrics"] else None}}))
    return out


if __name__ == "__main__":
    main()
