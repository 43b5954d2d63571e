"""The checkpoint drill of training under a plan at full width, on one CUDA
card shared by 2 ranks (the ``host`` transport), apart from
``chip_smoke.py`` for its time: a full-width state of phase 10's cut is
~18 GB of whole leaves (PERF.md §4).

For llama3-8b under ``tp`` and DeepSeek-V2-Lite under ``ep``, each cut to
2 layers (phase 10a's and 10b's configurations: f32 parameters, bf16
compute, block remat, batch 2 x 1024), and llama3-8b over 2 pipeline
stages (``pp``, phase 10d's: 2 layers, batch 4 x 256, from step 2 with
compressed gradients, so the checkpoint also holds the error-feedback
buffers), it runs ``chip_smoke``'s rank body with the drill on: the first
step against the single-rank step, steps 2 and 3, a checkpoint at step 2
under the plan (every rank gathers each whole leaf, rank 0 writes), that
checkpoint restored on rank 0 alone
(whole leaves in host memory, no plan) and cut to each rank's slices
(crc32 of every leaf against the live slices), and restored on the same
mesh (``CheckpointManager.restore(plan=)``), giving step 3 bit for bit.
It prints phase 10's lines with the save, restore and one-rank seconds
beside the card's name and power limit, and exits 1 if a hold fails::

    python3 tools/torch_sharded_ckpt.py                   # 10a and 10b
    python3 tools/torch_sharded_ckpt.py 10a               # llama3-8b under tp only
    python3 tools/torch_sharded_ckpt.py --sharding pp     # 10d: llama3-8b over 2 stages
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# tag -> (arch, strategy, replay the ranks' expert ids, layers, batch)
MODELS = {"10a": ("llama3-8b", "tp", False, cs.TRAIN10_LAYERS, cs.TRAIN10_BATCH),
          "10b": ("deepseek-v2-lite-16b", "ep", True, cs.TRAIN10_LAYERS, cs.TRAIN10_BATCH),
          "10d": ("llama3-8b", "pp", False, cs.TRAIN10D_LAYERS, cs.TRAIN10D_BATCH)}


def _rank(rank, tag):
    # before this rank's first CUDA allocation: freed blocks go back to the card for the other rank
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    warnings.simplefilter("ignore", UserWarning)  # the width fallbacks (w_krope) announce once
    arch, strategy, replay, layers, batch = MODELS[tag]
    t0 = time.perf_counter()
    out = cs._phase10_model(cs.train10_config(arch, layers=layers), cs.train10_config(arch, strategy, layers=layers),
                            os.path.join(ROOT, "build", "sharded_ckpt", tag), torch.device("cuda", 0),
                            replay=replay, checkpoint=True, batch=batch, compress=strategy == "pp")
    out["world_phase_s"] = time.perf_counter() - t0
    return out


def main(argv=None):
    import argparse

    from repro_torch.distributed import run_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tags", nargs="*", help=f"the phases' models, of {list(MODELS)} (default 10a and 10b)")
    ap.add_argument("--sharding", choices=sorted({m[1] for m in MODELS.values()}), default=None,
                    help="the model of this strategy's phase")
    args = ap.parse_args(argv)
    if set(args.tags) - set(MODELS):
        ap.error(f"unknown phase {sorted(set(args.tags) - set(MODELS))}: one of {list(MODELS)}")
    tags = args.tags or ([t for t, m in MODELS.items() if m[1] == args.sharding] if args.sharding else ["10a", "10b"])
    if not torch.cuda.is_available():
        raise SystemExit("torch_sharded_ckpt.py needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    for tag in tags:
        arch, strategy, _, layers, _ = MODELS[tag]
        outs = run_world(_rank, 2, tag, timeout=1500.0)
        cs.check_train10(tag, outs, f"{arch} under {strategy} at full width cut to {layers} layers with the "
                                    "checkpoint drill", gpu)
    print("checkpoint drills passed", flush=True)


if __name__ == "__main__":
    main()
