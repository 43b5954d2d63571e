"""Train llama3-8b at full width, cut to a few layers and a smaller vocab,
through the JAX reference's ``Trainer`` and the port's on the CPU, from the
same weights, and print both runs' losses and gradient norms.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_wide_train.py \\
        [--layers 1] [--vocab 8192] [--batch 4] [--seq 64] [--steps 4]

The widths are llama3-8b's (d_model 4096, GQA 32/8, head_dim 128, d_ff
14336); f32 parameters, bf16 compute, block remat, the DiP backend on both
sides (the reference's Pallas kernels in interpret mode, the port's plain
versions) and ``launch.train``'s schedule (cosine, 10 warm-up steps to
3e-4).  The vocab is cut because the full 128256-wide embedding and head
hold 8.6 GB of f32 state per copy.  It shows what this configuration does
under that schedule, which the card runs at the full vocab, and how close
the port stays to the reference over the steps.
"""

import argparse
import dataclasses
import json
import sys
import tempfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)

    import jax
    from repro.configs import get_config as ref_get
    from repro.optim import AdamW as RefAdamW
    from repro.optim import cosine_schedule as ref_cosine
    from repro.runtime import Trainer as RefTrainer
    from repro.runtime import TrainerConfig as RefTrainerConfig
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import Trainer, TrainerConfig

    kw = dict(n_layers=args.layers, vocab_size=args.vocab, param_dtype="float32",
              compute_dtype="bfloat16", remat="block")
    ref_cfg = dataclasses.replace(ref_get("llama3_8b"), matmul_backend="pallas_dip", **kw)
    cfg = dataclasses.replace(get_config("llama3-8b"), matmul_backend="dip", **kw)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff) == (4096, 32, 8, 14336)
    print(f"llama3-8b widths, {args.layers} layer(s), vocab {args.vocab}, batch {args.batch} x seq {args.seq}, "
          f"{args.steps} steps", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tk = dict(steps=args.steps, ckpt_every=10 ** 9, log_every=1, async_ckpt=False)
        ref = RefTrainer(ref_cfg, RefTrainerConfig(ckpt_dir=f"{tmp}/ref", **tk),
                         optimizer=RefAdamW(lr=ref_cosine(args.lr, 10, args.steps)),
                         seq_len=args.seq, global_batch=args.batch)
        start = jax.tree_util.tree_map(np.asarray, ref.init_state(0)["params"])
        want = ref.run()["metrics"]
        del ref
        port = Trainer(cfg, TrainerConfig(ckpt_dir=f"{tmp}/port", **tk),
                       optimizer=AdamW(lr=cosine_schedule(args.lr, 10, args.steps)),
                       seq_len=args.seq, global_batch=args.batch, device="cpu")
        got = port.run(params=params_from_jax(start, cfg, device="cpu"))["metrics"]
    rows = [{"step": int(b["step"]), "loss": [float(b["loss"]), a["loss"]],
             "grad_norm": [float(b["grad_norm"]), a["grad_norm"]]} for a, b in zip(got, want)]
    for r in rows:
        print(json.dumps(r))  # [reference, port]
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
