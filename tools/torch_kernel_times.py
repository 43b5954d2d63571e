"""Device times of ``lm_head_ce`` with f32 x against the f32 head on one
CUDA card, for comparing two trees of the port in one call.

``chip_smoke.py`` phase 7 times the route of its own tree; this tool times
whichever tree ``PYTHONPATH`` names, so a parent whose f32 x f32 kernel is
gone can be timed beside the change.  It times with phase 7's timer
(``chip_smoke.device_ms``: CUDA-event median after warm-ups, a 256 MiB
buffer written before each launch, the launch queued behind a ~1 ms device
sleep), at llama3-8b's training head (T = 4092, D = 4096, Vp = 129024,
vocab 128256) and at the families' heads (DeepSeek-V2-Lite, Zamba2-2.7B,
Mamba2-370M, musicgen-medium), with ``torch.matmul`` of the f32 product on
the same inputs beside it.  Each line is one JSON object.

It imports only ``torch``, ``repro_torch`` from wherever ``PYTHONPATH``
finds it, and the timer from this checkout's ``chip_smoke.py``::

    PYTHONPATH=src python tools/torch_kernel_times.py
    PYTHONPATH=/path/to/other/checkout/src python tools/torch_kernel_times.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import device_ms  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.kernels import lm_head_ce as ce  # noqa: E402

SEED = 0
# (name, d_model, padded vocab, vocab): the training heads of chip_smoke.py phases 6-6e
HEADS = [("llama3-8b", 4096, 129024, 128256), ("deepseek-v2-lite-16b", 2048, 102400, 102400),
         ("zamba2-2.7b", 2560, 32768, 32000), ("mamba2-370m", 1024, 51200, 50280),
         ("musicgen-medium", 1536, 2048, 2048)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    t = 4 * 1023
    with torch.no_grad():
        for name, d, vp, vocab in HEADS:
            w = torch.randn(d, vp, generator=g, device=dev) * d ** -0.5
            labels = torch.randint(0, vocab, (t,), generator=g, device=dev, dtype=torch.int32)
            x = torch.randn(t, d, generator=g, device=dev)
            print(json.dumps(dict(
                kernel="lm_head_ce", dtype="float32 x float32", shape=f"{name} T={t} D={d} Vp={vp} vocab={vocab}",
                ms=device_ms(lambda: ce.lm_head_ce(x, w, labels, vocab_size=vocab), flush, iters=5, warmup=1),
                library_ms=device_ms(lambda: torch.matmul(x, w), flush, iters=5, warmup=1),
                card=card, tree=repro_torch.__file__)), flush=True)
            del w, x
    return 0


if __name__ == "__main__":
    sys.exit(main())
