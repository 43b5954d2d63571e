"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

No JAX counterpart: Pallas compiles inside ``jax.jit``.  Each ``csrc/<name>.cu``
has a plain C interface and is compiled on its own into
``<repo>/build/kernels/lib<name>-<hash>.so``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited kernel is rebuilt and an unchanged one is reused.  :func:`build` starts one ``nvcc`` per missing
library, all at once, and waits for them; :func:`load` calls it for a library
missing at first use.  ``nvcc``'s output (registers, shared memory, spills) is kept
beside each library as ``lib<name>-<hash>.log``.

:func:`refuse_grad` is the wrappers' shared guard: a ctypes launch returns
tensors with no ``grad_fn``, so a wrapper called where autograd would need
one raises instead of silently cutting the gradient.  :func:`check_aligned`
is the other: every kernel reads its operands with 16-byte vector loads or
``cp.async`` copies, so a contiguous view whose storage offset is not a
multiple of 16 bytes is refused before the launch (a misaligned load would
fault and leave the CUDA context unusable).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

__all__ = ["SOURCES", "build", "load", "library_path", "nvcc_path", "refuse_grad", "check_aligned"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("dip_matmul", "dip_matmul_q", "dip_systolic", "flash_attention", "lm_head_ce")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.RLock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Build every missing library of ``names``, one ``nvcc`` per source, all
    started together.  Returns the seconds it took."""
    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            log = open(out.with_suffix(".log"), "w")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs.append((name, out, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        rcs = [proc.wait() for *_, proc in jobs]  # every nvcc ends before any error is raised
        for *_, log, _ in jobs:
            log.close()
        for (name, out, tmp, *_), rc in zip(jobs, rcs):
            if rc != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n{out.with_suffix('.log').read_text()}")
            os.replace(tmp, out)  # atomic: a concurrent builder sees the old or the new file
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a launch of
    ``kernel``: grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward here; call it under torch.no_grad() "
            "or through the autograd path that owns it"
        )


def check_aligned(t: torch.Tensor, what: str) -> None:
    """Raise ``ValueError`` unless ``t``'s first element is 16-byte aligned
    (any device: the check reads only the address)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned (a view at storage offset {t.storage_offset()} "
                         f"of {t.dtype} is not); pass a fresh tensor or .clone() it")
