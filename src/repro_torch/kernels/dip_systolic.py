"""DiP wavefront kernel: the array's dataflow, step by step (port of
``repro/kernels/dip_systolic.py::dip_systolic_pallas``).

For each 64-deep K tile, PE row r holds permutated weight row ``P[r, :]``
and the input arrives rotated left by r::

    acc[m, i] += x[m, (i + r) % 64] * P[r, i]        r = 0..63

``csrc/dip_systolic.cu`` runs that literally on the CUDA cores, consuming
the permutated storage without de-shearing it, with the rmsnorm prologue on
load and the epilogue at the flush.  It validates the dataflow; it is not
the fast path (that is ``dip_matmul``).  It computes the same function as
``dip_matmul`` — the reference pins both to one oracle — so its plain
version is :func:`~repro_torch.kernels.dip_matmul.dip_matmul_plain` and its
operands, dtypes and output dtype are the same: f32 and bf16 inputs
accumulate in f32, int8 in exact int32 (int32 out without an epilogue).

:func:`dip_systolic` launches the kernel for CUDA tensors and runs
:func:`dip_systolic_plain` for CPU tensors.  ``dip_systolic.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels import prologue as pro
from repro_torch.kernels.dip_matmul import DTYPE_CODES, dip_matmul_plain, launch_operands

__all__ = ["dip_systolic", "dip_systolic_plain"]


def dip_systolic_plain(x, p, *epilogue_operands, epilogue="none", prologue="none", prologue_operands=(),
                       prologue_k=None, prologue_eps=pro.DEFAULT_EPS) -> torch.Tensor:
    """The kernel's function in plain torch (``ref.dip_systolic_ref`` with
    the prologue and epilogue)."""
    return dip_matmul_plain(x, p, *epilogue_operands, epilogue=epilogue, prologue=prologue,
                            prologue_operands=prologue_operands, prologue_k=prologue_k,
                            prologue_eps=prologue_eps)


def _lib():
    lib = _build.load("dip_systolic")
    fn = lib.dip_systolic_launch
    if fn.argtypes is None:  # declare once: untyped ints would truncate the pointers
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dip_systolic(x: torch.Tensor, p: torch.Tensor, *epilogue_operands: torch.Tensor,
                 epilogue: str = "none", prologue: str = "none",
                 prologue_operands: Sequence[torch.Tensor] = (), prologue_k: Optional[int] = None,
                 prologue_eps: float = pro.DEFAULT_EPS) -> torch.Tensor:
    """``epilogue(prologue(x) @ unpermute_tiled(p))`` by the wavefront, with
    the operands of :func:`~repro_torch.kernels.dip_matmul.dip_matmul`.
    CPU tensors take :func:`dip_systolic_plain`; CUDA tensors launch the
    kernel or raise."""
    if x.device.type == "cpu":
        return dip_systolic_plain(x, p, *epilogue_operands, epilogue=epilogue, prologue=prologue,
                                  prologue_operands=prologue_operands, prologue_k=prologue_k,
                                  prologue_eps=prologue_eps)
    if x.device.type != "cuda":
        raise ValueError(f"dip_systolic runs on cuda or cpu tensors, got {x.device}")
    out, ptrs = launch_operands("dip_systolic", x, p, epilogue_operands, epilogue, prologue,
                                prologue_operands, prologue_k, prologue_eps)
    (m, k), n = x.shape, p.shape[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib()(DTYPE_CODES[x.dtype], *ptrs, m, n, k, epi.code(epilogue), stream)
    if rc != 0:
        raise RuntimeError(f"dip_systolic kernel launch failed: cudaError {rc}")
    dip_systolic.launches += 1
    return out


dip_systolic.launches = 0
