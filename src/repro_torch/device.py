"""Device resolution, dtype names and seeded generators for the port.

No JAX counterpart: JAX picks its default backend itself.  The port's entry
points take ``device=`` (default ``"cuda"``) and resolve it here, so that a
host without a card fails loudly instead of quietly serving on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["DTYPES", "dtype_of", "resolve_device", "make_generator"]

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def dtype_of(name: Union[str, torch.dtype]) -> torch.dtype:
    """Map a config dtype name (``"bfloat16"``) to the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; supported: {sorted(DTYPES)}") from None


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is a CUDA device
    and no card is visible (pass ``device="cpu"`` to run the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_generator(seed: int, device: Union[str, torch.device]) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
