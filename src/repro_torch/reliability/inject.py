"""Deterministic fault injection for chaos tests (port of
``repro/reliability/inject.py``).

Every device-data primitive is a function of ``(value, seed, target)``:
the same seed and target give the same corrupted bytes, and the same bytes
as the reference, because the positions and bits are drawn from
``numpy.random.default_rng(seed)`` in the reference's order.

Device-data faults (each returns a new tensor on the input's device and
leaves its input untouched, but :func:`corrupt_kv_block`):

* :func:`bitflip` — XOR seeded bit positions into a tensor's raw storage
  through a same-width integer view (``uint8`` for int8 and fp8-e4m3,
  ``int16`` for bf16, where bit 15 is ``-32768``; numpy has no bf16).
* :func:`plant_nan` — overwrite seeded elements with NaN (float tensors).
* :func:`corrupt_pytree` — address a leaf of a params/state tree by a
  substring of its path (``tree.paths``) and apply either of the above.
* :func:`corrupt_kv_block` — poison one physical block of a serving
  ``PagedKVCache`` IN PLACE: the first float pool in sorted name order
  (``k``; ``k_scale`` under int8 KV, whose codes cannot hold a NaN), so
  that a captured decode step, a CUDA graph over the pools' addresses,
  reads the poisoned rows.

Host-code faults (crash injection): :func:`failpoint` arms a named
fail-point for a ``with`` block and :func:`maybe_fail` raises at matching
sites: ``checkpoint.save.mid_write`` / ``.pre_rename``
(``checkpoint/manager.py``, whose leaf writes run on a thread pool, so a
trip is counted under a lock) and ``kv.alloc`` / ``kv.free``
(``serving/kv_cache.py``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

__all__ = [
    "bitflip",
    "plant_nan",
    "corrupt_pytree",
    "corrupt_kv_block",
    "failpoint",
    "maybe_fail",
    "InjectedFault",
]


class InjectedFault(RuntimeError):
    """Raised by an armed fail-point (distinguishable from real bugs)."""


# --------------------------------------------------------------------------
# device-data corruption
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NP_SIGNED = {2: np.int16, 4: np.int32, 8: np.int64}


def bitflip(t: torch.Tensor, *, seed: int, n_flips: int = 1, bit: Optional[int] = None) -> torch.Tensor:
    """A copy of ``t`` with ``n_flips`` seeded bits flipped in its raw
    storage.  ``bit`` pins the bit within each element (30 for an f32
    exponent bit, 14 for bf16, 6 for int8 / fp8-e4m3: flips the chaos tests
    rely on being loud); ``None`` draws it from the same seeded stream.  A
    position drawn twice is flipped twice, as in the reference's loop."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    width = out.element_size()
    raw = out.view(_INT_VIEW[width]).reshape(-1)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, raw.numel(), size=n_flips)
    bits = (np.full(n_flips, bit, np.uint64) if bit is not None
            else rng.integers(0, 8 * width, size=n_flips).astype(np.uint64))
    unsigned = np.dtype(f"u{width}")
    uniq, inv = np.unique(idx, return_inverse=True)
    masks = np.zeros(uniq.size, unsigned)
    np.bitwise_xor.at(masks, inv.reshape(-1), (np.uint64(1) << bits).astype(unsigned))
    if width > 1:  # torch has no unsigned view wider than a byte: the same bits, signed
        masks = masks.view(_NP_SIGNED[width])
    at = torch.from_numpy(uniq).to(raw.device)
    raw[at] = raw[at] ^ torch.from_numpy(masks).to(raw.device)
    return out


def plant_nan(t: torch.Tensor, *, seed: int, n: int = 1) -> torch.Tensor:
    """A copy of the float tensor ``t`` with ``n`` seeded elements NaN."""
    if not t.dtype.is_floating_point:
        raise ValueError(f"plant_nan needs a float tensor, got {t.dtype}")
    out = t.detach().clone(memory_format=torch.contiguous_format)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, out.numel(), size=n)
    out.view(-1)[torch.from_numpy(idx).to(out.device)] = float("nan")
    return out


def corrupt_pytree(tree: Any, target: str, *, seed: int, mode: str = "bitflip", bit: Optional[int] = None,
                   n: int = 1) -> Tuple[Any, str]:
    """Corrupt the first tensor leaf whose path contains ``target``.

    Returns ``(new_tree, hit_path)``: the hit leaf is a new tensor, every
    other leaf is the input's own.  Raises ``KeyError`` if no leaf matches.
    Leaf order (which leaf a substring hits) is ``tree.paths``' order, the
    reference's ``tree_flatten_with_path`` order."""
    if mode not in ("bitflip", "nan"):
        raise ValueError(f"mode must be 'bitflip'|'nan', got {mode!r}")
    hit = None
    flat = []
    for path, leaf in tree_lib.paths(tree):
        if hit is None and target in path and isinstance(leaf, torch.Tensor):
            hit = path
            leaf = bitflip(leaf, seed=seed, n_flips=n, bit=bit) if mode == "bitflip" else plant_nan(leaf, seed=seed, n=n)
        flat.append(leaf)
    if hit is None:
        raise KeyError(f"no tensor leaf path contains {target!r}")
    return tree_lib.unflatten(tree, flat), hit


def corrupt_kv_block(kv, block: int, *, seed: int = 0, mode: str = "nan") -> str:
    """Poison physical block ``block`` of a ``PagedKVCache`` in place.

    Pools are block-indexed ``(layers, num_blocks, block_size, ...)``;
    every layer's rows of the block are corrupted in the first float pool in
    sorted name order (a hybrid model's ``attn`` pools).  ``mode="nan"``
    writes NaN; ``"bitflip"`` flips half the block's elements' seeded bits,
    byte for byte as the reference.  Returns the pool's name."""
    layers = kv.pools["layers"]
    pools = layers["attn"] if isinstance(layers.get("attn"), dict) else layers
    for name in sorted(pools):
        pool = pools[name]
        if not isinstance(pool, torch.Tensor) or not pool.dtype.is_floating_point:
            continue
        if pool.dim() < 3 or pool.shape[1] <= block:
            continue
        with torch.no_grad():
            if mode == "nan":
                pool[:, block] = float("nan")
            else:
                rows = pool[:, block]
                pool[:, block] = bitflip(rows, seed=seed, n_flips=max(1, rows.numel() // 2))
        return name
    raise ValueError(f"no corruptible float pool for block {block} (block_size={kv.block_size})")


# --------------------------------------------------------------------------
# host fail-points (crash injection)
_ARMED: Dict[str, Callable[[], None]] = {}


@contextlib.contextmanager
def failpoint(name: str, *, exc: Any = InjectedFault, count: int = 1) -> Iterator[None]:
    """Arm fail-point ``name`` for the duration of the ``with`` block.

    The first ``count`` calls of ``maybe_fail(name)`` raise, from any
    thread; later calls pass.  ``exc`` may be an exception instance (raised
    as is), an exception class, or a zero-argument factory.  Re-arming an
    armed name raises."""
    if name in _ARMED:
        raise ValueError(f"fail-point {name!r} is already armed")
    remaining = [count]
    lock = threading.Lock()

    def trip() -> None:
        with lock:
            if remaining[0] <= 0:
                return
            remaining[0] -= 1
        if isinstance(exc, BaseException):
            raise exc
        if isinstance(exc, type) and issubclass(exc, BaseException):
            raise exc(f"injected fault at {name!r}")
        e = exc()
        raise e if isinstance(e, BaseException) else e(f"injected fault at {name!r}")

    _ARMED[name] = trip
    try:
        yield
    finally:
        _ARMED.pop(name, None)


def maybe_fail(name: str) -> None:
    """Call at an injection site; a no-op unless ``name`` is armed."""
    trip = _ARMED.get(name)
    if trip is not None:
        trip()
