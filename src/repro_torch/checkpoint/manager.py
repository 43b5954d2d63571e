"""Checkpointing in the reference's on-disk layout (port of
``repro/checkpoint/manager.py``)::

    <dir>/step_00000123.tmp-<nonce>/   while writing
        leaf_00000.npy ...             one file per tree leaf
        manifest.json                  leaf paths, dtypes, shapes, crc32, meta
    <dir>/step_00000123/               atomically renamed when complete

A checkpoint written by the reference's ``Trainer`` restores here and the
other way round.  Leaves are named by the reference's paths
(``jax.tree_util.tree_flatten_with_path`` joined by ``/``): dict keys as
``['params']``, a ``DipWeight``'s storage as ``.data`` and its optional
ABFT checksum as ``.checksum/.col`` ... (``tree``).  A checkpoint whose
``DipWeight`` carries a checksum restores into a target without one: the
checksum is placed on the restored weight.  Any other leaf the target tree
cannot place raises.  A ``DipWeight``'s ``WeightPlan`` is written as its
``describe()`` form (the mesh reduced to axis sizes) beside its logical
dims, and a restore validates it against the target's live plan, as the
reference does: the kind and axes must agree where both sides carry a plan,
and the saved axes must exist in the live mesh.  bf16 leaves are stored as ``uint16`` views with the
manifest naming the real dtype, as the reference stores them.

* **Atomicity** — a step directory either has a complete manifest or is a
  ``.tmp-*`` orphan, removed when a manager opens the directory.
* **Async** — ``save(..., blocking=False)`` copies the tree to host memory
  at once (the trainer updates parameters in place) and writes the files on
  a background thread; at most one save is in flight.
* **Retention** — the newest ``keep`` steps are kept.
* **Integrity** — every leaf's crc32 is in the manifest and is checked on
  restore.
* **In place** — a restore writes into the target tree's tensors, so a
  trainer resuming at full width holds one state on the card, not two.
* **Mesh-independent** (the reference's elastic re-mesh restore) —
  ``save(..., plan=)`` under a ``ShardingPlan`` writes whole leaves: every
  rank gathers the parameters and moments synchronously, leaf by leaf
  (``plan.gather_leaf``: the collectives are issued here, never on the
  writer thread), and one rank (rank 0 of the mesh) copies each to the
  host as it comes and writes them.  ``restore(like, plan=)`` reads each whole leaf and places this
  rank's slice of it into ``like`` (``plan.shard_leaf``), so a checkpoint
  restores into the same mesh, another strategy's plan or one rank alike;
  the plan-compatibility check of each ``DipWeight`` keeps its errors.
* **Fail-points** — ``checkpoint.save.mid_write`` trips in a leaf write
  other than the first (on the writer threads: the exception leaves
  ``pool.map`` before the manifest is written) and
  ``checkpoint.save.pre_rename`` after the manifest, before the rename
  (``reliability.inject``); either leaves a ``.tmp-*`` orphan and the
  previous step restorable.
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.api.weights import DipWeight
from repro_torch.reliability.abft import AbftChecksum
from repro_torch.reliability.inject import maybe_fail

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree", "checkpoint_meta"]

_NUMPY_DTYPES = {torch.float32: "float32", torch.int32: "int32", torch.int64: "int64",
                 torch.bfloat16: "bfloat16"}
_TORCH_DTYPES = {name: dt for dt, name in _NUMPY_DTYPES.items()}


def _to_numpy(leaf, copy: bool = True) -> np.ndarray:
    """A host copy of one leaf (``copy=False``: a host tensor's own memory,
    for a leaf that already is a fresh host copy); Python ints become int32
    0-d arrays, as the reference's step counters are."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf, dtype=np.float32)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor):
        return _NUMPY_DTYPES.get(leaf.dtype, str(arr.dtype))
    return str(arr.dtype)


def _dip_index(t: Any, prefix: str = "") -> Dict[str, Dict]:
    """path -> logical-shape metadata (and plan) of every ``DipWeight`` node."""
    out: Dict[str, Dict] = {}
    if isinstance(t, dict):
        for k in sorted(t):
            out.update(_dip_index(t[k], f"{prefix}/[{k!r}]" if prefix else f"[{k!r}]"))
    elif isinstance(t, DipWeight):
        out[prefix] = {"d_in": t.d_in, "d_out": t.d_out, "perm_tile": t.perm_tile}
        if t.plan is not None:
            out[prefix]["plan"] = t.plan.describe()
    return out


_DIP_CORE_KEYS = ("d_in", "d_out", "perm_tile")


def _check_dip_entry(path: str, saved: Dict, live: Dict) -> None:
    """The reference's restore-time check of one weight: the logical dims
    exactly; the plans for compatibility (kind and axes where both sides
    carry one, the saved axes present in the live mesh)."""
    if any(saved.get(k) != live.get(k) for k in _DIP_CORE_KEYS):
        raise ValueError(f"DipWeight metadata mismatch at {path}: checkpoint {saved}, restore target {live}")
    sp, lp = saved.get("plan"), live.get("plan")
    if not sp or not lp:
        return
    if (sp.get("kind"), sp.get("axis"), sp.get("fsdp")) != (lp.get("kind"), lp.get("axis"), lp.get("fsdp")):
        raise ValueError(f"ShardingPlan mismatch at {path}: checkpoint plan {sp}, restore target plan {lp}")
    live_axes = lp.get("mesh_axes") or {}
    for a in (sp.get("axis"), sp.get("fsdp")):
        if a and a not in live_axes:
            raise ValueError(f"ShardingPlan mismatch at {path}: saved plan shards over axis {a!r} which the "
                             f"live mesh (axes {sorted(live_axes)}) does not have")


_THREADS = min(8, os.cpu_count() or 1)  # the threads that write or read and check the leaf files
_READ_AHEAD_BYTES = 16 << 30  # a restore's files in host memory at once, beyond the one being copied


def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=_THREADS)


def _snapshot(state: Any):
    """``(path, host array, dtype name)`` of every leaf, copied now."""
    out = []
    for p, leaf in tree.paths(state):
        arr = _to_numpy(leaf)
        out.append((p, arr, _dtype_name(leaf, arr)))
    return out


def _snapshot_gathered(state: Any, plan, prefix: str = "") -> Optional[List]:
    """:func:`_snapshot` of the whole leaves of a state that every rank
    holds its slices of: each leaf gathered into host memory
    (``plan.gather_leaf(to_host=True)``, on every rank, in one order) and
    kept by the mesh's rank 0 (the others return None)."""
    out: List = []
    writer = plan.mesh.rank == 0

    def walk(t, prefix, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}/[{k!r}]" if prefix else f"[{k!r}]", k)
            return
        whole = plan.gather_leaf(name, t, to_host=True)
        for p, leaf in tree.paths(whole, prefix):
            if writer:
                arr = _to_numpy(leaf, copy=False)  # gathered into fresh host memory
                out.append((p, arr, _dtype_name(leaf, arr)))

    walk(state, prefix, None)
    return out if writer else None


def _write(path: str, snapshot, dip_index: Dict, meta: Optional[Dict]) -> None:
    tmp = f"{path}.tmp-{secrets.token_hex(4)}"
    os.makedirs(tmp, exist_ok=True)

    def one(i):
        if i > 0:
            maybe_fail("checkpoint.save.mid_write")
        p, arr, dtype_name = snapshot[i]
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        return {"path": p, "file": fname, "shape": list(arr.shape), "dtype": dtype_name,
                "crc32": zlib.crc32(np.ascontiguousarray(arr))}

    with _pool() as pool:  # the writes and the crc32 release the GIL
        index: List[Dict] = list(pool.map(one, range(len(snapshot))))
    manifest = {"leaves": index, "meta": meta or {}, "dip_weights": dip_index}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    maybe_fail("checkpoint.save.pre_rename")
    os.replace(tmp, path) if not os.path.exists(path) else shutil.rmtree(tmp)


def save_pytree(path: str, state: Any, *, meta: Optional[Dict] = None) -> None:
    """Write one complete checkpoint directory atomically (blocking)."""
    _write(path, _snapshot(state), _dip_index(state), meta)


def _as_torch(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A freshly loaded leaf as a torch tensor over the same memory."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.dtype(dtype_name)))


def _from_numpy(arr, dtype_name: str, like):
    if isinstance(arr, torch.Tensor):  # already cut to this rank's slice (a restore under a plan)
        t = arr
    elif dtype_name == "bfloat16":
        t = _as_torch(arr, dtype_name)
    else:
        t = torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_name)))
    if isinstance(like, torch.Tensor):
        if t.dtype != like.dtype or tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf is {t.dtype}{tuple(t.shape)} in the checkpoint, "
                             f"{like.dtype}{tuple(like.shape)} in the restore target")
        with torch.no_grad():  # into the target's own storage: no second copy of the state on the card
            return like.copy_(t)
    if tuple(t.shape) != ():
        raise ValueError(f"a scalar leaf holds shape {tuple(t.shape)} in the checkpoint")
    return type(like)(t.item())


def _place_checksums(t: Any, by_path: Dict[str, Dict], prefix: str = "") -> Any:
    """``t`` with an empty ``AbftChecksum`` on each ``DipWeight`` that has
    none where the checkpoint holds ``.checksum`` leaves for it (the
    restore fills them)."""
    if isinstance(t, dict):
        return {k: _place_checksums(v, by_path, f"{prefix}/[{k!r}]" if prefix else f"[{k!r}]")
                for k, v in t.items()}
    if isinstance(t, DipWeight) and t.checksum is None:
        entries = [by_path.get(f"{prefix}/.checksum/.{f}") for f in AbftChecksum._fields]
        if any(entries):
            return t.with_checksum(AbftChecksum(*(
                None if e is None else torch.empty(e["shape"], dtype=_TORCH_DTYPES[e["dtype"]],
                                                   device=t.data.device) for e in entries)))
    return t


def _placer(plan, live_dip: Dict[str, Dict]):
    """``place(path, whole)``: this rank's slice under ``plan`` of the whole
    leaf at ``path`` (a host tensor), cut as ``plan.shard_leaf`` cuts the
    leaf it names (a ``DipWeight``'s storage wrapped with the live
    weight's metadata first)."""
    def place(path: str, whole: torch.Tensor) -> torch.Tensor:
        parts = path.split("/")
        if parts[-1] == ".data":
            meta = live_dip["/".join(parts[:-1])]
            name = parts[-2][2:-2]
            w = DipWeight(whole, meta["d_in"], meta["d_out"], meta["perm_tile"])
            return plan.shard_leaf(name, w).data
        name = parts[-1][2:-2] if parts[-1].startswith("['") else parts[-1]
        return plan.shard_leaf(name, whole)

    return place


def restore_pytree(path: str, like: Any, *, plan=None) -> Any:
    """Restore into the structure of ``like``: each tensor leaf is
    overwritten in place (it must have the saved dtype and shape), so a
    full-width state is never held twice on the card; Python-number leaves
    come back as numbers.  A leaf that fails its check raises, and the
    leaves before it are already overwritten.  ``plan``: ``like`` holds this
    rank's slices under it, and each whole saved leaf is cut to its slice
    (``plan.shard_leaf``) before the copy."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    live_dip = _dip_index(like)
    place = None if plan is None else _placer(plan, live_dip)
    for p, saved in manifest.get("dip_weights", {}).items():
        live = live_dip.get(p)
        if live is not None:
            _check_dip_entry(p, saved, live)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    like = _place_checksums(like, by_path)
    pairs = tree.paths(like)
    extra = sorted(set(by_path) - {p for p, _ in pairs})
    missing = sorted({p for p, _ in pairs} - set(by_path))
    if missing or extra:
        raise ValueError(f"checkpoint/tree mismatch; missing={missing} extra={extra}")

    def load(p):
        entry = by_path[p]
        arr = np.load(os.path.join(path, entry["file"]))
        want = entry.get("crc32")
        intact = want is None or zlib.crc32(np.ascontiguousarray(arr)) == want
        if place is not None and intact and arr.ndim:
            arr = place(p, _as_torch(arr, entry["dtype"]))  # the rank's slice, one copy
        return arr, intact

    def nbytes(p):
        entry = by_path[p]
        size = 2 if entry["dtype"] == "bfloat16" else np.dtype(entry["dtype"]).itemsize
        return size * int(np.prod(entry["shape"], dtype=np.int64))

    out = []
    ahead: Deque = deque()  # (path, leaf, bytes, future) read and checked ahead of the copies, in order
    queued = 0
    with _pool() as pool:
        todo = iter(pairs)
        nxt = next(todo, None)
        while nxt is not None or ahead:
            # top up: at most _READ_AHEAD_BYTES of files in host memory
            # (one leaf at least), at most one file per thread
            while nxt is not None and len(ahead) < _THREADS and (
                    not ahead or queued + nbytes(nxt[0]) <= _READ_AHEAD_BYTES):
                size = nbytes(nxt[0])
                ahead.append((nxt[0], nxt[1], size, pool.submit(load, nxt[0])))
                queued += size
                nxt = next(todo, None)
            p, leaf, size, fut = ahead.popleft()
            arr, intact = fut.result()
            queued -= size
            if not intact:
                raise ValueError(f"checkpoint integrity failure at leaf {p!r} ({by_path[p]['file']}): "
                                 "crc32 differs from the manifest")
            try:
                out.append(_from_numpy(arr, by_path[p]["dtype"], leaf))
            except ValueError as e:
                raise ValueError(f"{p}: {e}") from None
            del arr
    return tree.unflatten(like, out)


def checkpoint_meta(path: str) -> Dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["meta"]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._inflight: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._gc_orphans()

    def _step_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _gc_orphans(self) -> None:
        for name in os.listdir(self.dir):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    def save(self, step: int, state: Any, *, meta: Optional[Dict] = None,
             blocking: bool = True, plan=None) -> None:
        """Write ``state`` as step ``step`` (module doc); under ``plan``
        every rank calls it: the whole leaves are gathered on every rank
        (collective, synchronous) and written by the mesh's rank 0 alone."""
        self.wait()  # back-pressure: one in-flight save at most
        meta = dict(meta or {}, step=step)
        dips = _dip_index(state)
        if plan is None:
            snap = _snapshot(state)  # copy now: params change in place
        else:
            snap = _snapshot_gathered(state, plan)
            if snap is None:  # not the writing rank
                return

        def work():
            try:
                _write(self._step_path(step), snap, dips, meta)
                self._retain()
            except BaseException as e:  # surfaced by wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._inflight = threading.Thread(target=work, daemon=True)
            self._inflight.start()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_path(s), ignore_errors=True)

    def restore(self, like: Any, *, step: Optional[int] = None, plan=None):
        """``(tree, meta)`` of ``step`` (default: the latest), or
        ``(None, None)`` when there is none.  ``like`` is consumed: its
        tensors are overwritten in place and the returned tree holds them;
        if a leaf fails its crc32, the leaves before it are already
        overwritten.  ``plan``: ``like`` holds this rank's slices under it
        (module doc)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = self._step_path(step)
        return restore_pytree(path, like, plan=plan), checkpoint_meta(path)
