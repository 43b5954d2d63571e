"""Spawn a world of ranks on this host and gather their results.

``run_world(fn, nprocs, *args)`` starts ``nprocs`` processes (the ``spawn``
start method), initializes ``torch.distributed``'s default group in each
with gloo over a rendezvous of its own (a ``FileStore`` in a fresh
temporary directory, so concurrent worlds never meet; a mesh makes the
groups its transport needs, ``comm.build_mesh``), calls ``fn(rank,
*args)`` and returns the ranks' return values in rank order.  Each rank
keeps one intra-op CPU thread: the ranks are the host's parallelism
(eight-thread pools in every rank of a world would oversubscribe the host's
cores many times over).  The parent waits at most ``timeout`` seconds in
all: a hung or dead rank fails the call (every rank is then stopped)
instead of hanging the caller.  An exception in a rank is raised in the parent with
the rank's traceback.  ``fn`` must be importable by name (a module-level
function).  ``args`` and the return values are host data (numbers, numpy
arrays, CPU tensors): a CUDA tensor would reach the ranks through CUDA IPC
and keep the sender's memory while any rank still maps it, so a rank that
needs the card's data builds it there.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_world"]


def _entry(rank: int, nprocs: int, init_method: str, timeout: float, fn: Callable, args, results) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=nprocs,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent re-raises it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, nprocs: int, *args: Any, timeout: float = 120.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` spawned ranks (see module doc)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="repro_world_")
    init = f"file://{os.path.join(rdv, 'store')}"
    procs = [ctx.Process(target=_entry, args=(r, nprocs, init, timeout, fn, args, results), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_world: {nprocs - len(got)} of {nprocs} ranks gave no result in {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and not p.is_alive() and p.exitcode != 0]
                if dead:
                    raise RuntimeError(f"run_world: rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]}) without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_world: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rdv, ignore_errors=True)
    return [got[r] for r in range(nprocs)]
