"""Admission queue and scheduling policy for the serving engine; plain
Python, copied from ``repro/serving/scheduler.py``.

The scheduler owns *which* request runs next and *who* gets evicted under
memory pressure; the engine owns the device work.  Policy here is FCFS with
head-of-line admission (a request is admitted the moment a slot AND its
prompt's KV blocks are both available) and LIFO preemption (the
latest-admitted running request is the victim — it has the least sunk decode
work and frees its blocks fastest).  A preempted request re-queues at the
*front* carrying its generated tokens, so its next admission re-prefills
prompt+generated and generation continues where it stopped.

Reliability additions (docs/reliability.md):

  * **Deadlines** — a request may carry ``deadline_s`` (monotonic-clock
    absolute); ``drop_expired`` sweeps the waiting queue each tick so a
    request that can never be served in time stops occupying the head.
  * **Retry backoff** — a request the engine faulted carries
    ``not_before_tick``; admission skips it (without blocking the requests
    behind it — a faulted head must not become head-of-line blocking) until
    the engine's tick counter catches up.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional

import numpy as np

__all__ = ["SamplingParams", "ServeRequest", "FCFSScheduler",
           "QUEUED", "PREFILL", "RUNNING", "DONE"]

QUEUED, PREFILL, RUNNING, DONE = "queued", "prefill", "running", "done"


@dataclasses.dataclass
class SamplingParams:
    """Per-request decode controls.  ``temperature <= 0`` is greedy (argmax,
    noise ignored); ``top_k=0`` / ``top_p=1.0`` disable those filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_new_tokens: int = 32
    seed: int = 0


@dataclasses.dataclass
class ServeRequest:
    """One request plus its runtime bookkeeping (engine-managed)."""

    rid: int
    prompt: np.ndarray                       # (prompt_len,) int32 — original
    sampling: SamplingParams
    on_token: Optional[Callable] = None      # (rid, token, done) per token

    # engine-managed runtime state
    state: str = QUEUED
    slot: int = -1
    admit_index: int = -1                    # admission order (victim pick)
    generated: List[int] = dataclasses.field(default_factory=list)
    rng: Optional[np.random.Generator] = None
    preemptions: int = 0
    arrival_s: float = 0.0
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None

    # reliability state (engine-managed; docs/reliability.md)
    deadline_s: Optional[float] = None       # absolute monotonic deadline
    retries: int = 0                         # fault-triggered re-prefills
    degraded: bool = False                   # decodes via the xla fallback
    not_before_tick: int = 0                 # admission backoff after a fault

    @property
    def serve_prompt(self) -> np.ndarray:
        """Tokens to prefill at (re-)admission: prompt + already-generated."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)]
        )

    @property
    def remaining_new_tokens(self) -> int:
        return self.sampling.max_new_tokens - len(self.generated)


class FCFSScheduler:
    """First-come-first-served queue with LIFO preemption.

    ``on_preempt(request)`` fires when the engine evicts a victim — the hook
    the satellite spec asks for (metrics, logging, or policy experiments
    plug in here without touching the engine).
    """

    def __init__(self, on_preempt: Optional[Callable] = None):
        self.waiting: Deque[ServeRequest] = collections.deque()
        self.on_preempt = on_preempt
        self._admitted = 0

    def __len__(self) -> int:
        return len(self.waiting)

    def add(self, req: ServeRequest) -> None:
        self.waiting.append(req)

    def next_waiting(self, tick: Optional[int] = None) -> Optional[ServeRequest]:
        """First admissible request.  With a ``tick``, requests still in
        retry backoff are skipped *without* blocking those behind them."""
        for req in self.waiting:
            if tick is None or req.not_before_tick <= tick:
                return req
        return None

    def pop(self, tick: Optional[int] = None) -> ServeRequest:
        """Remove and stamp the request :meth:`next_waiting` chose."""
        for i, req in enumerate(self.waiting):
            if tick is None or req.not_before_tick <= tick:
                del self.waiting[i]
                req.admit_index = self._admitted
                self._admitted += 1
                return req
        raise IndexError("no admissible request (all in retry backoff)")

    def drop_expired(self, now: float) -> List[ServeRequest]:
        """Sweep waiting requests whose deadline has passed (engine calls
        once per tick; returns them so it can record the eviction)."""
        expired = [
            r for r in self.waiting
            if r.deadline_s is not None and now >= r.deadline_s
        ]
        for r in expired:
            self.waiting.remove(r)
        return expired

    def pick_victim(self, running: List[ServeRequest]) -> ServeRequest:
        """Latest-admitted running request (least sunk decode work)."""
        return max(running, key=lambda r: r.admit_index)

    def preempt(self, req: ServeRequest) -> None:
        """Return an evicted request to the queue head."""
        req.state = QUEUED
        req.slot = -1
        req.preemptions += 1
        self.waiting.appendleft(req)
        if self.on_preempt is not None:
            self.on_preempt(req)
