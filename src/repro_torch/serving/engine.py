"""The serving engine: continuous batching over a paged KV pool (port of
``repro/serving/engine.py``).

One ``Engine`` owns a fixed pool of decode slots, a paged KV cache, and a
scheduler.  ``step()`` advances the whole pool by one tick:

    1. **admission** — the queue head is admitted the moment a slot and its
       prompt's KV blocks are both free (FCFS);
    2. **chunked prefill** — the admitted prompt runs through ``forward`` in
       fixed-size chunks with attention on the flash kernel (the chunk's
       cache offset reaches the kernel as a device tensor; MLA takes its
       absorbed form against the latent cache instead, as the reference
       does), then its K/V (MLA: latent rows) are imported into the slot's
       pool blocks.  For the SSM families the last ``plen mod
       prefill_chunk`` tokens run one at a time through the O(1) decode
       path instead of a padded chunk (the recurrent state is exact only
       over real tokens), and the conv history and state go to the slot's
       row of the per-slot pools;
    3. **decode** — one step serves every running slot (free slots compute
       into the null block and are ignored), each row sampled with its
       request's own params and seeded stream.

On the card the engine runs its steps as CUDA graphs
(``serving/graphs.py``), its counterpart of the reference's ``jax.jit``:
the first call of the decode step at (slots, 1) tokens, of the prefill
forward at (1, ``prefill_chunk``) and, for the SSM families, at (1, 1) for
the tail runs eagerly on the real caches and is then captured; every later
call replays.  The graphs share one memory pool.  The prefill writes one cache
that the engine holds for its life (reset on admission: ``pos`` to 0, the
conv history and state to 0; rows past ``pos`` are masked by the valid
length), so every prompt's chunks replay one graph.  A step's logits are
then a static buffer of the pool that the next replay of any of the
engine's graphs overwrites: the engine copies the rows it samples to the
host at once.  On the CPU (``device="cpu"``) the same
step functions run eagerly.

**Sharded serving** (``plan=``, the port of the reference's
``Engine(plan=)``): every rank of a tensor- or expert-parallel world (the
dense and moe families) runs one engine on the same requests, over its
slice of the parameters (pass the whole ones, which ``plan.shard_params``
cuts, or only the rank's slice from ``init_params(plan=)``, so that no rank
holds the whole model) and pools of its KV heads (MLA: the whole latent;
``kv_cache.bytes_per_block(..., plan=)`` is a rank's cost);
the block tables stay on the host.  Every rank sees the whole logits (the
lm_head's are all-gathered), so the ranks sample alike and stay in step.
Prefill keeps the non-flash attention path under a plan, as the reference
does.  The steps run eagerly (``captured`` is False, ``eager_reason``
says why): a gloo collective, the host transport's, cannot be captured in
a CUDA graph, and capturing sharded steps over NCCL is not ported yet
(ROADMAP.md Queue 1 "Distributed").  A ``"sharded"`` backend with no plan
raises; so does ``verify`` under one (its degraded step is single-device).

Rows are independent, so a greedy request's tokens do not depend on its
batch-mates.  Under memory pressure the scheduler's LIFO victim is evicted
and re-queued with its generated tokens (re-prefilled on re-admission).

**Fail-safe serving** (``EngineConfig.verify``, as the reference): each
tick screens every request's logits row (the host copy the engine samples
from) for nonfinite values, the signature of a corrupted KV block or a
tripped matmul.  A faulted request is retried (evicted, so that its
re-prefill rebuilds clean KV, with ``retry_backoff_ticks`` of admission
backoff), then degraded, then failed, while its batch-mates stream on.  The
degraded rung is the decode step with ``matmul_backend="torch"`` (the
reference's ``xla``): built on the first fault only, on the card a second
``CapturedStep`` at the decode shape in the engine's graph pool, and a tick
with a degraded request runs the whole pool through it.  A fault on a
degraded request finishes it with ``fault_failed``.  Requests may carry
deadlines (``ttl_s``, per request or engine-wide); expired ones, waiting or
running, are swept at the start of every tick.  A fault or an expiry during
a prefill drops the prefill, and keeps the one prefill cache the captured
prefill is bound to (reset at the next admission).  ``last_stats`` counts
``faults_detected``, ``retries``, ``deadline_evictions`` and
``degraded_requests``; ``request_stats`` carries each request's
``retries``, ``degraded``, ``deadline_expired`` and ``fault_failed``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf_model
from repro_torch.serving import graphs
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving import sampling
from repro_torch.serving.scheduler import (
    DONE, PREFILL, RUNNING, FCFSScheduler, SamplingParams, ServeRequest,
)

__all__ = ["Engine", "EngineConfig"]

_DISTRIBUTED = 'ROADMAP.md Queue 1 "Distributed"'


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4
    max_seq: int = 512                   # hard per-sequence context cap
    block_size: Optional[int] = None     # None -> cfg.kv_block_size
    kv_quant: Optional[str] = None       # None -> cfg.kv_quant
    num_blocks: Optional[int] = None     # None -> full occupancy, no preemption
    prefill_chunk: int = 64
    eos_id: int = 1
    # --- reliability ---
    verify: bool = False                 # screen the logits rows for nonfinite values
    max_retries: int = 1                 # fault-triggered re-prefills per request
    retry_backoff_ticks: int = 2         # admission backoff after a fault
    ttl_s: Optional[float] = None        # default per-request deadline


class Engine:
    """``add_request`` / ``step`` / ``run`` over a fixed slot pool on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``).  ``params`` come from ``init_params`` or
    ``convert.params_from_jax`` on that device; under a ``plan`` they are
    the whole parameters, of which the engine keeps this rank's slice, or
    that slice already (``init_params(plan=)``)."""

    def __init__(self, cfg, params, *, engine_cfg: Optional[EngineConfig] = None,
                 on_preempt: Optional[Callable] = None, device="cuda", plan=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg = engine_cfg or EngineConfig()
        be = api.get_backend(cfg.matmul_backend)  # fail fast on unknown backends
        if be.layout == "dip_q" and cfg.quant_scheme != be.scheme:
            raise ValueError(f"backend {be.name!r} consumes {be.scheme!r}-quantized weights "
                             f"but cfg.quantization={cfg.quantization!r}")
        if be.layout == "sharded" and plan is None:
            raise ValueError(f"backend {be.name!r} dispatches on the weights' ShardingPlan metadata; pass plan= "
                             "(distributed.make_plan) or serve on a single-device backend")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters are on {params['embed'].device}, the engine runs on {self.device}")
        self.plan = plan
        self.eager_reason = None
        if plan is not None:
            if ecfg.verify:
                raise NotImplementedError(f"verify= under a sharding plan is not ported yet ({_DISTRIBUTED})")
            if plan.mesh.device is not None and plan.mesh.device.type != self.device.type:
                raise ValueError(f"the plan's mesh is on {plan.mesh.device}, the engine runs on {self.device}")
            params = plan.shard_params(params)
            self.eager_reason = (
                f"sharded steps over the {plan.mesh.transport} transport run eagerly: "
                + ("a gloo collective cannot be captured in a CUDA graph" if plan.mesh.transport != "nccl"
                   else f"capturing them over NCCL is not ported yet ({_DISTRIBUTED})"))
        self.params = params

        self.block_size = ecfg.block_size or cfg.kv_block_size
        self.kv_quant = ecfg.kv_quant if ecfg.kv_quant is not None else cfg.kv_quant
        if self.kv_quant != "none":
            api.quant.scheme_info(self.kv_quant)  # validate the scheme name
        if self.kv_quant != cfg.kv_quant:
            # the paged decode step reads its storage format off the config
            cfg = self.cfg = dataclasses.replace(cfg, kv_quant=self.kv_quant)
        blocks_per_seq = -(-ecfg.max_seq // self.block_size)
        num_blocks = ecfg.num_blocks or ecfg.slots * blocks_per_seq + 1
        # pure SSM has no attention KV: its state is per slot, nothing is paged
        self._paged = not cfg.is_ssm
        self.kv = kvc.PagedKVCache(
            cfg, num_blocks=num_blocks, block_size=self.block_size, slots=ecfg.slots,
            max_seq=ecfg.max_seq, kv_quant=self.kv_quant, device=self.device, plan=plan,
        )
        decode = tf_model.paged_decode_step_fn(cfg, plan=plan)
        # chunked prefill runs attention on the flash kernel: the chunk's
        # cache offset is a device tensor, so every chunk shares one kernel;
        # under a plan the dense attention path, as the reference keeps it
        prefill = tf_model.decode_step_fn(cfg, attn_backend=None if plan is not None else "flash", plan=plan)
        # the import runs once a request, eagerly: not worth a graph
        self._import = kvc.make_import_fn(cfg, self.block_size, self.kv_quant)
        c = ecfg.prefill_chunk
        self._prefill_buf_len = -(-ecfg.max_seq // c) * c
        self._prefill_cache = tf_model.init_cache(cfg, 1, self._prefill_buf_len, device=self.device, plan=plan)
        # one memory pool for every graph of the engine: the steps never run at once
        self.captured = self.device.type == "cuda" and plan is None
        self._graph_pool = torch.cuda.graph_pool_handle() if self.captured else None
        self._decode = self._captured_decode(decode)
        if self._graph_pool is not None:
            widths = (c, 1) if cfg.ssm_state else (c,)
            self._prefill_fwd = graphs.CapturedStep(prefill, params, self._prefill_cache, [((1, w),) for w in widths],
                                                    pool=self._graph_pool)
        else:
            self._prefill_fwd = prefill

        self.scheduler = FCFSScheduler(on_preempt=on_preempt)
        self._slots: List[Optional[ServeRequest]] = [None] * ecfg.slots
        self._cur = np.zeros((ecfg.slots, 1), np.int64)     # next token to feed
        self._ctx = np.zeros((ecfg.slots,), np.int64)       # tokens in cache
        self._prefilling: Optional[ServeRequest] = None
        self._prefill_tokens: Optional[np.ndarray] = None
        self._prefill_done = 0
        self._next_rid = 0
        self.results: Dict[int, List[int]] = {}
        self.request_stats: Dict[int, Dict[str, Any]] = {}
        self._decode_steps = 0
        self._prefill_chunks = 0
        self._preempt_count = 0
        self._generated_total = 0
        self._tick = 0
        self.last_stats: Dict[str, Any] = {}
        # reliability bookkeeping
        self._faults_detected = 0
        self._retries_total = 0
        self._deadline_evictions = 0
        self._degraded_requests = 0
        self._decode_xla = None             # the degraded decode step, built on the first fault

    def _captured_decode(self, step):
        """The paged decode step ``step`` as the engine runs it: on the card
        a CUDA graph at (slots, 1) in the engine's graph pool, on the CPU the
        function itself."""
        if self._graph_pool is None:
            return step
        s = self.ecfg.slots
        return graphs.CapturedStep(step, self.params, self.kv.pools, [((s, 1), (s,), (s, self.kv.blocks_per_seq))],
                                   pool=self._graph_pool)

    # ------------------------------------------------------------ intake ---
    def add_request(self, prompt, sampling_params: Optional[SamplingParams] = None, *,
                    rid: Optional[int] = None, on_token: Optional[Callable] = None,
                    ttl_s: Optional[float] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size >= self.ecfg.max_seq:
            raise ValueError(
                f"prompt of {prompt.size} tokens leaves no room to generate "
                f"under max_seq={self.ecfg.max_seq}"
            )
        need = self.kv.blocks_needed(prompt.size)
        usable = self.kv.num_blocks - 1     # block 0 is the null block
        if self._paged and need > usable:
            raise ValueError(
                f"prompt of {prompt.size} tokens needs {need} KV blocks but the entire "
                f"pool has {usable} usable blocks of {self.block_size} — it can never be admitted"
            )
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        sp = sampling_params or SamplingParams()
        req = ServeRequest(rid=rid, prompt=prompt, sampling=sp, on_token=on_token)
        req.rng = np.random.default_rng(sp.seed)
        req.arrival_s = time.monotonic()
        ttl = ttl_s if ttl_s is not None else self.ecfg.ttl_s
        if ttl is not None:
            req.deadline_s = req.arrival_s + ttl
        self.scheduler.add(req)
        return rid

    # ----------------------------------------------------------- helpers ---
    @property
    def _running(self) -> List[ServeRequest]:
        return [r for r in self._slots if r is not None and r.state == RUNNING]

    def _busy(self) -> bool:
        return bool(len(self.scheduler) or self._prefilling is not None
                    or any(s is not None for s in self._slots))

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _ensure(self, slot: int, length: int) -> bool:
        return self.kv.ensure(slot, length) if self._paged else True

    def _release(self, slot: int) -> None:
        if self._paged:
            self.kv.release(slot)

    def _evict(self, req: ServeRequest) -> None:
        slot = req.slot
        self._release(slot)
        self._slots[slot] = None
        self._ctx[slot] = 0
        self._preempt_count += 1
        self.scheduler.preempt(req)

    def _finish(self, req: ServeRequest, *, deadline_expired: bool = False, fault_failed: bool = False) -> None:
        slot = req.slot
        if slot >= 0:
            self._release(slot)
            self._slots[slot] = None
            self._ctx[slot] = 0
        req.state = DONE
        req.finish_s = time.monotonic()
        self.results[req.rid] = list(req.generated)
        self.request_stats[req.rid] = {
            "prompt_len": int(req.prompt.size),
            "new_tokens": len(req.generated),
            "ttft_s": (req.first_token_s - req.arrival_s
                       if req.first_token_s is not None else None),
            "latency_s": req.finish_s - req.arrival_s,
            "preemptions": req.preemptions,
            "retries": req.retries,
            "degraded": req.degraded,
            "deadline_expired": deadline_expired,
            "fault_failed": fault_failed,
        }

    def _emit(self, req: ServeRequest, token: int, done: bool) -> None:
        req.generated.append(token)
        self._generated_total += 1
        if req.first_token_s is None:
            req.first_token_s = time.monotonic()
        if req.on_token is not None:
            req.on_token(req.rid, token, done)

    def _append_token(self, req: ServeRequest, token: int) -> bool:
        """Record one generated token; returns True if the request finished."""
        slot = req.slot
        done = (
            token == self.ecfg.eos_id
            or len(req.generated) + 1 >= req.sampling.max_new_tokens
            or int(self._ctx[slot]) >= self.ecfg.max_seq
        )
        self._emit(req, token, done)
        if done:
            self._finish(req)
            return True
        self._cur[slot, 0] = token
        return False

    def _sample_rows(self, logits: np.ndarray, reqs: List[Optional[ServeRequest]]) -> np.ndarray:
        """One vectorized draw over the (B, V) logits; rows without a request
        decode greedily and are ignored by the caller."""
        b, v = logits.shape
        temp = np.zeros(b, np.float32)
        top_k = np.zeros(b, np.int64)
        top_p = np.ones(b, np.float32)
        uniforms = np.zeros((b, v), np.float64)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            sp = r.sampling
            temp[i], top_k[i], top_p[i] = sp.temperature, sp.top_k, sp.top_p
            if sp.temperature > 0:
                uniforms[i] = r.rng.random(v)
        return sampling.sample_tokens(logits, temperature=temp, top_k=top_k, top_p=top_p,
                                      uniforms=uniforms)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A step's integer input as an int64 tensor: on the CPU the step's
        own input; on the card a host tensor that the captured step stages
        into its static buffers, or, for steps that run eagerly (under a
        plan), a copy on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        return t if self.captured or self.device.type == "cpu" else t.to(self.device)

    # ------------------------------------------------------------- faults --
    def _drop_prefill(self, req: ServeRequest) -> None:
        """Abandon ``req``'s prefill; the prefill cache stays (the captured
        prefill is bound to it) and is reset at the next admission."""
        if req is self._prefilling:
            self._prefilling = None
            self._prefill_tokens = None

    def _handle_fault(self, req: ServeRequest) -> None:
        """A screened row of ``req`` went nonfinite: a bounded retry (evict:
        the re-prefill rebuilds clean KV, after a tick backoff), then the
        degraded step, then give up.  Its batch-mates are untouched: rows
        are independent."""
        self._faults_detected += 1
        self._drop_prefill(req)
        if req.degraded:
            # the degraded step faulted too: persistent corruption
            self._finish(req, fault_failed=True)
            return
        req.not_before_tick = self._tick + self.ecfg.retry_backoff_ticks
        if req.retries < self.ecfg.max_retries:
            req.retries += 1
            self._retries_total += 1
        else:
            req.degraded = True
            self._degraded_requests += 1
        self._evict(req)

    def _get_decode_xla(self):
        """The decode step on the plain ``torch`` matmul backend (the
        reference's ``xla``), the bottom rung of the ladder; built on the
        first fault."""
        if self._decode_xla is None:
            cfg_torch = dataclasses.replace(self.cfg, matmul_backend="torch")
            self._decode_xla = self._captured_decode(tf_model.paged_decode_step_fn(cfg_torch))
        return self._decode_xla

    def _expire(self, req: ServeRequest) -> None:
        self._deadline_evictions += 1
        self._drop_prefill(req)
        self._finish(req, deadline_expired=True)

    def _sweep_deadlines(self) -> None:
        now = time.monotonic()
        for req in self.scheduler.drop_expired(now):
            self._expire(req)
        for req in list(self._slots):
            if req is not None and req.deadline_s is not None and now >= req.deadline_s:
                self._expire(req)

    # ---------------------------------------------------------- admission --
    def _try_admit(self) -> None:
        if self._prefilling is not None:
            return
        req = self.scheduler.next_waiting(self._tick)
        if req is None:
            return
        slot = self._free_slot()
        if slot is None:
            return
        plen = int(req.serve_prompt.size)
        if self._paged and not self.kv.can_allocate(plen):
            return
        req = self.scheduler.pop(self._tick)
        req.state = PREFILL
        req.slot = slot
        self._slots[slot] = req
        if not self._ensure(slot, plen):
            raise RuntimeError("allocator disagreed with can_allocate")
        buf = np.zeros(self._prefill_buf_len, np.int64)
        buf[:plen] = req.serve_prompt
        self._prefilling = req
        self._prefill_tokens = buf
        self._prefill_done = 0
        tf_model.reset_cache(self.cfg, self._prefill_cache)

    # ------------------------------------------------------------ prefill --
    def _advance_prefill(self) -> None:
        req = self._prefilling
        if req is None:
            return
        c = self.ecfg.prefill_chunk
        plen = int(req.serve_prompt.size)
        done = self._prefill_done
        if self.cfg.ssm_state and plen - done < c:
            # the recurrent state is exact only over the real tokens, so the
            # tail that does not fill a chunk runs token by token through the
            # O(1) decode path instead of being padded
            while done < plen:
                tok = self._tensor(self._prefill_tokens[done:done + 1][None])
                last_logits = self._prefill_fwd(self.params, self._prefill_cache, tok)[0]
                done += 1
        else:
            # attention-only: the padded tail of the final chunk writes cache
            # rows >= plen, which the import drops and positions never reach
            chunk = self._tensor(self._prefill_tokens[done:done + c][None])
            last_logits = self._prefill_fwd(self.params, self._prefill_cache, chunk)[0]
            done += c
        self._prefill_done = done
        self._prefill_chunks += 1
        if self._prefill_done >= plen:
            self._finish_prefill(req, plen, last_logits)

    def _finish_prefill(self, req: ServeRequest, plen: int, last_logits: torch.Tensor) -> None:
        slot = req.slot
        self.kv.pools["layers"] = self._import(
            self.kv.pools["layers"], self._prefill_cache["layers"], slot, plen, self.kv.table_row(slot),
        )
        # first token: the logits row of the prompt's last position within
        # the final prefill call (a padded chunk's row plen - 1 relative to
        # its start; the only row of an SSM tail's single-token call)
        row_idx = (plen - 1) - (self._prefill_done - last_logits.shape[1])
        row = last_logits[0, row_idx].cpu().numpy()
        if self.ecfg.verify and not np.isfinite(row).all():
            self._handle_fault(req)
            return
        tok = int(self._sample_rows(row[None], [req])[0])
        self._prefilling = None
        self._prefill_tokens = None
        req.state = RUNNING
        self._ctx[slot] = plen
        self._append_token(req, tok)

    # ------------------------------------------------------------- decode --
    def _decode_once(self) -> None:
        # grow every running slot's table for the position it writes next;
        # under exhaustion the LIFO victim is evicted until the rest fit
        for req in sorted(self._running, key=lambda r: r.admit_index):
            if req.state != RUNNING:
                continue
            while not self._ensure(req.slot, int(self._ctx[req.slot]) + 1):
                victims = self._running
                victim = self.scheduler.pick_victim(victims)
                if victim is req and len(victims) == 1:
                    raise RuntimeError(
                        f"KV pool too small for one sequence: "
                        f"{self.kv.num_blocks} blocks of {self.block_size}"
                    )
                self._evict(victim)
                if victim is req:
                    break

        reqs = [r if (r is not None and r.state == RUNNING) else None for r in self._slots]
        if not any(r is not None for r in reqs):
            return
        # a tick with a degraded request runs the whole pool through the
        # degraded step (one step a tick; healthy rows are independent)
        decode = self._get_decode_xla() if any(r is not None and r.degraded for r in reqs) else self._decode
        logits = decode(
            self.params, self.kv.pools, self._tensor(self._cur), self._tensor(self._ctx),
            self._tensor(self.kv.block_tables),
        )[0]
        self._decode_steps += 1
        rows = logits[:, -1].cpu().numpy()
        next_tokens = self._sample_rows(rows, reqs)
        for i, req in enumerate(reqs):
            if req is None:
                continue
            if self.ecfg.verify and not np.isfinite(rows[i]).all():
                # a corrupted KV block or a tripped matmul: only this row's request pays
                self._handle_fault(req)
                continue
            self._ctx[i] += 1   # the fed token is now in the cache
            self._append_token(req, int(next_tokens[i]))

    # -------------------------------------------------------------- drive --
    def step(self) -> bool:
        """One engine tick (deadline sweep -> admit -> prefill chunk ->
        decode step).  Returns True while there is work left."""
        self._tick += 1
        self._sweep_deadlines()
        self._try_admit()
        self._advance_prefill()
        self._try_admit()    # a finished prefill may free the pipeline
        self._decode_once()
        return self._busy()

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: generated tokens} and fills
        ``last_stats`` / ``request_stats``."""
        t0 = time.monotonic()
        steps0, gen0 = self._decode_steps, self._generated_total
        while self.step():
            pass
        wall = time.monotonic() - t0
        self.last_stats = {
            "decode_steps": self._decode_steps - steps0,
            "wall_s": wall,
            "tok_per_s": (self._generated_total - gen0) / max(wall, 1e-9),
            "prefill_chunks": self._prefill_chunks,
            "preemptions": self._preempt_count,
            "requests": len(self.results),
            "faults_detected": self._faults_detected,
            "retries": self._retries_total,
            "deadline_evictions": self._deadline_evictions,
            "degraded_requests": self._degraded_requests,
        }
        return dict(self.results)
