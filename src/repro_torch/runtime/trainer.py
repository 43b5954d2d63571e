"""The training loop (port of ``repro/runtime/trainer.py``).

* **Auto-resume** — on start the latest complete checkpoint (parameters,
  optimizer state, step and the data cursor) is restored and the run
  continues from it; the same data step gives the same batch, so a resumed
  run repeats the uninterrupted one.
* **Async checkpoints** — the host copy is taken at once, the files are
  written on a background thread while the next steps run.
* **Failure injection** — ``fail_at_step`` raises inside the loop, to prove
  the restart path.
* **Straggler signal** — a per-step wall-time EWMA; steps slower than
  ``straggler_factor`` times it are counted in the metrics.
* **Reliability guard** (``guard=True``; ``reliability.guard``) — every step
  screens the loss, the gradient norm and the parameters' fingerprint and
  skips a poisoned update.  On a weight fault the trainer names the corrupt
  leaves and restores the latest checkpoint in place (a recovery), or with
  ``recover_on_fault=False`` or no checkpoint raises ``ReliabilityError``.
  The run's ``skipped``, ``weight_faults`` and ``recoveries`` are summed on
  the host from the per-step flags (a restore rewinds the in-state
  counters); checkpoints carry the guard's keys.

Every family trains; a stub frontend's configuration (``frontend !=
"none"``) is fed the pipeline's precomputed embeddings, as in the
reference.  Per-step metrics: ``loss``, ``grad_norm``, ``step``, ``step_time_s`` (host
clock around the step, which ends by reading the loss back, so the card's
work is inside it) and ``stragglers``.  The run happens on ``device``
(default ``"cuda"``; pass ``"cpu"`` for the plain versions of the kernels).

**Under a sharding plan** (``Trainer(cfg, tcfg, mesh=, plan=)``, or
``policy=``, the reference's deprecated alias of ``plan``; a mesh alone
takes ``distributed.make_plan(mesh, cfg, "train")``; ``cfg.matmul_backend``
the plan's sharded backend) each rank of an initialized world runs one
``Trainer`` on its own device: ``init_state`` draws the rank's slice of the
seeded parameters (``init_params(plan=)``; given ``params``, whole ones
are cut by ``plan.shard_params``), every rank reads the same global batch
and cursor from the pipeline and the step takes its rows (the batch's rows
over ``data`` under ``fsdp``, ``layers.SeqRows`` under ``sp``, every row
under ``tp`` and ``ep``: ``transformer.forward``), and
``train_step_fn(plan=)`` does the rest.  Checkpoints are mesh-independent
(``checkpoint.manager``): whole leaves, gathered on every rank and written
by rank 0; a restore cuts each rank's slice, so a run resumes on the same
mesh, under another strategy or on one rank.  After a restore the guard's
fingerprint is recomputed on the rank's own slices.  A plan with a stage
axis (``pp``, ``plan.stages > 1``) takes the pipelined step
(``distributed.pipeline_train_step_fn``, ``pipeline_microbatches`` a step,
0 for ``2 * stages``, as in the reference): each rank holds its stage's
layers and the embedding and head whole, feeds the whole global batch, and
runs the config's own backend (not a sharded one).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import api, reliability
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataState, SyntheticLM
from repro_torch.device import make_generator, resolve_device
from repro_torch.models import transformer as tf_model
from repro_torch.optim import AdamW

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 2
    log_every: int = 10
    async_ckpt: bool = True
    fail_at_step: Optional[int] = None     # failure injection (tests)
    straggler_factor: float = 3.0
    metrics_path: Optional[str] = None     # JSONL
    # the reliability guard: screen every step, skip poisoned updates
    guard: bool = False
    # on a weight fault: restore the latest checkpoint (True) or raise
    recover_on_fault: bool = True
    pipeline_microbatches: int = 0         # GPipe microbatches a step under pp (0 = 2 x stages)


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, *, optimizer: Optional[AdamW] = None,
                 data: Optional[SyntheticLM] = None, mesh=None, plan=None, policy=None,
                 seq_len: int = 512, global_batch: int = 8,
                 step_hook: Optional[Callable[[int, Dict[str, Any]], Dict[str, Any]]] = None,
                 device="cuda"):
        plan = plan if plan is not None else policy
        if plan is None and mesh is not None:
            from repro_torch.distributed import make_plan

            plan = make_plan(mesh, cfg, "train")
        if plan is not None and mesh is not None and plan.mesh != mesh:
            raise ValueError(f"the plan was made for {plan.mesh}, the trainer was given {mesh}")
        be = api.get_backend(cfg.matmul_backend)  # fail fast on unknown backends
        staged = plan is not None and plan.stages > 1
        if (be.layout == "sharded") != (plan is not None and not staged):
            raise ValueError(f"cfg.matmul_backend={cfg.matmul_backend!r} and plan={plan!r}: a sharded backend "
                             "dispatches on the WeightPlan metadata, so it trains under a plan "
                             "(distributed.make_plan), and a plan trains through its sharded backend (the "
                             "pipeline's stages through the config's own)")
        if cfg.quantization != "none":
            # quantized storage is a frozen inference artifact: its payload
            # has no usable cotangent, so training would freeze every projection
            raise ValueError(f"cfg.quantization={cfg.quantization!r} is inference-only; "
                             "train in float and quantize the checkpoint for serving")
        self.cfg = cfg
        self.tcfg = tcfg
        self.plan = plan
        self.mesh = None if plan is None else plan.mesh
        self.policy = plan  # the reference's deprecated alias
        self.device = resolve_device(device)
        self.opt = optimizer or AdamW(lr=3e-4)
        self.data = data or SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
                                        emit_embeddings=cfg.d_model if cfg.frontend != "none" else None)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        if staged:  # the layer stack through the overlapped GPipe schedule
            from repro_torch.distributed import pipeline_train_step_fn

            self._step_fn = pipeline_train_step_fn(cfg, self.opt, plan,
                                                   n_micro=tcfg.pipeline_microbatches or 2 * plan.stages,
                                                   guard=tcfg.guard)
        else:
            self._step_fn = tf_model.train_step_fn(cfg, self.opt, guard=tcfg.guard, plan=plan)
        self.metrics_log: list = []
        # called as state = step_hook(step_no, state) before each step: how
        # the chaos tests corrupt a parameter between steps
        self._step_hook = step_hook
        self.recoveries = 0

    def init_state(self, seed: int = 0, params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Fresh parameters drawn from ``seed`` on the trainer's device (or
        the given ``params``, e.g. weights converted from the reference),
        zero moments, step 0; under a plan this rank's slice of them."""
        if params is None:
            params = tf_model.init_params(self.cfg, make_generator(seed, self.device), self.device, plan=self.plan)
        elif self.plan is not None:
            params = self.plan.shard_params(params)
        state = {"params": params, "opt_state": self.opt.init(params), "step": 0}
        return reliability.init_guard_state(state) if self.tcfg.guard else state

    def run(self, seed: int = 0, params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Train to ``tcfg.steps``; returns ``{"state", "wall_s", "metrics"}``
        and, under the guard, the run's ``skipped``, ``weight_faults`` and
        ``recoveries``."""
        state = self.init_state(seed, params)
        data_state = DataState(step=0)
        restored, meta = self._restore(state)
        if restored is not None:
            state = restored
            data_state = DataState.from_dict(meta["data"])
            print(f"[trainer] resumed from step {meta['step']}")

        self.data.start(data_state)
        it = iter(self.data)
        ewma = None
        stragglers = 0
        t_loop = time.monotonic()
        try:
            while state["step"] < self.tcfg.steps:
                step_no, host_batch = next(it)
                batch = {k: torch.as_tensor(v).to(self.device) for k, v in host_batch.items()}
                if self.tcfg.fail_at_step is not None and step_no == self.tcfg.fail_at_step:
                    raise RuntimeError(f"injected failure at step {step_no}")
                if self._step_hook is not None:
                    state = self._step_hook(step_no, state)
                t0 = time.monotonic()
                state, metrics = self._step_fn(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}  # reads back: the step is done
                if self.tcfg.guard and metrics["weight_fault"]:
                    state = self._recover(state)
                dt = time.monotonic() - t0
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if dt > self.tcfg.straggler_factor * ewma and step_no > 3:
                    stragglers += 1
                metrics.update(step_time_s=dt, stragglers=stragglers)
                self.metrics_log.append(metrics)
                if self.tcfg.metrics_path:
                    with open(self.tcfg.metrics_path, "a") as f:
                        f.write(json.dumps(metrics) + "\n")
                step = int(metrics["step"])
                if step % self.tcfg.log_every == 0:
                    print(f"[trainer] step {step} loss {metrics['loss']:.4f} ({dt * 1e3:.0f} ms)")
                if step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(step, state, meta={"data": DataState(step=step_no + 1).to_dict()},
                                   blocking=not self.tcfg.async_ckpt, plan=self.plan)
        finally:
            self.data.stop()
            self.ckpt.wait()
            self._barrier()  # rank 0's files are complete before any rank goes on
        out = {"state": state, "wall_s": time.monotonic() - t_loop, "metrics": self.metrics_log}
        if self.tcfg.guard:
            out.update(skipped=sum(int(m["skipped"]) for m in self.metrics_log),
                       weight_faults=sum(int(m["weight_fault"]) for m in self.metrics_log),
                       recoveries=self.recoveries)
        return out

    def _recover(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A weight fault: name the corrupt leaves, then restore the latest
        checkpoint into ``state`` in place (or raise when there is none or
        recovery is off).  The data stream keeps advancing, as the
        reference's does."""
        bad = reliability.locate_fingerprint_fault(state["params"], state["fingerprint"])
        leaves = ", ".join(bad) if bad else "<fingerprint mismatch>"
        restored = None
        if self.tcfg.recover_on_fault:
            self.ckpt.wait()
            self._barrier()
            restored, meta = self._restore(state)
        if restored is None:
            raise reliability.ReliabilityError(
                f"weight corruption detected in [{leaves}] and no recovery path "
                "(recover_on_fault=False or no checkpoint yet)")
        self.recoveries += 1
        print(f"[trainer] weight fault in [{leaves}]; restored checkpoint step {meta['step']}")
        return restored

    def _restore(self, state: Dict[str, Any]):
        """The latest checkpoint into ``state`` in place (each rank's slice
        under a plan), with the guard's fingerprint recomputed on the rank's
        own parameters under a plan (the file holds rank 0's)."""
        restored, meta = self.ckpt.restore(state, plan=self.plan)
        if restored is not None and self.plan is not None and self.tcfg.guard:
            restored["fingerprint"] = reliability.guard.fingerprint(restored["params"])
        return restored, meta

    def _barrier(self) -> None:
        if self.plan is not None:
            torch.distributed.barrier(group=self.plan.mesh.group(tf_model._rank_axis(self.plan)))
