"""Pipeline parallelism: GPipe microbatching over a ``stage`` mesh axis,
the boundary transfer overlapped with the stage compute (port of
``repro/distributed/pipeline.py``).

``ShardingPlan(strategy="pp")`` carries the stage axis (``plan.stages``
ranks) and :func:`pipeline_train_step_fn` is the drop-in counterpart of
``transformer.train_step_fn`` that runs the layer stack through
:func:`pipeline_apply`; ``runtime.Trainer`` (and ``train_step_fn(plan=)``)
select it whenever ``plan.stages > 1``.

**Schedule, tick for tick the reference's.**  Every tick first starts the
ring hop (``comm.ppermute_start``) of the previous tick's output, then runs
the stage compute, which does not depend on it, and waits for the hop
after: the transfer is in flight while the stage computes.  Stage ``s``
computes microbatch ``m`` at tick ``m + 2 s``, so S stages and M
microbatches take ``M + 2 (S - 1)`` ticks.  Stage 0 takes microbatch
``t`` of its input; every other stage what arrived in the previous tick.
At the end one masked ``psum`` broadcasts the last stage's outputs to
every rank.

**Every rank runs every tick alike.**  A bubble tick computes on zeros
and is masked (``torch.where`` on 0-d flags, never a Python branch on the
rank), and the outputs are collected per tick from the last stage's timing
(tick ``m + 2 (S - 1)`` yields microbatch ``m``) into a list, masked to the
last stage: so every rank builds the same autograd graph.  Its backward
then issues the reverse hops (``comm.hop_grad``) in one order on every
rank, where a graph that differed between ranks could pair the wrong
blocks or hang.

**Gradients** follow ``distributed.comm``'s convention: each rank
differentiates its share of the replicated loss; the broadcast ``psum``'s
backward sums the shares, the mask hands the whole cotangent to the last
stage, and each reverse hop passes a stage's input cotangent upstream, so
each stage's layer gradients come out once.  The embedding's gradient
reaches stage 0 alone (through its inject), the final norm's and the
head's reach every rank as shares: ``train_step_fn``'s one psum of the
whole leaves' shares makes them whole.

Numerics: every stage applies ``stage_fn`` once per microbatch to exactly
the activation its upstream stage produced, so the output is bit-identical
to sequential application of the stages.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.device import dtype_of
from repro_torch.distributed import comm
from repro_torch.distributed.comm import Mesh

__all__ = ["pipeline_apply", "pipeline_train_step_fn"]


def pipeline_apply(mesh: Mesh, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   x: torch.Tensor, *, axis: str = "stage") -> torch.Tensor:
    """Run ``x`` (``(microbatches, mb, ...)``, the same on every rank)
    through the ``mesh.shape[axis]`` stages, pipelined; returns the last
    stage's outputs, microbatch-major, on every rank, bit-identical to
    sequential application.  Local view: ``stage_params`` are THIS rank's
    stage's (the reference passes every stage's, stacked along a leading
    axis the shard_map splits).  ``stage_fn(params, activation)`` must
    preserve the activation's shape.  Per tick one ``ppermute``, issued
    before the stage compute; at the end one ``psum``."""
    n_stages, n_micro = mesh.shape[axis], x.shape[0]
    s = mesh.coord(axis)
    n_ticks = n_micro + 2 * (n_stages - 1)
    dev = x.device
    is_first = torch.tensor(s == 0, device=dev)
    is_last = torch.tensor(s == n_stages - 1, device=dev)
    # 2 ticks a hop: compute, then in flight
    active = torch.tensor([0 <= t - 2 * s < n_micro for t in range(n_ticks)], device=dev)
    zero = torch.zeros_like(x[0])
    recv = send = zero
    outs = []
    for t in range(n_ticks):
        hop = comm.ppermute_start(send, mesh, axis)  # the previous tick's output, sent first
        cur = torch.where(is_first, x[min(t, n_micro - 1)], recv)
        cur = torch.where(active[t], cur, zero)  # a bubble computes on zeros, not on ring garbage
        y = torch.where(active[t], stage_fn(stage_params, cur), cur)
        if t >= 2 * (n_stages - 1):  # the last stage finishes microbatch t - 2 (S - 1)
            outs.append(torch.where(is_last, y, zero))
        recv = comm.hop_grad(send, hop.wait(), mesh, axis)
        send = y
    return comm.psum(torch.stack(outs), mesh, axis)  # masked psum = the last stage's, broadcast


def pipeline_train_step_fn(cfg, optimizer, plan, *, n_micro: int, guard: bool = False):
    """The pipelined ``step(state, batch) -> (state, metrics)``: the
    ``transformer.train_step_fn`` contract (under a plan: this rank's
    parameters and moments in the state, every rank passing the same whole
    batch) with the layer stack run through :func:`pipeline_apply` over
    ``plan``'s stage axis, ``n_micro`` microbatches a step.

    The embedding lookup, the final norm and the lm_head with the unfused
    cross entropy run on every rank outside the stage loop, as the
    reference's do; each stage runs its ``n_layers / stages`` layers
    (``plan.stage_layers()``) through ``transformer._transformer_block``
    with no plan and no remat.  The dense family only: SSM state and MoE
    dispatch do not thread the stage ring (the reference's ``ValueError``).
    The rest is ``train_step_fn``'s under a plan: ``loss / stages``
    differentiated, ONE psum of the whole leaves' shares, the global norm,
    the optimizer's transform with its scales over the stages, and under
    ``guard=True`` the ranks' verdicts in one psum of their flags."""
    from repro_torch.models import layers, transformer as tf_model  # lazy: the model imports this package

    if getattr(plan, "stages", 1) < 2 or plan.mesh is None or plan.stage is None:
        raise ValueError("pipeline_train_step_fn needs a plan with a stage axis of >= 2 devices "
                         "(ShardingPlan(strategy='pp', ...))")
    tf_model._require_train_plan(cfg, plan)
    n_stages, axis, mesh = plan.stages, plan.stage, plan.mesh
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} does not divide into {n_stages} stages")
    tf_model._require_trainable(cfg)
    per_stage = cfg.n_layers // n_stages

    def stage_fn(stage, a):
        layer_params, rope, positions = stage
        for lp in layer_params:
            a, _, _ = tf_model._transformer_block(a, lp, cfg, positions=positions, rope=rope, cache=None, plan=None)
        return a

    def loss(params, batch, moe_trace=None):
        tokens = batch["tokens"]
        b, s = tokens.shape
        if b % n_micro:
            raise ValueError(f"batch={b} does not divide into {n_micro} pipeline microbatches")
        x = tf_model._embed(params["embed"], tokens, None).to(dtype_of(cfg.compute_dtype))
        positions = torch.arange(s, device=x.device)
        rope = layers.rope_tables(positions, tf_model._rope_dim(cfg), cfg.rope_theta)
        stage = (tf_model._layers(params["layers"], per_stage), rope, positions)
        h = pipeline_apply(mesh, stage_fn, stage, x.reshape((n_micro, b // n_micro) + x.shape[1:]), axis=axis)
        h = layers.rms_norm(h.reshape((b,) + h.shape[2:]), params["final_norm"], cfg.norm_eps)
        logits = tf_model._head(params, cfg, h)
        mask = batch.get("loss_mask")
        return layers.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                         mask=None if mask is None else mask[:, 1:])

    return tf_model._step_fn(cfg, optimizer, loss, plan=plan, guard=guard)
