"""The decoder: parameters, forward, caches, the serving steps and the
training objective (port of ``repro/models/transformer.py``).

Parameters are a nested dict with layer-stacked leaves (leading axis =
n_layers), as in the reference; a Python loop over the layers takes the
place of ``jax.lax.scan``, and ``cfg.remat == "block"`` wraps each block in
``torch.utils.checkpoint`` as the reference wraps it in ``jax.checkpoint``.
Linear weights are ``api.DipWeight`` storage when the configured backend
consumes the DiP layout, and ``api.QuantizedDipWeight`` storage (the lm_head
included) under ``cfg.quantization``; ``cfg.kv_quant`` selects the int8
paged KV pool.  A block's attention is GQA or, under ``cfg.use_mla``,
multi-head latent attention with its latent caches; its FFN is the dense
SwiGLU MLP or, for the ``moe`` family, the routed experts plus the shared
ones (``models/moe.py``).  The ``ssm`` family stacks Mamba2 blocks
(``models/ssm.py``), and the ``hybrid`` family follows every
``attn_every``-th of them with one shared attention+FFN block whose
parameters all call sites share, each site with its own KV cache; their
caches hold a per-sequence conv history and f32 state beside the shared
block's K/V.  Under ``cfg.tie_embeddings`` the head is the embedding: f32
sums of the compute-dtype products, outside the DiP kernel as in the
reference.  The ``vlm`` and ``audio`` families are dense decoders whose stub
frontends hand ``forward`` precomputed ``embeddings``; served, they read
tokens, as the reference's ``Server`` does.  ``loss_fn`` (cross entropy plus
the MoE router's aux loss) takes the fused lm_head + cross-entropy kernel
(``kernels/lm_head_ce.py``) unless told otherwise, and ``train_step_fn``
applies one AdamW step in place (``guard=True``: behind the reliability
guard's screens); every family trains.  Every served family
serves quantized too: ``quantize_params`` quantizes only the DiP-stored
projections, so the MoE router and expert banks, the SSM scalars, conv and
norms, and the embeddings stay float, as in the reference.

Under a ``ShardingPlan`` (``plan=``, strategy ``tp`` or ``ep``, the dense
and moe families, and ``tp`` the ssm and hybrid families too; the port of
the reference's explicit ``dip_tp`` / ``dip_ep`` model paths; ``sp`` and
``fsdp`` below) each rank
runs ``forward`` / ``decode_step_fn`` /
``paged_decode_step_fn`` on its slice of the parameters
(``plan.shard_params``): the projections dispatch on their ``WeightPlan``
(q/k/v and gate/up column-parallel, attention on the rank's heads, ``wo``
and ``w_down`` row-parallel with one all-reduce each), the embedding is
vocab-parallel (a masked local lookup and one all-reduce), and the lm_head
is column-parallel over the padded vocab with its logits all-gathered, so
every rank returns the whole logits: 2 x n_layers + 2 collectives a dense
step.  Its caches hold the rank's KV heads, or the whole MLA latent.  A MoE
layer runs on the rank's experts (``models/moe.py``): expert-parallel under
``ep`` (2 all-to-alls, 1 all-reduce and 1 all-gather a layer), expert-split
with one all-reduce under ``tp``; MLA all-gathers its latent where
``w_dkv`` is column-parallel.  DeepSeek-V2-Lite under ``ep`` on 2 ranks
runs 27 x 6 + 2 = 164 collectives a step.  A Mamba2 block under ``tp``
runs the rank's SSM heads (``models/ssm.py``: ``in_proj``'s output
all-gathered where it is column-parallel, the gated norm's psum,
``out_proj``'s all-reduce), its caches the rank's heads of the state and
their conv channels; the hybrid's shared block runs the dense block's
``tp`` path at each site; a tied head multiplies the rank's vocab rows of
the embedding and all-gathers the logits.  Zamba2-2.7B on 2 ranks: 1 + 54
x 3 + 9 x 2 + 1 = 182 collectives a step.

Under ``fsdp`` (ZeRO-3, the dense, moe, ssm and hybrid families on a
(data = T, model = 1) mesh) every rank holds K / T rows of each projection's
storage and the embedding's d / T columns; the embedding's rows are
looked up on every token and all-gathered over d; each projection
dispatches ``dip_fsdp`` (one all-gather of its storage a weight, one
launch).  The rows split over ``data`` where the batch divides it (the
reference's ``dp_for``: a decode step's slots), each rank running its own
and all-gathering the logits' rows; otherwise (the engine's batch-1
prefill) every rank runs the same rows.  The caches and pools stay whole
on every rank, which writes only the rows it runs; a tied head
all-gathers the embedding.  The moe family runs its layer on the rank's
rows with the router and each expert bank all-gathered (``models/moe.py``)
and MLA gathers ``w_uk`` / ``w_uv`` before de-shearing them.

Under ``sp`` (sequence parallel, the dense, ssm and hybrid families; the
weights, caches and pools are ``tp``'s) the residual stream is the rank's
block of the flattened B S rows, padded to T m rows
(``layers.SeqRows``): the embedding's vocab-parallel lookup ends in one
reduce-scatter to the rank's rows; the norms and the residual adds run on
those rows; each column projection dispatches ``dip_sp`` (T launches, T -
1 ring hops) and gives every row of the rank's heads or columns, cropped
to the real rows before RoPE, the cache write, attention, the conv and the
scan, which run as under ``tp``; ``wo``, ``w_down`` and ``out_proj``
dispatch ``dip_sp``'s row path (one reduce-scatter each) back to the
rank's rows; a separate lm_head is ``dip_sp`` column and its logits
all-gathered over the vocab, a tied one multiplies every row (one
all-gather of rows) by the rank's vocab rows.  The pad rows are cropped
before the logits leave: every rank returns the whole (B, S) logits.
llama3-8b on 2 ranks: 32 x (4 + 2) + 1 + 2 = 195 collectives and 32 x 10
+ 2 = 322 launches a step; Zamba2-2.7B: 54 x 4 + 9 x 6 + 3 = 273 and 54 x
3 + 9 x 10 + 2 = 254.  The moe family under ``sp`` raises (ROADMAP.md
Queue 1 "Distributed").

Every model path that serves under a plan also trains under it
(``loss_fn(plan=)``, ``train_step_fn(plan=)``): the collectives are
differentiable (``distributed.comm``: each one's backward is its
transpose), every rank computes the global loss from the whole logits and
differentiates its share of it, and the gradient shares of the leaves the
ranks hold alike are summed once after the backward.  Training refuses a
(data, model) mesh with both axes above 1.  Under ``pp`` (the dense family,
over a stage axis) the step is ``distributed.pipeline``'s: the layer stack
runs through the overlapped GPipe schedule, each rank its stage's layers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import api, tree
from repro_torch.core import permute
from repro_torch.device import dtype_of, resolve_device
from repro_torch.distributed import comm
from repro_torch.kernels import lm_head_ce
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.optim.adamw import global_norm
from repro_torch.reliability import guard as guard_lib

__all__ = [
    "param_template",
    "quantize_params",
    "init_params",
    "forward",
    "init_cache",
    "reset_cache",
    "init_paged_cache",
    "decode_step_fn",
    "paged_decode_step_fn",
    "loss_fn",
    "train_step_fn",
]

_DISTRIBUTED = 'ROADMAP.md Queue 1 "Distributed"'
_KNOWN_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
_PLANNED = ("tp", "sp", "ep", "fsdp")  # the strategies whose model path runs


def _require_served(cfg) -> None:
    """Raise for every configuration the port does not serve: it serves
    every family of the reference (the stub frontends from tokens), with
    GQA or MLA attention and tied or separate heads, in float or with
    quantized weights and an int8 KV pool; under a plan the families
    :func:`_plannable` names (``pp``: :func:`_require_staged`'s)."""
    if cfg.family not in _KNOWN_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} (one of {_KNOWN_FAMILIES})")
    if cfg.sharding == "pp":
        _require_staged(cfg)
        return
    if cfg.sharding not in ("gspmd",) + _PLANNED or (cfg.sharding in _PLANNED and not _plannable(cfg, cfg.sharding)):
        raise NotImplementedError(f"{cfg.name}: not ported yet: sharding {cfg.sharding!r} for the "
                                  f"{cfg.family} family ({_DISTRIBUTED})")


def _plannable(cfg, strategy: str) -> bool:
    """The families a strategy's model path runs, tied or separate heads:
    under ``tp`` and ``fsdp`` dense with GQA, moe (GQA or MLA, with or
    without shared experts), ssm and hybrid; under ``sp`` dense with GQA,
    ssm and hybrid; under ``ep`` dense with GQA and moe; under ``pp`` (the
    pipeline's stages, a training path) dense with GQA."""
    dense = cfg.family == "dense" and not cfg.use_mla
    moe_fam = cfg.family == "moe"
    ssm_fams = cfg.family in ("ssm", "hybrid")
    if strategy == "pp":
        return dense
    if strategy == "sp":
        return dense or ssm_fams
    if strategy == "ep":
        return dense or moe_fam
    return dense or moe_fam or ssm_fams


def _require_plan(cfg, plan) -> None:
    """The model path a plan runs in this slice (module doc).  ``fsdp``: a
    (data, model = 1) mesh whose data axis divides d_model (the
    embedding's columns).  ``tp`` / ``sp`` / ``ep``: heads split over the
    TP axis, ``wo`` (and a dense FFN's ``w_down``) row-parallel and the
    column projections column-parallel as the plan decides them (K/V, and
    MLA's q, latent and up-projections, may replicate where their width is
    too small to split: each rank then takes its heads of the whole
    projection).  A column-parallel head projection must split at a head
    boundary (no padding columns); ``in_proj``, whose output is gathered
    whole, may split anywhere or replicate.  A Mamba2 block needs its SSM
    heads to divide the axis and ``out_proj`` row-parallel at a head
    boundary."""
    if plan is None:
        return
    if plan.strategy not in _PLANNED or not _plannable(cfg, plan.strategy):
        raise NotImplementedError(f"{cfg.name}: the {plan.strategy!r} model path of the {cfg.family} family "
                                  f"is not ported yet ({_DISTRIBUTED})")
    if plan.strategy == "fsdp":
        if plan.tp_size != 1 or cfg.d_model % plan.fsdp_size:
            raise NotImplementedError(f"{cfg.name}: fsdp over {dict(plan.mesh.shape)} (a model axis, or a data "
                                      f"axis that does not divide d_model={cfg.d_model}) is not ported yet "
                                      f"({_DISTRIBUTED})")
        return
    if cfg.ssm_state:
        _require_ssm_plan(cfg, plan)
        if not cfg.is_hybrid:
            return
    # a prefill or train plan's heads_on_tp reads only the query heads; the
    # model path runs the rank's share of the KV heads too
    if not plan.heads_on_tp or (not cfg.use_mla and cfg.n_kv_heads % plan.tp_size):
        raise NotImplementedError(f"{cfg.name}: heads that do not divide the TP axis (sequence-parallel "
                                  f"attention) are not ported yet ({_DISTRIBUTED})")
    hd, d, h = cfg.resolved_head_dim, cfg.d_model, cfg.n_heads
    if cfg.use_mla:
        dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        need = [("wo", h * dv, d, "row")]
        split = [("wq", d, h * (dn + dr)), ("w_uk", r, h * dn), ("w_uv", r, h * dv), ("w_dkv", d, r),
                 ("w_krope", d, dr)]
    else:
        need = [("wq", d, h * hd, "column"), ("wo", h * hd, d, "row")]
        split = []
    if not cfg.is_moe:
        need += [("w_gate", d, cfg.d_ff, "column"), ("w_up", d, cfg.d_ff, "column"), ("w_down", cfg.d_ff, d, "row")]
    for name, di, do, kind in need:
        got = plan.weight_plan(name, api.DipWeight.storage_dims(di, do), api.PERM_TILE).kind
        if got != kind:
            raise NotImplementedError(f"{cfg.name}: {name} does not split {kind}-parallel over "
                                      f"{plan.tp}={plan.tp_size} ({_DISTRIBUTED})")
    for name, di, do in split:
        storage = api.DipWeight.storage_dims(di, do)
        if plan.weight_plan(name, storage, api.PERM_TILE).kind == "column" and storage[1] != do:
            raise NotImplementedError(f"{cfg.name}: {name}'s {do} columns are padded to {storage[1]}, so its "
                                      f"column shards do not split at a head boundary ({_DISTRIBUTED})")


def _require_ssm_plan(cfg, plan) -> None:
    """A Mamba2 block under ``tp`` runs H / T SSM heads (``ssm.ssd_block``):
    T must divide H, and ``out_proj``'s row shards must be the heads'
    ``d_inner / T`` channels (row-parallel storage with no padding rows)."""
    di, d, tp = cfg.d_inner, cfg.d_model, plan.tp_size
    storage = api.DipWeight.storage_dims(di, d)
    if cfg.n_ssm_heads % tp or plan.weight_plan("out_proj", storage, api.PERM_TILE).kind != "row" \
            or storage[0] != di:
        raise NotImplementedError(f"{cfg.name}: {cfg.n_ssm_heads} SSM heads with out_proj ({di}, {d}) do not "
                                  f"split row-parallel at a head boundary over {plan.tp}={tp} ({_DISTRIBUTED})")


def _require_trainable(cfg) -> None:
    """Every served family trains; quantized weights are an inference
    artifact (their codes take no gradient), as the reference's
    ``Trainer`` holds them."""
    _require_served(cfg)
    if cfg.quantization != "none":
        raise ValueError(f"cfg.quantization={cfg.quantization!r} is inference-only; "
                         "train in float and quantize the checkpoint for serving")


def _require_train_plan(cfg, plan) -> None:
    """What training under a plan adds to :func:`_require_plan`: one axis
    of the mesh above 1 (a (data, model) mesh with both above 1 would need
    the whole leaves' gradients summed over each axis apart).  ``pp`` (its
    mesh a stage axis alone, ``ShardingPlan``) trains the families
    :func:`_require_staged` names."""
    if plan is None:
        return
    if plan.strategy == "pp":
        _require_staged(cfg)
        return
    _require_plan(cfg, plan)
    if plan.tp_size > 1 and plan.fsdp_size > 1:
        raise NotImplementedError(f"{cfg.name}: training over a (data, model) mesh {dict(plan.mesh.shape)} with both "
                                  f"axes above 1 is not ported yet ({_DISTRIBUTED})")


def _require_staged(cfg) -> None:
    """The families pipeline stages train (``pp``): dense with GQA.  SSM
    state and MoE dispatch raise the reference's ``ValueError``; the vlm
    and audio families and dense MLA, which the reference would run, are
    not ported."""
    if cfg.ssm_state or cfg.is_moe:
        raise ValueError(f"{cfg.name}: pipeline stages cover the dense attention+FFN scan families (SSM state / "
                         "MoE dispatch do not thread the stage ring)")
    if not _plannable(cfg, "pp"):
        raise NotImplementedError(f"{cfg.name}: pipeline stages for the {cfg.family} family"
                                  f"{' with MLA' if cfg.use_mla else ''} are not ported yet ({_DISTRIBUTED})")


def _rank_axis(plan) -> str:
    """The mesh axis a plan's ranks differ along in training: ``data``
    under ``fsdp``, ``stage`` under ``pp``, ``model`` otherwise."""
    return {"fsdp": plan.fsdp, "pp": plan.stage}.get(plan.strategy, plan.tp)


def _whole_shapes(cfg) -> List[tuple]:
    """``(name, whole storage shape)`` of every parameter leaf, in
    ``tree.leaves`` order."""
    def walk(t):
        return [x for k in sorted(t) for x in (walk(t[k]) if isinstance(t[k], dict) else [(k, tuple(t[k][0]))])]

    return walk(param_template(cfg))


def replicated_parts(params, cfg) -> List[Optional[slice]]:
    """For every parameter leaf (``tree.leaves`` order), the part of it
    that this rank holds as every other rank does, as a slice of its last
    dim: ``slice(None)`` for a leaf held whole, None for a slice of the leaf
    (its shape is not the whole leaf's), and for the Mamba2 conv leaves
    under a head split (``ShardingPlan`` module doc: the rank's heads' x
    channels, then the whole B and C) the B and C channels."""
    got = [tuple(t.shape) for t in tree.leaves(params)]
    whole = _whole_shapes(cfg)
    if len(got) != len(whole):
        raise ValueError(f"{cfg.name}: {len(got)} parameter leaves, the template has {len(whole)}")
    out: List[Optional[slice]] = []
    for g, (name, w) in zip(got, whole):
        if g == w:
            out.append(slice(None))
        elif name in ("conv_w", "conv_b") and cfg.ssm_state:
            out.append(slice(g[-1] - (w[-1] - cfg.d_inner), None))
        else:
            out.append(None)
    return out


# ------------------------------------------------------------ param layout --
def _lin(cfg, d_in, d_out):
    """(storage_shape, fan_in, dip_meta) for a linear under the config's
    weight storage; ``dip_meta`` is ``(d_in, d_out, perm_tile)`` for DiP."""
    if cfg.uses_dip_storage:
        return api.DipWeight.storage_dims(d_in, d_out), d_in, (d_in, d_out, api.PERM_TILE)
    return (d_in, d_out), d_in, None


def param_template(cfg) -> Dict[str, Any]:
    """Nested dict: leaf = (shape, dtype_str, fan_in, dip_meta); layer
    stacked; ``shape`` is the storage shape (padded for DiP).  The MoE
    router and expert banks are plain tensors, as in the reference; the MLA
    projections and the shared experts are linears like the others."""
    _require_served(cfg)
    d, v, L, pdt = cfg.d_model, cfg.padded_vocab, cfg.n_layers, cfg.param_dtype
    t: Dict[str, Any] = {
        "embed": ((v, d), pdt, d, None),
        "final_norm": ((d,), pdt, None, None),
    }
    if not cfg.tie_embeddings:
        shape, fan, dip = _lin(cfg, d, v)
        t["lm_head"] = (shape, pdt, fan, dip)
    if cfg.ssm_state:
        return _mamba_template(cfg, t)
    hd = cfg.resolved_head_dim
    blk: Dict[str, Any] = {
        "attn_norm": ((L, d), pdt, None, None),
        "ffn_norm": ((L, d), pdt, None, None),
    }
    if cfg.use_mla:
        dn, dr, dvh, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        lins = dict(wq=(d, cfg.n_heads * (dn + dr)), w_dkv=(d, r), w_krope=(d, dr),
                    w_uk=(r, cfg.n_heads * dn), w_uv=(r, cfg.n_heads * dvh), wo=(cfg.n_heads * dvh, d))
    else:
        lins = dict(wq=(d, cfg.n_heads * hd), wk=(d, cfg.n_kv_heads * hd), wv=(d, cfg.n_kv_heads * hd),
                    wo=(cfg.n_heads * hd, d))
    if cfg.is_moe:
        e, ffe = cfg.n_experts, cfg.d_ff_expert
        blk["router"] = ((L, d, e), pdt, d, None)
        blk["w_gate"] = ((L, e, d, ffe), pdt, d, None)
        blk["w_up"] = ((L, e, d, ffe), pdt, d, None)
        blk["w_down"] = ((L, e, ffe, d), pdt, ffe, None)
        if cfg.n_shared_experts:
            sff = cfg.n_shared_experts * ffe
            lins.update(shared_w_gate=(d, sff), shared_w_up=(d, sff), shared_w_down=(sff, d))
    else:
        lins.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff), w_down=(cfg.d_ff, d))
    for nm, (di, do) in lins.items():
        shape, fan, dip = _lin(cfg, di, do)
        blk[nm] = ((L,) + tuple(shape), pdt, fan, dip)
    if cfg.qkv_bias and not cfg.use_mla:
        for nm, width in (("bq", cfg.n_heads * hd), ("bk", cfg.n_kv_heads * hd),
                          ("bv", cfg.n_kv_heads * hd)):
            blk[nm] = ((L, width), pdt, None, None)
    t["layers"] = blk
    return t


def _mamba_template(cfg, t: Dict[str, Any]) -> Dict[str, Any]:
    """The mamba2 stack (ssm and hybrid families) and, for the hybrid, the
    one ``shared_attn`` subtree (attention + SwiGLU FFN, unstacked)."""
    d, L, pdt = cfg.d_model, cfg.n_layers, cfg.param_dtype
    dims = ssm.ssm_dims(cfg)

    def stacked(shape, fan=None, dip=None):
        return ((L,) + tuple(shape), pdt, fan, dip)

    blk = dict(norm_in=stacked((d,)), in_proj=stacked(*_lin(cfg, d, dims["in_dim"])),
               conv_w=stacked((cfg.ssm_conv, dims["conv_dim"]), cfg.ssm_conv), conv_b=stacked((dims["conv_dim"],)),
               dt_bias=stacked((dims["heads"],)), A_log=stacked((dims["heads"],)), D=stacked((dims["heads"],)),
               norm=stacked((dims["d_inner"],)), out_proj=stacked(*_lin(cfg, dims["d_inner"], d)))
    t["layers"] = blk
    if cfg.is_hybrid:
        hd = cfg.resolved_head_dim
        sh: Dict[str, Any] = {"attn_norm": ((d,), pdt, None, None), "ffn_norm": ((d,), pdt, None, None)}
        for nm, (di, do) in dict(wq=(d, cfg.n_heads * hd), wk=(d, cfg.n_kv_heads * hd),
                                 wv=(d, cfg.n_kv_heads * hd), wo=(cfg.n_heads * hd, d),
                                 w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff), w_down=(cfg.d_ff, d)).items():
            shape, fan, dip = _lin(cfg, di, do)
            sh[nm] = (shape, pdt, fan, dip)
        t["shared_attn"] = sh
    return t


def quantize_params(params: Dict[str, Any], scheme: str) -> Dict[str, Any]:
    """Quantize every DiP-stored projection to ``scheme`` storage (the
    offline calibration step: once at init or load, never per forward).
    Embeddings and norms stay float; quantized nodes pass through."""
    def q(t):
        if isinstance(t, dict):
            return {k: q(v) for k, v in t.items()}
        return api.quant.quantize(t, scheme) if isinstance(t, (api.DipWeight, api.QuantizedDipWeight)) else t

    return q(params)


def init_params(cfg, generator: torch.Generator, device="cuda", plan=None) -> Dict[str, Any]:
    """Materialize parameters on ``device`` from ``generator``: truncated
    normal (-2, 2) scaled by fan_in^-1/2, norms (and the SSM's D) at 1,
    biases at 0, the SSM's A_log and dt_bias as the reference draws them.  DiP
    weights are drawn in natural layout one matrix at a time and permutated
    on the device (the offline step of paper Fig. 3); under
    ``cfg.quantization`` each matrix is quantized as it is drawn, so no
    float copy of the whole model is ever held.  Plain layer-stacked leaves
    (the MoE router and expert banks) are drawn one layer at a time, so the
    f32 draw never holds more than one layer's bank.

    Under a ``plan`` (``distributed.make_plan``) each drawn matrix, each
    layer's expert bank and router and the embedding are cut to this rank's
    slice before the next is drawn: the values of
    ``plan.shard_params(init_params(cfg, generator, device))``, from the
    same draws (rank r of T holds experts [r E / T, (r + 1) E / T) of the
    single-rank draw, or under ``fsdp`` its block of each bank's
    contraction dim), while the rank never holds more than its slice and
    one whole matrix or layer's bank.  The SSM's per-head and per-channel
    leaves (a few vectors a layer) are drawn whole and then cut.  Under
    ``pp`` every layer is drawn, in order, and the rank keeps its stage's
    (``plan.stage_layers()``): the same layers of the single-rank draw."""
    dev = resolve_device(device)
    scheme = cfg.quant_scheme
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters go to {dev}")
    staged = plan is not None and plan.strategy == "pp"

    def kept(name, t):
        return t if plan is None or staged else plan.shard_leaf(name, t)

    def own_layers(name, lead):
        """The layers of a stacked leaf this rank keeps: its stage's under
        ``pp``, all of them otherwise."""
        if staged and plan.stage_stacked(name):
            first, n = plan.stage_layers()
            return range(first, first + n)
        return range(lead)

    def normal(shape, scale, dt):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (t * scale).to(dt)

    def make(name, shape, dt, fan, dip):
        dt = dtype_of(dt)
        if fan is None:
            init = torch.zeros if name in ("bq", "bk", "bv") else torch.ones
            return init((len(own_layers(name, shape[0])),) + tuple(shape[1:]) if staged else shape, dtype=dt,
                        device=dev)
        scale = (1.0 / max(1, fan)) ** 0.5
        if dip is None and len(shape) > 2:
            def layer():  # one layer's whole draw, of which this rank keeps its slice
                return kept(name, normal(shape[1:], scale, dt)[None])[0]

            keep, data = own_layers(name, shape[0]), None
            for i in range(shape[0]):
                lyr = layer()
                if i in keep:
                    if data is None:
                        data = torch.empty((len(keep),) + tuple(lyr.shape), dtype=dt, device=dev)
                    data[i - keep.start].copy_(lyr)
            return data
        if dip is None:
            return kept(name, normal(shape, scale, dt))
        d_in, d_out, perm_tile = dip

        def matrix():  # one drawn (d_in, d_out) matrix as storage, this rank's slice of it under a plan
            w = normal((d_in, d_out), scale, dt)
            if scheme is not None:
                w = api.quant.quantize(w, scheme, perm_tile=perm_tile)
            else:
                w = api.DipWeight(permute.permute_tiled(w, perm_tile), d_in, d_out, perm_tile)
            return kept(name, w)

        lead = tuple(shape[:-2])
        if not lead:
            return matrix()
        # every matrix drawn in order; those of the layers this rank keeps stored
        keep, per_layer = own_layers(name, lead[0]), math.prod(lead[1:])
        first = data = scales = None
        for i in range(math.prod(lead)):
            w = matrix()
            if i // per_layer not in keep:
                continue
            if first is None:
                first, kept_lead = w, (len(keep),) + lead[1:]
                data = torch.empty(kept_lead + tuple(w.data.shape), dtype=w.data.dtype, device=dev)
                if scheme is not None:
                    scales = torch.empty(kept_lead + tuple(w.scale.shape), dtype=torch.float32, device=dev)
            j = i - keep.start * per_layer
            data.view((-1,) + tuple(w.data.shape))[j].copy_(w.data)
            if scheme is not None:
                scales.view((-1,) + tuple(w.scale.shape))[j].copy_(w.scale)
        return first.with_data(data) if scheme is None else first.with_data(data, scales)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else make(k, *v) for k, v in t.items()}

    params = build(param_template(cfg))
    if cfg.ssm_state:
        # the SSM scalars: A = -exp(A_log) with A_log = log U(1, 16), dt_bias
        # the inverse softplus of U(1e-3, 0.1), a zero conv bias
        lyr, pdt, shape = params["layers"], dtype_of(cfg.param_dtype), (cfg.n_layers, cfg.n_ssm_heads)
        u = torch.empty(shape, dtype=torch.float32, device=dev)
        lyr["A_log"] = torch.log(u.uniform_(1.0, 16.0, generator=generator)).to(pdt)
        dt0 = torch.empty(shape, dtype=torch.float32, device=dev).uniform_(1e-3, 0.1, generator=generator)
        lyr["dt_bias"] = (dt0 + torch.log(-torch.expm1(-dt0))).to(pdt)
        lyr["conv_b"] = torch.zeros_like(lyr["conv_b"])
        if plan is not None:  # the small SSM leaves, drawn whole: the rank's heads of them
            params["layers"] = plan.shard_params(lyr)
    return params


def _layers(layer_params: Dict[str, Any], n_layers: int) -> List[Dict[str, Any]]:
    """The per-layer views of the layer-stacked leaves (one ``unbind`` per
    leaf, so a backward stacks the layers' gradients once)."""
    def unbound(v):
        if isinstance(v, api.QuantizedDipWeight):
            return [v.with_data(d, s) for d, s in zip(v.data.unbind(0), v.scale.unbind(0))]
        if isinstance(v, api.DipWeight):
            return [v.with_data(d) for d in v.data.unbind(0)]
        return v.unbind(0)

    cols = {k: unbound(v) for k, v in layer_params.items()}
    return [{k: cols[k][i] for k in layer_params} for i in range(n_layers)]


# ---------------------------------------------------------------- forward ---
def _fuses_rmsnorm(cfg) -> bool:
    """Whether the backend fuses the RMSNorm prologue: then the blocks hand
    the un-normalized stream plus the gain to the projections."""
    return "rmsnorm" in api.get_backend(cfg.matmul_backend).prologues


def _rope_dim(cfg) -> int:
    """RoPE width: MLA rotates only its ``qk_rope_head_dim`` channels."""
    return cfg.qk_rope_head_dim if cfg.use_mla else cfg.resolved_head_dim


def _ffn(x, lp, cfg, fuse, replay_ids=None, on_route=None, plan=None):
    """The block's FFN with its skip connection; returns ``(x, routing)``.
    The MoE layer keeps the explicit ``ffn_norm`` (the router and every
    expert read the normed stream) and the explicit ``x + f``; its
    ``routing`` is ``(aux, dropped, ids)``: the router's aux loss, the
    dropped (token, slot) pairs and the (B, S, k) expert ids.
    ``replay_ids`` routes with those ids instead of this run's top-k;
    ``on_route`` is called with the ids as soon as they are chosen.  A dense
    FFN's ``routing`` is None.  Under an ``ep`` plan the ids are the rank's
    own tokens' (``moe.moe_ffn``)."""
    if cfg.is_moe:
        ffn_in = layers.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        f, aux, dropped, ids = moe.moe_ffn(ffn_in, lp, cfg, plan=plan, return_routing=True, route_ids=replay_ids,
                                           on_route=on_route)
        return x + f, (aux, dropped, ids)
    ffn_in, ffn_g = (x, lp["ffn_norm"]) if fuse else (
        layers.rms_norm(x, lp["ffn_norm"], cfg.norm_eps), None)
    return moe.dense_ffn(ffn_in, lp, cfg, residual=x, norm=ffn_g), None


def _replay(moe_trace, layer):
    """Layer ``layer``'s expert ids to route with, if ``moe_trace`` holds
    ``replay_ids`` (one (B, S, k) tensor per layer, from another run)."""
    ids = None if moe_trace is None else moe_trace.get("replay_ids")
    return None if ids is None else ids[layer]


def _record(moe_trace, routing) -> None:
    """Append a MoE layer's ``(aux, dropped, ids)`` to ``moe_trace``."""
    if moe_trace is not None and routing is not None:
        for key, val in zip(("aux", "dropped", "ids"), routing):
            moe_trace.setdefault(key, []).append(val)


def _transformer_block(x, lp, cfg, *, positions, rope, cache, kv_chunk=0, attn_backend=None,
                       replay_ids=None, on_route=None, plan=None, rows=None):
    """Attention then FFN, each with its skip connection; returns ``(x,
    new_cache, routing)`` (``_ffn``'s routing).  ``rows``: the ``sp``
    layout, x the rank's rows (the FFN's ``dip_sp`` launches take them as
    they are)."""
    fuse = _fuses_rmsnorm(cfg)
    attn_in, attn_g = (x, lp["attn_norm"]) if fuse else (
        layers.rms_norm(x, lp["attn_norm"], cfg.norm_eps), None)
    if cfg.use_mla:
        x, new_cache = attention.mla_attention(
            attn_in, lp, cfg, positions=positions, cache=cache, rope=rope, residual=x,
            norm=attn_g, kv_chunk=kv_chunk, attn_backend=attn_backend, plan=plan,
        )
    else:
        x, new_cache = attention.gqa_attention(
            attn_in, lp, cfg, positions=positions, cache=cache, rope=rope, residual=x,
            norm=attn_g, kv_chunk=kv_chunk, attn_backend=attn_backend, plan=plan, rows=rows,
        )
    x, routing = _ffn(x, lp, cfg, fuse, replay_ids, on_route, plan)
    return x, new_cache, routing


def _embed(table: torch.Tensor, tokens: torch.Tensor, plan, rows=None) -> torch.Tensor:
    """The token lookup; under a plan vocab-parallel: this rank's rows of
    the table answer the tokens in its range, the others give zeros, and
    one all-reduce sums the ranks' rows (exactly: one rank is nonzero);
    under ``sp`` (``rows``) one reduce-scatter instead, to the rank's rows
    of the stream.  Under ``fsdp`` the rank's d / T columns of every
    token's row, then one all-gather of the columns."""
    if plan is None:
        return F.embedding(tokens, table)
    if plan.strategy == "fsdp":
        return comm.all_gather(F.embedding(tokens, table), plan.mesh, plan.fsdp, dim=-1)
    v_loc = table.shape[0]
    local = tokens - plan.tp_rank * v_loc
    hit = (local >= 0) & (local < v_loc)
    found = F.embedding(local.clamp(0, v_loc - 1), table)
    found = torch.where(hit[..., None], found, torch.zeros((), dtype=found.dtype, device=found.device))
    return rows.scatter(found) if rows is not None else comm.psum(found, plan.mesh, plan.tp)


def _head(params, cfg, x, plan=None, rows=None):
    """The lm_head through ``linear`` on final-normed x, padded-vocab lanes
    masked to -1e30.  A tied head is the embedding cast to the compute
    dtype, multiplied in f32: the exact products of the compute-dtype
    values summed in f32, as the reference's ``preferred_element_type``
    gives them (a bf16 ``torch.matmul`` would round the sums to bf16).
    Under ``tp`` / ``ep`` the head is column-parallel over the padded vocab
    (a tied one: the rank's vocab rows of the embedding) and its logits are
    all-gathered (a separate head's in the compute dtype, before the f32
    cast); under ``fsdp`` a separate head gathers its storage in the
    dispatch, a tied one all-gathers the embedding's columns first.  Under
    ``sp`` (``rows``; x the rank's rows) a separate head's ``dip_sp``
    column output is cropped to the real rows before the gather of vocab,
    and a tied one first all-gathers the rows; the logits are (B, S, V)."""
    cd = dtype_of(cfg.compute_dtype)
    vocab_split = plan is not None and plan.strategy != "fsdp"
    if cfg.tie_embeddings:
        table = params["embed"]
        if plan is not None and plan.strategy == "fsdp":
            table = comm.all_gather(table, plan.mesh, plan.fsdp, dim=1)
        if rows is not None:
            x = rows.gather(x)
        logits = torch.matmul(x.to(cd).float(), table.to(cd).float().t())
        if vocab_split:
            logits = comm.all_gather(logits, plan.mesh, plan.tp, dim=-1)
    else:
        logits = layers.linear(x, params["lm_head"], backend=cfg.matmul_backend, compute_dtype=cd)
        if rows is not None:
            logits = rows.whole(logits)
        if vocab_split:
            logits = comm.all_gather(logits, plan.mesh, plan.tp, dim=-1)
        logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        lane = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(lane >= cfg.vocab_size, -1e30)
    return logits


def _seq_rows(plan, batch: int, seq: int):
    """The ``sp`` row layout of a (batch, seq) call (``layers.SeqRows``),
    None under the other strategies."""
    return layers.SeqRows(plan, batch, seq) if plan is not None and plan.strategy == "sp" else None


def _row_split(plan, batch: int):
    """(first row, rows) of this rank's batch under ``fsdp`` where the
    batch divides the data axis (the reference's ``dp_for``), else None:
    every rank runs every row."""
    if plan is None or plan.strategy != "fsdp" or plan.fsdp_size == 1 or batch % plan.fsdp_size:
        return None
    n = batch // plan.fsdp_size
    return plan.fsdp_rank * n, n


def _own_rows(t, split, dim: int = 0):
    """``t`` (a tensor, or a dict of them, recursively) narrowed to this
    rank's rows along ``dim``: views, so in-place cache writes land in the
    whole cache."""
    if split is None or t is None:
        return t
    if isinstance(t, dict):
        return {k: _own_rows(v, split, dim) for k, v in t.items()}
    return t.narrow(dim, *split)


def _gather_rows(logits: torch.Tensor, plan, split) -> torch.Tensor:
    """The logits of every rank's rows on every rank (one all-gather), so
    that each rank's host sampler sees the whole batch."""
    return logits if split is None else comm.all_gather(logits, plan.mesh, plan.fsdp, dim=0)


def forward(params: Dict[str, Any], cfg, *, tokens: Optional[torch.Tensor] = None,
            embeddings: Optional[torch.Tensor] = None, cache: Optional[Dict] = None,
            kv_chunk: int = 0, return_hidden: bool = False, attn_backend: Optional[str] = None,
            moe_trace: Optional[Dict] = None, return_aux: bool = False, plan=None, constrain=None):
    """Returns ``(logits, new_cache)`` for tokens (B, S), or with
    ``return_aux=True`` ``(logits, new_cache, aux)``: ``aux`` the MoE
    layers' router aux losses summed (an f32 scalar, 0 for the other
    families), which the loss adds to the cross entropy.

    ``embeddings`` (B, S, d), the stub frontends' precomputed inputs, are
    cast to the compute dtype and replace the token lookup.  ``cache``
    (``init_cache``) is updated in place at ``cache["pos"]``, a
    device scalar that is advanced by S in place too (so a CUDA graph of
    the step reads and advances it with no host involved), and returned.
    ``attn_backend="flash"`` routes attention through the CUDA kernel
    (serving prefill; forward only);
    ``kv_chunk > 0`` takes the KV-chunked online-softmax attention; MLA
    with a cache takes its absorbed form and ignores both, as the
    reference does.  ``moe_trace`` (a dict) collects each MoE layer's
    ``aux`` loss, ``dropped`` count and expert ``ids``, as lists in layer
    order, once per forward; given ``replay_ids`` (a list of one run's
    ``ids``), every layer routes as that run did.  The SSM and hybrid
    families run the chunked SSD over S tokens, or with a cache and S = 1
    the O(1) decode update, and write each layer's new conv history and
    state into the cache.  ``return_hidden=True`` skips the lm_head and
    returns the final-normed hidden states (B, S, d) in the compute dtype,
    for the fused loss.  With ``cfg.remat == "block"``, no cache and grad
    mode on, each block runs under ``torch.utils.checkpoint`` and its
    forward runs again in the backward: a block's aux and routing leave it
    as outputs, and the rerun records its expert ids in
    ``moe_trace["recompute_ids"]`` (by layer), so that a caller can check
    that the backward routed as the forward did.

    ``plan`` (a ``distributed.ShardingPlan``) runs the rank's part of the
    sharded forward on ``plan.shard_params`` parameters (module doc; under
    ``fsdp`` the rank's rows where the batch splits, the cache's rows of
    them written, the logits of every row returned; under ``sp`` the
    rank's rows of the stream, every row of the rank's heads in the cache,
    the logits and ``return_hidden``'s states of every row returned);
    ``constrain(x, tag)`` is the reference's activation hook, called at
    ``"act_btd"`` (the residual stream after the embedding and after each
    block) and ``"logits"``, and a plan's (``plan.constrain``) wins: the
    identity, since the explicit strategies place every collective.
    """
    _require_served(cfg)
    _require_plan(cfg, plan)
    constrain = layers.resolve_constrain(plan, constrain)
    cd = dtype_of(cfg.compute_dtype)
    b, s = (embeddings if embeddings is not None else tokens).shape[:2]
    rows = _seq_rows(plan, b, s)
    if embeddings is not None:
        x = embeddings.to(cd) if rows is None else rows.own(embeddings.to(cd))
    else:
        x = _embed(params["embed"], tokens, plan, rows).to(cd)
    split = _row_split(plan, b)
    x = constrain(_own_rows(x, split), "act_btd")
    positions = torch.arange(s, device=x.device)
    if cache is not None:
        positions = positions + cache["pos"]
    remat = cfg.remat == "block" and cache is None and torch.is_grad_enabled()
    auxes: List[torch.Tensor] = []
    layer_cache = None if cache is None else dict(cache, layers=_own_rows(cache["layers"], split, 1))
    if cfg.ssm_state:
        x = _scan_mamba(params, cfg, x, layer_cache, positions, remat, kv_chunk, attn_backend, plan, rows)
    else:
        x = _scan_transformer(params, cfg, x, layer_cache, positions, remat, kv_chunk, attn_backend, moe_trace,
                              auxes, plan, constrain, rows)
    # in place: the layers read pos before, in stream order
    new_cache = None if cache is None else dict(cache, pos=cache["pos"].add_(s))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        out = (x if rows is None else rows.gather(x)), new_cache
    else:
        out = constrain(_gather_rows(_head(params, cfg, x, plan, rows), plan, split), "logits"), new_cache
    if not return_aux:
        return out
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxes:  # in layer order, as the reference's scan carries it
        aux = aux + a
    return out + (aux,)


def _maybe_remat(block, x, remat):
    return checkpoint(block, x, use_reentrant=False) if remat else block(x)


def _scan_transformer(params, cfg, x, cache, positions, remat, kv_chunk, attn_backend, moe_trace, auxes,
                      plan=None, constrain=None, rows=None):
    """The transformer families' layer loop; the cache is written in place
    and each MoE layer's router aux loss appended to ``auxes``."""
    start = cache["pos"] if cache is not None else 0
    rope = layers.rope_tables(positions, _rope_dim(cfg), cfg.rope_theta)
    calls = [0] * cfg.n_layers
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        lcache = None if cache is None else dict(
            {nm: t[i] for nm, t in cache["layers"].items()}, pos=start)

        def block(x, i=i, lp=lp, lcache=lcache):
            calls[i] += 1  # a second call is remat's rerun in the backward
            seen = None
            if calls[i] > 1 and moe_trace is not None:
                def seen(ids, i=i):
                    moe_trace.setdefault("recompute_ids", {})[i] = ids
            x, _, routing = _transformer_block(x, lp, cfg, positions=positions, rope=rope, cache=lcache,
                                               kv_chunk=kv_chunk, attn_backend=attn_backend,
                                               replay_ids=_replay(moe_trace, i), on_route=seen, plan=plan,
                                               rows=rows)
            return x if constrain is None else constrain(x, "act_btd"), routing

        x, routing = _maybe_remat(block, x, remat)
        _record(moe_trace, routing)
        if routing is not None:
            auxes.append(routing[0])
    return x


def _mamba_block(x, lp, cfg, cache, plan=None, rows=None):
    """RMSNorm, then the SSD block with the skip connection in its out
    projection's epilogue (``plan``, ``rows``: ``ssm.ssd_block``'s)."""
    return ssm.ssd_block(layers.rms_norm(x, lp["norm_in"], cfg.norm_eps), lp, cfg, cache=cache, residual=x,
                         plan=plan, rows=rows)


def _ssm_cache(pools, i):
    """Layer ``i``'s conv history and state views of the stacked pools."""
    return {"conv": pools["conv"][i], "state": pools["state"][i], "pos": 0}


def _store_ssm(pools, i, new):
    """Write a block's new conv history and state back into layer ``i`` of
    the stacked pools, in place."""
    pools["conv"][i].copy_(new["conv"])
    pools["state"][i].copy_(new["state"])


def _scan_mamba(params, cfg, x, cache, positions, remat, kv_chunk, attn_backend, plan=None, rows=None):
    """The mamba2 stack; for the hybrid, after every ``attn_every``-th layer
    the shared attention+FFN block, whose parameters every call site shares
    and whose K/V cache is the site's own (``cache["layers"]["attn"]``,
    stacked over the ``n_layers // attn_every`` sites).  The RoPE tables
    are built once, at the shared block's head dim.  The caches are written
    in place.  ``plan`` goes to every block (the shared one runs the dense
    block's sharded path)."""
    pools = None if cache is None else cache["layers"]
    start = cache["pos"] if cache is not None else 0
    if cfg.is_hybrid:
        shared = params["shared_attn"]
        rope = layers.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        def block(x, lp=lp, lcache=None if pools is None else _ssm_cache(pools, i)):
            out, new = _mamba_block(x, lp, cfg, lcache, plan, rows)
            if new is not None:
                _store_ssm(pools, i, new)
            return out

        x = _maybe_remat(block, x, remat)
        if cfg.is_hybrid and (i + 1) % cfg.attn_every == 0:
            j = i // cfg.attn_every
            acache = None if pools is None else dict({nm: t[j] for nm, t in pools["attn"].items()}, pos=start)

            def shared_block(x, acache=acache):
                return _transformer_block(x, shared, cfg, positions=positions, rope=rope, cache=acache,
                                          kv_chunk=kv_chunk, attn_backend=attn_backend, plan=plan,
                                          rows=rows)[0]

            x = _maybe_remat(shared_block, x, remat)
    return x


# ------------------------------------------------------------------ caches --
def _kv_heads(cfg, plan) -> int:
    """The KV heads a rank's caches hold: all of them, or under a plan its
    share of the head axis as ``plan.paged_cache_pspec`` shards it."""
    if plan is None:
        return cfg.n_kv_heads
    axis = plan.paged_cache_pspec("k", (cfg.n_layers, 1, 1, cfg.n_kv_heads, cfg.resolved_head_dim))[3]
    return cfg.n_kv_heads // (plan.mesh.shape[axis] if axis else 1)


def init_cache(cfg, batch: int, max_seq: int, *, device, plan=None) -> Dict[str, Any]:
    """Layer-stacked dense decode cache: k/v (L, B, max_seq, KV, hd), or
    under MLA the latent c_kv (L, B, max_seq, kv_lora_rank) and the shared
    k_rope (L, B, max_seq, rope); for the SSM families the conv history
    conv (L, B, ssm_conv - 1, conv_dim) in the compute dtype and the state
    (L, B, H, P, N) in f32, and for the hybrid the shared block's
    attn = {k, v} (n_layers // attn_every, B, max_seq, KV, hd).  ``pos``, the
    next row to write, is a 0-dim int64 tensor on ``device``.  Under a
    ``plan`` k/v hold the rank's KV heads, and conv and state its SSM
    heads (``ssm.rank_dims``)."""
    _require_served(cfg)
    _require_plan(cfg, plan)
    cd, L = dtype_of(cfg.compute_dtype), cfg.n_layers
    if cfg.ssm_state:
        layer_caches = _ssm_pools(cfg, batch, cd, device, plan)
        if cfg.is_hybrid:
            shape = (cfg.n_layers // cfg.attn_every, batch, max_seq, _kv_heads(cfg, plan), cfg.resolved_head_dim)
            layer_caches["attn"] = {nm: torch.zeros(shape, dtype=cd, device=device) for nm in ("k", "v")}
        return {"layers": layer_caches, "pos": attention.init_pos(device)}
    if cfg.use_mla:
        shapes = {"c_kv": (L, batch, max_seq, cfg.kv_lora_rank),
                  "k_rope": (L, batch, max_seq, cfg.qk_rope_head_dim)}
    else:
        shape = (L, batch, max_seq, _kv_heads(cfg, plan), cfg.resolved_head_dim)
        shapes = {"k": shape, "v": shape}
    return {"layers": {nm: torch.zeros(sh, dtype=cd, device=device) for nm, sh in shapes.items()},
            "pos": attention.init_pos(device)}


def reset_cache(cfg, cache: Dict[str, Any]) -> Dict[str, Any]:
    """Make an :func:`init_cache` cache ready for a new sequence, in place:
    ``pos`` to 0 and, for the SSM families, the conv history and state to 0
    (the recurrence starts from them).  Rows of K/V past ``pos`` need no
    clearing: a step writes its rows before it reads them, and the valid
    length masks the rest."""
    cache["pos"].zero_()
    if cfg.ssm_state:
        cache["layers"]["conv"].zero_()
        cache["layers"]["state"].zero_()
    return cache


def _ssm_pools(cfg, batch: int, dtype, device, plan=None) -> Dict[str, torch.Tensor]:
    """Every layer's conv history and state for ``batch`` rows, stacked:
    under a ``tp`` plan the rank's heads of the state and their conv
    channels (``plan.paged_cache_pspec``)."""
    one = ssm.init_ssm_cache(batch, cfg, dtype, device=device, plan=plan)
    return {nm: one[nm].expand((cfg.n_layers,) + tuple(one[nm].shape)).clone() for nm in ("conv", "state")}


def init_paged_cache(cfg, num_blocks: int, block_size: int, *, kv_quant: str = "none", slots: int = 0,
                     device, plan=None) -> Dict[str, Any]:
    """Layer-stacked paged pools for the serving engine: k/v (L, num_blocks,
    block_size, KV, hd), and under int8 ``kv_quant`` their per-(token, head)
    f32 scales k_scale/v_scale (L, num_blocks, block_size, KV); under MLA
    the latent c_kv (L, num_blocks, block_size, kv_lora_rank) and k_rope
    (L, num_blocks, block_size, rope), and under int8 ``kv_quant`` one f32
    scale per token for each, c_kv_scale/k_rope_scale (L, num_blocks,
    block_size).  Block 0 is the null block
    (serving/kv_cache.py).  The SSM families' conv history and state are
    O(1) per sequence, so they get a plain pool of ``slots`` rows (``conv``
    and ``state`` as in :func:`init_cache`, batch axis = slot) instead of
    pages; the hybrid pages only its shared block's K/V, ``attn`` = {k, v}
    (n_layers // attn_every, num_blocks, block_size, KV, hd), with their
    scales under int8 ``kv_quant``; a pure SSM model pages nothing, so
    ``kv_quant`` changes nothing there.  The attention families keep
    nothing per slot and ignore ``slots``.  Under a ``plan`` the pools hold
    the rank's KV heads and SSM heads (``plan.paged_cache_pspec``), under
    ``fsdp`` every head and slot; the block tables stay on the host."""
    _require_served(cfg)
    _require_plan(cfg, plan)
    cd = dtype_of(cfg.compute_dtype)

    def stacked(pool, n):
        return {nm: t.expand((n,) + tuple(t.shape)).clone() for nm, t in pool.items()}

    def gqa_pool():
        return attention.init_paged_gqa_cache(
            num_blocks, block_size, _kv_heads(cfg, plan), cfg.resolved_head_dim, cd, kv_quant, device=device)

    if cfg.ssm_state:
        if slots < 1:
            raise ValueError(f"{cfg.name}: the SSM state pools need slots >= 1, got {slots}")
        pools: Dict[str, Any] = _ssm_pools(cfg, slots, cd, device, plan)
        if cfg.is_hybrid:
            pools["attn"] = stacked(gqa_pool(), cfg.n_layers // cfg.attn_every)
        return {"layers": pools}
    if cfg.use_mla:
        pool = attention.init_paged_mla_cache(num_blocks, block_size, cfg, cd, kv_quant, device=device)
    else:
        pool = gqa_pool()
    return {"layers": stacked(pool, cfg.n_layers)}


def decode_step_fn(cfg, *, attn_backend: Optional[str] = None, plan=None, constrain=None):
    """Returns ``step(params, cache, tokens) -> (logits, cache)``; with
    ``attn_backend="flash"`` it is the engine's chunked-prefill step.
    ``moe_trace``, ``plan`` and ``constrain`` as in :func:`forward`."""
    _require_plan(cfg, plan)

    def step(params, cache, tokens, moe_trace=None):
        return forward(params, cfg, tokens=tokens, cache=cache, attn_backend=attn_backend, moe_trace=moe_trace,
                       plan=plan, constrain=constrain)

    return step


def _paged_block(x, lp, cfg, pools, positions, block_tables, rope, moe_trace, layer, plan=None, rows=None):
    """One attention+FFN block of the paged decode step (a layer of the
    transformer families, or the hybrid's shared block at one site);
    a MoE layer's routing goes into ``moe_trace``."""
    fuse = _fuses_rmsnorm(cfg)
    attn_in, attn_g = (x, lp["attn_norm"]) if fuse else (layers.rms_norm(x, lp["attn_norm"], cfg.norm_eps), None)
    kw = dict(positions=positions, cache=pools, block_tables=block_tables, kv_quant=cfg.kv_quant, rope=rope,
              residual=x, norm=attn_g)
    if cfg.use_mla:
        x, _ = attention.paged_mla_attention(attn_in, lp, cfg, plan=plan, **kw)
    else:
        x, _ = attention.paged_gqa_attention(attn_in, lp, cfg, plan=plan, rows=rows, **kw)
    x, routing = _ffn(x, lp, cfg, fuse, _replay(moe_trace, layer), plan=plan)
    _record(moe_trace, routing)
    return x


def paged_decode_step_fn(cfg, *, plan=None, constrain=None):
    """Returns ``step(params, cache, tokens, positions, block_tables) ->
    (logits, cache)``, the engine's decode step: tokens (slots, 1),
    positions (slots,), block_tables (slots, blocks_per_seq), all integer
    tensors on the parameters' device; the pools are updated in place.
    The SSM families update each slot's row of the state pools by the O(1)
    decode (positions and block tables are read only by the hybrid's
    shared block).  ``moe_trace``, ``plan`` and ``constrain`` as in
    :func:`forward`: under ``fsdp`` a rank decodes its slots where the
    slots divide the data axis, writing only their rows of the pools;
    under ``sp`` the stream is the rank's rows of the slots, and every
    slot's row of the rank's heads is written."""
    _require_served(cfg)
    _require_plan(cfg, plan)
    constrain = layers.resolve_constrain(plan, constrain)

    def step(params, cache, tokens, positions, block_tables, moe_trace=None):
        cd = dtype_of(cfg.compute_dtype)
        rows = _seq_rows(plan, *tokens.shape[:2])
        x = _embed(params["embed"], tokens, plan, rows).to(cd)
        split = _row_split(plan, tokens.shape[0])  # fsdp: this rank's slots
        x = constrain(_own_rows(x, split), "act_btd")
        positions, block_tables = _own_rows(positions, split), _own_rows(block_tables, split)
        pools = cache["layers"]
        lps = _layers(params["layers"], cfg.n_layers)
        if cfg.ssm_state:
            slots = {nm: _own_rows(pools[nm], split, 1) for nm in ("conv", "state")}
            if cfg.is_hybrid:
                rope = layers.rope_tables(positions[:, None], cfg.resolved_head_dim, cfg.rope_theta)
            for i, lp in enumerate(lps):
                x, new = _mamba_block(x, lp, cfg, _ssm_cache(slots, i), plan, rows)
                _store_ssm(slots, i, new)
                if cfg.is_hybrid and (i + 1) % cfg.attn_every == 0:
                    j = i // cfg.attn_every
                    x = _paged_block(x, params["shared_attn"], cfg, {nm: t[j] for nm, t in pools["attn"].items()},
                                     positions, block_tables, rope, None, j, plan, rows)
        else:
            rope = layers.rope_tables(positions[:, None], _rope_dim(cfg), cfg.rope_theta)
            for i, lp in enumerate(lps):
                x = constrain(_paged_block(x, lp, cfg, {nm: pool[i] for nm, pool in pools.items()}, positions,
                                           block_tables, rope, moe_trace, i, plan, rows), "act_btd")
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return constrain(_gather_rows(_head(params, cfg, x, plan, rows), plan, split), "logits"), cache

    return step


# ------------------------------------------------------------- objectives ---
def _natural_head(params, cfg) -> torch.Tensor:
    """The lm_head as a natural (d_model, padded_vocab) tensor for the fused
    loss: a tied head is the embedding's transpose (a view: the head's
    gradient returns through it into ``embed`` and adds to the lookup's); a
    ``DipWeight`` is de-sheared in the parameter dtype, so a gradient
    reaches its permutated storage; a ``QuantizedDipWeight`` is dequantized
    to f32, as the reference does (its codes take no gradient, its scales
    that of the dequantized head)."""
    if cfg.tie_embeddings:
        return params["embed"].t()
    head = params["lm_head"]
    if isinstance(head, api.QuantizedDipWeight):
        return head.to_natural(torch.float32)
    return head.to_natural() if isinstance(head, api.DipWeight) else head


def loss_fn(params, cfg, batch, *, kv_chunk: int = 0, fused_ce: Optional[bool] = None,
            plan=None, constrain=None, moe_trace: Optional[Dict] = None) -> torch.Tensor:
    """Next-token cross entropy plus the router aux loss (0 but for MoE).
    ``batch`` holds ``labels`` and ``tokens`` or, from a stub frontend,
    ``embeddings`` (B, S, d), which ``forward`` reads in place of the
    tokens.  ``batch["loss_mask"]`` (optional, (B, S), nonzero = train on
    this position) and the -100 ``ignore_index`` in ``labels`` both exclude
    tokens from the mean and the gradient.

    ``fused_ce=None`` selects the fused lm_head + cross-entropy kernel, as
    the reference does when no plan or constrain hook needs the logits: the
    (B, S, V) logits are then never formed; with a ``constrain`` hook
    (called as in :func:`forward`) or a ``plan`` it takes the unfused path.
    ``False`` forces the unfused path through the lm_head projection.
    ``moe_trace`` as in :func:`forward`.

    Under a sharding ``plan`` (this rank's parameters, ``plan.shard_params``
    or ``init_params(plan=)``; every rank passes the same whole batch) the
    forward returns the whole (B, S, V) logits on every rank (the vocab's
    or the rows' all-gather, module doc), so the next-token shift (under
    ``sp`` across the ranks' row blocks), the mask and the mean over the
    batch's trained tokens are the single-rank ones, and the MoE aux is the
    whole batch's: every rank returns the same global loss.  The fused
    kernel does not run under a plan (``fused_ce=True`` raises): the
    reference takes the unfused loss there."""
    _require_served(cfg)
    _require_plan(cfg, plan)
    mask = batch.get("loss_mask")
    shift_mask = None if mask is None else mask[:, 1:]
    inputs = dict(tokens=batch.get("tokens"), embeddings=batch.get("embeddings"), kv_chunk=kv_chunk,
                  moe_trace=moe_trace, return_aux=True, constrain=constrain, plan=plan)
    if plan is not None and fused_ce:
        raise NotImplementedError(f"the fused lm_head + cross-entropy kernel under a sharding plan is not ported "
                                  f"({_DISTRIBUTED}); the reference takes the unfused loss under a plan")
    if fused_ce is None and (constrain is not None or plan is not None):
        fused_ce = False
    if fused_ce is None or fused_ce:
        hidden, _, aux = forward(params, cfg, return_hidden=True, **inputs)
        return lm_head_ce.fused_cross_entropy_loss(
            hidden[:, :-1], _natural_head(params, cfg), batch["labels"][:, 1:], mask=shift_mask,
            vocab_size=cfg.vocab_size) + aux
    logits, _, aux = forward(params, cfg, **inputs)
    return layers.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:], mask=shift_mask) + aux


def train_step_fn(cfg, optimizer, *, kv_chunk: int = 0, microbatch: int = 1,
                  fused_ce: Optional[bool] = None, guard: bool = False, plan=None,
                  constrain=None):
    """Returns ``step(state, batch) -> (state, metrics)`` for ``state =
    {"params", "opt_state", "step"}`` and a batch of (B, S) ``tokens`` (or
    (B, S, d) ``embeddings``) and ``labels`` tensors on the parameters'
    device.

    The gradients are taken with ``torch.autograd.grad`` over every
    parameter leaf (a ``DipWeight``'s permutated ``data``; a leaf that the
    loss does not reach, as the embedding of a model fed ``embeddings``
    with a separate head, gets zeros, as ``jax.grad`` gives it); the optimizer
    then updates the parameters and its moments IN PLACE, so the returned
    state holds the same tensors.  ``microbatch > 1`` splits the batch into
    that many slices, sums their losses and gradients and scales both by
    1/microbatch, as the reference's scan does.  Metrics: ``loss``,
    ``grad_norm`` (pre-clip) and ``step``, as 0-d tensors / int.  The
    returned step's ``loss_and_grads(params, batch, moe_trace=None)`` is
    its first half alone (loss, gradient tree, and under a plan the global
    norm), for a caller that holds the gradients against another run's.

    ``guard=True`` puts the step behind the reliability guard
    (``reliability.guard``); the state then carries its side-car keys
    (``reliability.init_guard_state``).  Its screens run where the
    reference's do, but AdamW updates in place, so instead of selecting
    between two states it decides before the update: the fingerprint is
    taken before the forward pass, forward and backward run as unguarded
    (the same metrics), the global gradient norm is computed, and
    ``optimizer.update`` runs only when the weights, the loss and the norm
    all pass (one read to the host).  A skipped step leaves the parameters
    and the optimizer state (``count`` and ``grad_norm`` included) as they
    were and freezes the fingerprint reference; ``step`` advances either
    way.  Metrics gain ``skipped`` / ``weight_fault`` (0 or 1) and
    ``skipped_total`` / ``weight_faults_total``.  ``constrain`` as in
    :func:`loss_fn`.

    Under a sharding ``plan`` (``make_plan(mesh, cfg, "train")``; the state
    holds this rank's parameters and moments, and every rank passes the
    same whole batch) every rank computes the global loss
    (:func:`loss_fn`) and differentiates ``loss / ranks``: its share of the
    replicated loss, under the collectives' transpose convention
    (``distributed.comm``).  A leaf this rank holds a slice of then has that
    slice's whole gradient; the shares of every leaf it holds whole (the
    norm gains, the router, the small SSM leaves, biases, projections the
    plan replicates, under ``fsdp`` whatever the plan keeps whole) are
    summed over the ranks by ONE psum after the backward
    (:func:`replicated_parts` tells them apart).  The global norm counts each
    slice once and each whole leaf once (``optim.adamw.global_norm``), so
    clipping and ``grad_norm`` are the single-rank run's on every rank;
    the reported ``loss`` is the global one.  Under ``guard=True`` the
    ranks' verdicts meet in one psum of their flags, so that no rank
    updates where another skips.  A (data, model) mesh with both axes above
    1 raises (ROADMAP.md Queue 1 "Distributed").  A ``pp`` plan returns
    ``distributed.pipeline.pipeline_train_step_fn``'s step with
    ``n_micro = 2 * plan.stages`` (the reference ``Trainer``'s default);
    the options that step lacks (``kv_chunk``, ``microbatch``, the fused
    loss, ``constrain``) raise there.

    The optimizer's ``grad_transform`` (gradient compression) runs after
    the backward and the whole leaves' psum, before the norm is taken: the
    norm and the clipping are the transformed gradients', as in the
    reference's ``AdamW.update``; under a plan its per-leaf scales are the
    whole leaves' (one ``comm.pmax`` over the ranks).  Under the guard a
    skipped step also keeps the transform's state."""
    _require_trainable(cfg)
    _require_train_plan(cfg, plan)
    if plan is not None and plan.strategy == "pp":
        if kv_chunk or microbatch > 1 or fused_ce or constrain is not None:
            raise ValueError("the pipelined step takes no kv_chunk, microbatch, fused loss or constrain hook")
        from repro_torch.distributed import pipeline  # lazy: the pipeline imports this module

        return pipeline.pipeline_train_step_fn(cfg, optimizer, plan, n_micro=2 * plan.stages, guard=guard)

    def loss_of(params, batch, moe_trace=None):
        return loss_fn(params, cfg, batch, kv_chunk=kv_chunk, fused_ce=fused_ce, constrain=constrain, plan=plan,
                       moe_trace=moe_trace)

    return _step_fn(cfg, optimizer, loss_of, plan=plan, microbatch=microbatch, guard=guard)


def _step_fn(cfg, optimizer, loss_of, *, plan=None, microbatch: int = 1, guard: bool = False):
    """:func:`train_step_fn`'s step around ``loss_of(params, batch,
    moe_trace) -> global loss`` (its own or the pipeline's): the
    gradients (``loss / ranks`` under a plan, the whole leaves' shares
    psummed once), the optimizer's transform, the global norm, the update,
    and under ``guard`` the joint verdict first."""
    if plan is not None:
        mesh, axis, ranks = plan.mesh, _rank_axis(plan), plan.mesh.size
    compress = optimizer.grad_transform is not None

    def grad_of(leaves, params, batch, moe_trace=None):
        loss = loss_of(params, batch, moe_trace)
        seed = loss if plan is None else loss / ranks
        grads = torch.autograd.grad(seed, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]

    def whole_leaves_summed(params, flat):
        """ONE psum of the ranks' shares of every part of a leaf that each
        rank holds alike (:func:`replicated_parts`); a leaf held whole
        becomes its part of the sum (no copy: under ``pp`` the embedding
        and the head are whole on every rank)."""
        parts = replicated_parts(params, cfg)
        held = [i for i, rep in enumerate(parts) if rep is not None]
        if held:
            shapes = [flat[i][..., parts[i]].shape for i in held]
            dtypes = [flat[i].dtype for i in held]
            shares = torch.cat([flat[i][..., parts[i]].float().reshape(-1) for i in held])
            for i in held:  # a whole leaf's share now lives in ``shares``: free it before the sum comes back
                if parts[i] == slice(None):
                    flat[i] = None
            summed = comm.psum(shares, mesh, axis)
            del shares
            for i, shape, dt, got in zip(held, shapes, dtypes, summed.split([math.prod(sh) for sh in shapes])):
                got = got.view(shape).to(dt)
                if parts[i] == slice(None):
                    flat[i] = got
                else:
                    g = flat[i].clone()
                    g[..., parts[i]] = got
                    flat[i] = g
        return flat, parts

    def norm_of(params, flat):
        """The global norm of the gradient leaves ``flat``: over the ranks
        under a plan (each slice once, each whole leaf once)."""
        if plan is None:
            return global_norm(flat)
        return global_norm(flat, replicated=replicated_parts(params, cfg), psum=lambda t: comm.psum(t, mesh, axis))

    def loss_and_grads(params, batch, moe_trace=None, norm=True):
        leaves = tree.leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        if microbatch <= 1:
            loss, flat = grad_of(leaves, params, batch, moe_trace)
        else:
            loss, flat = 0.0, None
            for i in range(microbatch):
                part = {k: v.chunk(microbatch)[i] for k, v in batch.items()}
                loss_i, g_i = grad_of(leaves, params, part)
                loss = loss + loss_i
                flat = [g.float() for g in g_i] if flat is None else [a + g for a, g in zip(flat, g_i)]
            inv = 1.0 / microbatch
            loss = loss * inv
            flat = [g * inv for g in flat]
        if plan is None:
            return loss, tree.unflatten(params, flat), None
        flat, _ = whole_leaves_summed(params, flat)
        return loss, tree.unflatten(params, flat), norm_of(params, flat) if norm else None

    def clipped(params, batch, opt_state):
        """(loss, the gradients as the optimizer clips them, their global
        norm or None without a plan and a transform): after the transform,
        its state advanced in ``opt_state``, the norm taken anew."""
        loss, grads, gnorm = loss_and_grads(params, batch, norm=not compress)
        if compress:
            rmax = None if plan is None else (lambda t: comm.pmax(t, mesh, axis))
            grads = optimizer.transform(grads, opt_state, reduce_max=rmax)
            gnorm = norm_of(params, tree.leaves(grads))
        return loss, grads, gnorm

    def step(state, batch):
        params = state["params"]
        loss, grads, gnorm = clipped(params, batch, state["opt_state"])
        params, opt_state = optimizer.update(grads, state["opt_state"], params, gnorm=gnorm, transformed=True)
        new_state = {"params": params, "opt_state": opt_state, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": optimizer.last_grad_norm(opt_state),
                           "step": new_state["step"]}

    # the step's first half, for a caller that holds the gradients to
    # another run's: (loss, gradient tree, global norm or None without a
    # plan), with the step's collectives; ``moe_trace`` as in ``loss_fn``
    step.loss_and_grads = loss_and_grads
    if not guard:
        return step

    def guarded_step(state, batch):
        params, opt_state = state["params"], state["opt_state"]
        weights_ok = guard_lib.fingerprint_ok(guard_lib.fingerprint(params), state["fingerprint"])
        kept = [t.clone() for t in tree.leaves(opt_state["transform"])] if compress else None
        loss, grads, gnorm = clipped(params, batch, opt_state)
        if gnorm is None:
            gnorm = global_norm(grads)
        flags = torch.stack([weights_ok, weights_ok & torch.isfinite(loss) & torch.isfinite(gnorm)])
        if plan is not None:  # the joint verdict: a step every rank passes, a fault any rank sees
            flags = comm.psum((~flags).to(torch.float32), mesh, axis) == 0
        w_ok, ok = flags.tolist()
        if ok:
            optimizer.update(grads, opt_state, params, gnorm=gnorm, transformed=True)
        elif compress:  # a skipped step keeps the transform's state too
            for t, was in zip(tree.leaves(opt_state["transform"]), kept):
                t.copy_(was)
        skipped, wfault = int(not ok), int(not w_ok)
        new_state = dict(state, step=state["step"] + 1,
                         fingerprint=guard_lib.fingerprint(params) if ok else state["fingerprint"],
                         skipped=state["skipped"] + skipped, weight_faults=state["weight_faults"] + wfault)
        return new_state, {"loss": loss, "grad_norm": gnorm, "step": new_state["step"], "skipped": skipped,
                           "weight_fault": wfault, "skipped_total": new_state["skipped"],
                           "weight_faults_total": new_state["weight_faults"]}

    return guarded_step
