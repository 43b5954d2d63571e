"""The decoder: parameters, forward, caches, the serving steps and the
training objective (port of the transformer-family parts of
``repro/models/transformer.py``).

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
ones (``models/moe.py``).  ``loss_fn`` takes the fused lm_head +
cross-entropy kernel (``kernels/lm_head_ce.py``) unless told otherwise, and
``train_step_fn`` applies one AdamW step in place.  Training the MoE and
MLA families, their quantized serving, the SSM and hybrid families, tied
embeddings, sharding plans and the reliability guard come with their
ROADMAP.md items and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import api, tree
from repro_torch.core import permute
from repro_torch.device import dtype_of, resolve_device
from repro_torch.kernels import lm_head_ce
from repro_torch.models import attention, layers, moe

__all__ = [
    "param_template",
    "quantize_params",
    "init_params",
    "forward",
    "init_cache",
    "init_paged_cache",
    "decode_step_fn",
    "paged_decode_step_fn",
    "loss_fn",
    "train_step_fn",
]

_FAMILIES = 'ROADMAP.md Queue 1 "Other model families"'
_DISTRIBUTED = 'ROADMAP.md Queue 1 "Distributed"'
_QUANT = 'ROADMAP.md Queue 1 "Quantization"'


def _require_served(cfg, kv_quant: Optional[str] = None) -> None:
    """Raise for every configuration the port does not serve: it serves the
    dense and MoE families, with GQA or MLA attention; quantized weights or
    an int8 KV pool (``kv_quant``, default ``cfg.kv_quant``) only for the
    dense family with GQA."""
    missing = []
    if cfg.ssm_state or cfg.attn_every or cfg.family not in ("dense", "moe"):
        missing.append(f"the {cfg.family} family ({_FAMILIES})")
    if cfg.tie_embeddings or cfg.frontend != "none":
        missing.append(f"tied embeddings / stub frontends ({_FAMILIES})")
    if cfg.sharding != "gspmd":
        missing.append(f"sharding plans ({_DISTRIBUTED})")
    kvq = cfg.kv_quant if kv_quant is None else kv_quant
    if (cfg.is_moe or cfg.use_mla) and (cfg.quantization != "none" or kvq != "none"):
        missing.append(f"quantized weights or KV pools for MoE / MLA ({_QUANT})")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: " + "; ".join(missing))


def _require_trainable(cfg) -> None:
    """Training is ported for the dense family with GQA only."""
    _require_served(cfg)
    if cfg.is_moe or cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: training the MoE and MLA families (router aux loss, "
                                  f"gradients through the routing) is not ported yet ({_FAMILIES})")


def _no_plan(plan, constrain) -> None:
    if plan is not None or constrain is not None:
        raise NotImplementedError(f"sharding plans and constrain hooks are not ported yet ({_DISTRIBUTED})")


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
    hd = cfg.resolved_head_dim
    shape, fan, dip = _lin(cfg, d, v)
    t: Dict[str, Any] = {
        "embed": ((v, d), pdt, d, None),
        "final_norm": ((d,), pdt, None, None),
        "lm_head": (shape, pdt, fan, dip),
    }
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


def quantize_params(params: Dict[str, Any], scheme: str) -> Dict[str, Any]:
    """Quantize every DiP-stored projection to ``scheme`` storage (the
    offline calibration step: once at init or load, never per forward).
    Embeddings and norms stay float; quantized nodes pass through."""
    def q(t):
        if isinstance(t, dict):
            return {k: q(v) for k, v in t.items()}
        return api.quant.quantize(t, scheme) if isinstance(t, (api.DipWeight, api.QuantizedDipWeight)) else t

    return q(params)


def init_params(cfg, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Materialize parameters on ``device`` from ``generator``: truncated
    normal (-2, 2) scaled by fan_in^-1/2, norms at 1, biases at 0.  DiP
    weights are drawn in natural layout one matrix at a time and permutated
    on the device (the offline step of paper Fig. 3); under
    ``cfg.quantization`` each matrix is quantized as it is drawn, so no
    float copy of the whole model is ever held.  Plain layer-stacked leaves
    (the MoE router and expert banks) are drawn one layer at a time, so the
    f32 draw never holds more than one layer's bank."""
    dev = resolve_device(device)
    scheme = cfg.quant_scheme
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters go to {dev}")

    def normal(shape, scale, dt):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (t * scale).to(dt)

    def make(name, shape, dt, fan, dip):
        dt = dtype_of(dt)
        if fan is None:
            init = torch.zeros if name in ("bq", "bk", "bv") else torch.ones
            return init(shape, dtype=dt, device=dev)
        scale = (1.0 / max(1, fan)) ** 0.5
        if dip is None and len(shape) > 2:
            data = torch.empty(shape, dtype=dt, device=dev)
            for layer in data:
                layer.copy_(normal(tuple(shape[1:]), scale, dt))
            return data
        if dip is None:
            return normal(shape, scale, dt)
        d_in, d_out, perm_tile = dip
        if scheme is not None:
            info = api.quant.scheme_info(scheme)
            data = torch.empty(shape, dtype=info.storage_dtype, device=dev)
            scales = torch.empty(tuple(shape[:-2]) + (1, shape[-1]), dtype=torch.float32, device=dev)
            for mat, sc in zip(data.view((-1,) + tuple(shape[-2:])), scales.view((-1, 1, shape[-1]))):
                qw = api.quant.quantize(normal((d_in, d_out), scale, dt), scheme, perm_tile=perm_tile)
                mat.copy_(qw.data)
                sc.copy_(qw.scale)
            return api.QuantizedDipWeight(data, scales, d_in, d_out, perm_tile, scheme)
        data = torch.empty(shape, dtype=dt, device=dev)
        for mat in data.view((-1,) + tuple(shape[-2:])):
            mat.copy_(permute.permute_tiled(normal((d_in, d_out), scale, dt), perm_tile))
        return api.DipWeight(data, d_in, d_out, perm_tile)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else make(k, *v) for k, v in t.items()}

    return build(param_template(cfg))


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


def _ffn(x, lp, cfg, fuse, moe_trace):
    """The block's FFN with its skip connection.  The MoE layer keeps the
    explicit ``ffn_norm`` (the router and every expert read the normed
    stream) and the explicit ``x + f``; ``moe_trace``, if given, collects
    each layer's aux loss, dropped count and (B, S, k) expert ids, and where
    it holds ``replay_ids`` (one (B, S, k) tensor per layer, from another
    run's trace) each layer routes with those instead of its own top-k."""
    if cfg.is_moe:
        ffn_in = layers.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        if moe_trace is None:
            return x + moe.moe_ffn(ffn_in, lp, cfg)[0]
        replay = moe_trace.get("replay_ids")
        f, aux, dropped, ids = moe.moe_ffn(ffn_in, lp, cfg, return_routing=True, route_ids=None if replay is None
                                           else replay[len(moe_trace.get("ids", []))])
        for key, val in (("aux", aux), ("dropped", dropped), ("ids", ids)):
            moe_trace.setdefault(key, []).append(val)
        return x + f
    ffn_in, ffn_g = (x, lp["ffn_norm"]) if fuse else (
        layers.rms_norm(x, lp["ffn_norm"], cfg.norm_eps), None)
    return moe.dense_ffn(ffn_in, lp, cfg, residual=x, norm=ffn_g)


def _transformer_block(x, lp, cfg, *, positions, rope, cache, kv_chunk=0, attn_backend=None,
                       moe_trace=None):
    fuse = _fuses_rmsnorm(cfg)
    attn_in, attn_g = (x, lp["attn_norm"]) if fuse else (
        layers.rms_norm(x, lp["attn_norm"], cfg.norm_eps), None)
    attn = attention.mla_attention if cfg.use_mla else attention.gqa_attention
    x, new_cache = attn(
        attn_in, lp, cfg, positions=positions, cache=cache, rope=rope, residual=x,
        norm=attn_g, kv_chunk=kv_chunk, attn_backend=attn_backend,
    )
    return _ffn(x, lp, cfg, fuse, moe_trace), new_cache


def _head(params, cfg, x):
    """The lm_head through ``linear`` on final-normed x, padded-vocab lanes
    masked to -1e30."""
    cd = dtype_of(cfg.compute_dtype)
    logits = layers.linear(x, params["lm_head"], backend=cfg.matmul_backend,
                           compute_dtype=cd).float()
    if cfg.padded_vocab != cfg.vocab_size:
        lane = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(lane >= cfg.vocab_size, -1e30)
    return logits


def forward(params: Dict[str, Any], cfg, *, tokens: torch.Tensor, cache: Optional[Dict] = None,
            kv_chunk: int = 0, return_hidden: bool = False, attn_backend: Optional[str] = None,
            moe_trace: Optional[Dict] = None):
    """Returns ``(logits, new_cache)`` for tokens (B, S).

    ``cache`` (``init_cache``) is updated in place at ``cache["pos"]`` and
    returned with ``pos`` advanced by S.  ``attn_backend="flash"`` routes
    attention through the CUDA kernel (serving prefill; forward only);
    ``kv_chunk > 0`` takes the KV-chunked online-softmax attention; MLA
    with a cache takes its absorbed form and ignores both, as the
    reference does.  ``moe_trace`` (a dict) collects each MoE layer's
    ``aux`` loss, ``dropped`` count and expert ``ids``, as lists in layer
    order; given ``replay_ids`` (a list of one run's ``ids``), every layer
    routes as that run did.
    ``return_hidden=True`` skips the lm_head and returns the final-normed
    hidden states (B, S, d) in the compute dtype, for the fused loss.  With
    ``cfg.remat == "block"``, no cache and grad mode on, each block runs
    under ``torch.utils.checkpoint`` and its forward runs again in the
    backward.
    """
    _require_served(cfg)
    cd = dtype_of(cfg.compute_dtype)
    x = F.embedding(tokens, params["embed"]).to(cd)
    b, s = x.shape[:2]
    start = cache["pos"] if cache is not None else 0
    positions = torch.arange(start, start + s, device=x.device)
    rope = layers.rope_tables(positions, _rope_dim(cfg), cfg.rope_theta)
    remat = cfg.remat == "block" and cache is None and torch.is_grad_enabled()
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        lcache = None if cache is None else dict(
            {nm: t[i] for nm, t in cache["layers"].items()}, pos=start)

        def block(x, lp=lp, lcache=lcache):
            return _transformer_block(x, lp, cfg, positions=positions, rope=rope, cache=lcache,
                                      kv_chunk=kv_chunk, attn_backend=attn_backend,
                                      moe_trace=moe_trace)[0]

        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
    new_cache = None if cache is None else dict(cache, pos=start + s)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x if return_hidden else _head(params, cfg, x)), new_cache


# ------------------------------------------------------------------ caches --
def init_cache(cfg, batch: int, max_seq: int, *, device) -> Dict[str, Any]:
    """Layer-stacked dense decode cache: k/v (L, B, max_seq, KV, hd), or
    under MLA the latent c_kv (L, B, max_seq, kv_lora_rank) and the shared
    k_rope (L, B, max_seq, rope)."""
    _require_served(cfg)
    cd, L = dtype_of(cfg.compute_dtype), cfg.n_layers
    if cfg.use_mla:
        shapes = {"c_kv": (L, batch, max_seq, cfg.kv_lora_rank),
                  "k_rope": (L, batch, max_seq, cfg.qk_rope_head_dim)}
    else:
        shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": shape, "v": shape}
    return {"layers": {nm: torch.zeros(sh, dtype=cd, device=device) for nm, sh in shapes.items()}, "pos": 0}


def init_paged_cache(cfg, num_blocks: int, block_size: int, *, kv_quant: str = "none",
                     device) -> Dict[str, Any]:
    """Layer-stacked paged pools for the serving engine: k/v (L, num_blocks,
    block_size, KV, hd), and under int8 ``kv_quant`` their per-(token, head)
    f32 scales k_scale/v_scale (L, num_blocks, block_size, KV); under MLA
    the latent c_kv (L, num_blocks, block_size, kv_lora_rank) and k_rope
    (L, num_blocks, block_size, rope).  Block 0 is the null block
    (serving/kv_cache.py).  The attention families keep nothing per slot,
    so unlike the reference this takes no ``slots``."""
    _require_served(cfg, kv_quant)
    cd = dtype_of(cfg.compute_dtype)
    if cfg.use_mla:
        pool = attention.init_paged_mla_cache(num_blocks, block_size, cfg, cd, kv_quant, device=device)
    else:
        pool = attention.init_paged_gqa_cache(
            num_blocks, block_size, cfg.n_kv_heads, cfg.resolved_head_dim, cd, kv_quant, device=device)
    return {"layers": {nm: t.expand((cfg.n_layers,) + tuple(t.shape)).clone()
                       for nm, t in pool.items()}}


def decode_step_fn(cfg, *, attn_backend: Optional[str] = None):
    """Returns ``step(params, cache, tokens) -> (logits, cache)``; with
    ``attn_backend="flash"`` it is the engine's chunked-prefill step.
    ``moe_trace`` as in :func:`forward`."""

    def step(params, cache, tokens, moe_trace=None):
        return forward(params, cfg, tokens=tokens, cache=cache, attn_backend=attn_backend, moe_trace=moe_trace)

    return step


def paged_decode_step_fn(cfg):
    """Returns ``step(params, cache, tokens, positions, block_tables) ->
    (logits, cache)``, the engine's decode step: tokens (slots, 1),
    positions (slots,), block_tables (slots, blocks_per_seq), all integer
    tensors on the parameters' device; the pools are updated in place.
    ``moe_trace`` as in :func:`forward`."""
    _require_served(cfg)
    attn = attention.paged_mla_attention if cfg.use_mla else attention.paged_gqa_attention

    def step(params, cache, tokens, positions, block_tables, moe_trace=None):
        cd = dtype_of(cfg.compute_dtype)
        x = params["embed"][tokens].to(cd)
        rope = layers.rope_tables(positions[:, None], _rope_dim(cfg), cfg.rope_theta)
        fuse = _fuses_rmsnorm(cfg)
        pools = cache["layers"]
        for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
            attn_in, attn_g = (x, lp["attn_norm"]) if fuse else (
                layers.rms_norm(x, lp["attn_norm"], cfg.norm_eps), None)
            x, _ = attn(
                attn_in, lp, cfg, positions=positions,
                cache={nm: pool[i] for nm, pool in pools.items()}, block_tables=block_tables,
                kv_quant=cfg.kv_quant, rope=rope, residual=x, norm=attn_g,
            )
            x = _ffn(x, lp, cfg, fuse, moe_trace)
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _head(params, cfg, x), cache

    return step


# ------------------------------------------------------------- objectives ---
def _natural_head(params, cfg) -> torch.Tensor:
    """The lm_head as a natural (d_model, padded_vocab) tensor in the
    parameter dtype, for the fused loss (a ``DipWeight`` is de-sheared, so a
    gradient reaches its permutated storage)."""
    if cfg.tie_embeddings:
        raise NotImplementedError(f"tied embeddings are not ported yet ({_FAMILIES})")
    head = params["lm_head"]
    return head.to_natural() if isinstance(head, api.DipWeight) else head


def loss_fn(params, cfg, batch, *, kv_chunk: int = 0, fused_ce: Optional[bool] = None,
            plan=None, constrain=None) -> torch.Tensor:
    """Next-token cross entropy.  ``batch["loss_mask"]`` (optional, (B, S),
    nonzero = train on this position) and the -100 ``ignore_index`` in
    ``labels`` both exclude tokens from the mean and the gradient.

    ``fused_ce=None`` selects the fused lm_head + cross-entropy kernel, as
    the reference does when no sharding plan or constrain hook needs the
    logits (neither is ported): the (B, S, V) logits are then never formed.
    ``False`` forces the unfused path through the lm_head projection."""
    _no_plan(plan, constrain)
    _require_trainable(cfg)
    mask = batch.get("loss_mask")
    shift_mask = None if mask is None else mask[:, 1:]
    if fused_ce is None or fused_ce:
        hidden, _ = forward(params, cfg, tokens=batch["tokens"], kv_chunk=kv_chunk,
                            return_hidden=True)
        return lm_head_ce.fused_cross_entropy_loss(
            hidden[:, :-1], _natural_head(params, cfg), batch["labels"][:, 1:], mask=shift_mask,
            vocab_size=cfg.vocab_size)
    logits, _ = forward(params, cfg, tokens=batch["tokens"], kv_chunk=kv_chunk)
    return layers.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:], mask=shift_mask)


def train_step_fn(cfg, optimizer, *, kv_chunk: int = 0, microbatch: int = 1,
                  fused_ce: Optional[bool] = None, guard: bool = False, plan=None,
                  constrain=None):
    """Returns ``step(state, batch) -> (state, metrics)`` for ``state =
    {"params", "opt_state", "step"}`` and a batch of (B, S) ``tokens`` /
    ``labels`` tensors on the parameters' device.

    The gradients are taken with ``torch.autograd.grad`` over every
    parameter leaf (a ``DipWeight``'s permutated ``data``); the optimizer
    then updates the parameters and its moments IN PLACE, so the returned
    state holds the same tensors.  ``microbatch > 1`` splits the batch into
    that many slices, sums their losses and gradients and scales both by
    1/microbatch, as the reference's scan does.  Metrics: ``loss``,
    ``grad_norm`` (pre-clip) and ``step``, as 0-d tensors / int."""
    if guard:
        raise NotImplementedError(
            'the reliability guard is not ported yet (ROADMAP.md Queue 1 "Reliability")')
    _no_plan(plan, constrain)
    _require_trainable(cfg)

    def grad_of(leaves, params, batch):
        loss = loss_fn(params, cfg, batch, kv_chunk=kv_chunk, fused_ce=fused_ce)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def step(state, batch):
        params = state["params"]
        leaves = tree.leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        if microbatch <= 1:
            loss, flat = grad_of(leaves, params, batch)
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
        grads = tree.unflatten(params, flat)
        params, opt_state = optimizer.update(grads, state["opt_state"], params)
        new_state = {"params": params, "opt_state": opt_state, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": optimizer.last_grad_norm(opt_state),
                           "step": new_state["step"]}

    return step
