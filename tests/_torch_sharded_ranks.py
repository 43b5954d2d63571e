"""Rank-side bodies of the sharded tests: torch and the port only (no JAX),
imported by the ranks that ``distributed.run_world`` spawns.

Each body takes numpy inputs, runs the port on this rank's slice and returns
numpy outputs with the communicator's log; the test process holds them
against the reference.
"""

import dataclasses

import numpy as np
import torch

BACKENDS = {"tp_col": ("dip_tp", "column"), "tp_row": ("dip_tp", "row"), "fsdp": ("dip_fsdp", "column"),
            "sp_col": ("dip_sp", "column"), "sp_row": ("dip_sp", "row")}


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def local_inputs(path, mesh, x, resid):
    """This rank's x and residual under ``path`` (the backends' module doc):
    tp column whole; tp row and sp row x's K slice; fsdp the data rank's
    rows; sp column x's rows of the model rank; the residual with the
    output's rows on this rank."""
    tp, me = mesh.shape["model"], mesh.coord("model")
    dn, d = mesh.shape["data"], mesh.coord("data")
    m, k = x.shape
    if path == "tp_col":
        return x, resid
    if path == "tp_row":
        kl = k // tp
        return x[:, me * kl:(me + 1) * kl], resid
    if path == "fsdp":
        ml = m // dn
        rows = slice(d * ml, (d + 1) * ml)
        return x[rows], None if resid is None else resid[rows]
    ml = m // tp
    rows = slice(me * ml, (me + 1) * ml)
    if path == "sp_col":
        return x[rows], resid
    kl = k // tp
    return x[:, me * kl:(me + 1) * kl], None if resid is None else resid[rows]


def run_case(case, meshes):
    """One sharded dispatch: ``case`` holds path, mesh, epilogue, dtype,
    scheme, x, the natural weights, bias, residual and gain (numpy)."""
    from repro_torch import api
    from repro_torch.distributed import WeightPlan, comm, shard_weight

    mesh = meshes[case["mesh"]]
    backend, kind = BACKENDS[case["path"]]
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[case["dtype"]]
    x = _t(case["x"], dt)
    ws = [_t(w, dt) for w in case["ws"]]
    full = [api.DipWeight.from_natural(w) for w in ws]
    if case.get("scheme"):
        full = [api.quant.quantize(w.to_natural().float(), case["scheme"]) for w in full]
    plan = WeightPlan(kind, axis="model", fsdp="data", mesh=mesh)
    loc = [shard_weight(w, plan, along="fsdp" if backend == "dip_fsdp" else "tp") for w in full]
    resid = None if case.get("resid") is None else _t(case["resid"], dt)
    xl, rl = local_inputs(case["path"], mesh, x, resid)
    ops = ()
    if case.get("bias") is not None:
        ops = (torch.from_numpy(case["bias"]),)
    elif rl is not None:
        ops = (rl,)
    pro = {}
    if case.get("gain") is not None:
        pro = dict(prologue="rmsnorm", prologue_operands=(torch.from_numpy(case["gain"]),))
    comm.reset(schedule=True)
    out = api.matmul(xl, tuple(loc) if len(loc) == 2 else loc[0], backend=backend, epilogue=case["epilogue"],
                     epilogue_operands=ops, **pro)
    return _np(out), comm.counts(), comm.schedule(), str(out.dtype)


def matmul_rank(rank, cases):
    """Every case on this rank, against the meshes of a 4-rank world:
    ``m4`` (data 1, model 4), ``f4`` (data 4, model 1) and ``m22`` (data 2,
    model 2)."""
    from repro_torch.distributed import make_local_mesh

    meshes = {"m4": make_local_mesh(data=1, model=4), "f4": make_local_mesh(data=4, model=1),
              "m22": make_local_mesh(data=2, model=2)}
    coords = {name: (m.coord("data"), m.coord("model")) for name, m in meshes.items()}
    return coords, [run_case(c, meshes) for c in cases]


def _serving_cfg(cfg_fields):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig

    if "arch" in cfg_fields:
        fields = dict(cfg_fields)
        return dataclasses.replace(get_config(fields.pop("arch")).reduced(), **fields)
    return ArchConfig(**cfg_fields)


def serving_rank(rank, tiny, tiny_params, tiny_tokens, reduced, reduced_params, prompts, max_new):
    """A 2-rank tensor-parallel world: the tiny dense forward through
    ``dip_tp`` on the converted reference parameters (logits, and the
    collectives of one forward), then the reduced llama3-8b ``Engine``
    (tokens, and the collectives of one decode step)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig, SamplingParams

    mesh = make_local_mesh(data=1, model=2)
    out = {}
    cfg = _serving_cfg(tiny)
    plan = make_plan(mesh, cfg, "train")
    params = plan.shard_params(params_from_jax(tiny_params, cfg, device="cpu"))
    out["kinds"] = {k: params["layers"][k].plan.kind for k in ("wq", "wk", "wo", "w_gate", "w_down")}
    comm.reset()
    logits, _ = tf_model.forward(params, cfg, tokens=torch.from_numpy(tiny_tokens), plan=plan)
    out["tiny_logits"], out["tiny_counts"] = _np(logits), comm.counts()

    cfg = _serving_cfg(reduced)
    plan = make_plan(mesh, cfg, "decode")
    eng = Engine(cfg, params_from_jax(reduced_params, cfg, device="cpu"),
                 engine_cfg=EngineConfig(slots=2, max_seq=32, prefill_chunk=8), device="cpu", plan=plan)
    for rid, p in enumerate(prompts):
        eng.add_request(p, SamplingParams(max_new_tokens=max_new), rid=rid)
    out["tokens"] = eng.run()
    out["captured"], out["eager_reason"] = eng.captured, eng.eager_reason
    out["pool_heads"] = int(eng.kv.pools["layers"]["k"].shape[3])
    comm.reset()
    s = eng.ecfg.slots
    eng._decode(eng.params, eng.kv.pools, torch.full((s, 1), 5), torch.arange(s), torch.as_tensor(
        eng.kv.block_tables, dtype=torch.long))
    out["decode_counts"] = comm.counts()
    return out


def sleep_rank(rank, seconds):
    """A rank that outlives its world's timeout."""
    import time

    time.sleep(seconds)


def fail_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 stops here")
    return rank


def cuda_rank(rank, transport, cases):
    """The card's side of ``test_torch_cuda_sharded.py``: each case through
    its sharded backend on this rank's card (``host``: every rank on card 0;
    ``nccl``: card ``rank``), beside the single-rank dispatch of the whole
    weight on the same card; for the row paths this rank's partial launch
    (f32 store for bf16 x) with the plain version of it on the same card
    inputs, and each held launch's kernel count."""
    from repro_torch import api
    from repro_torch.distributed import WeightPlan, comm, make_local_mesh, shard_weight
    from repro_torch.kernels.dip_matmul import dip_matmul, dip_matmul_plain
    from repro_torch.kernels.dip_matmul_q import dip_matmul_q, dip_matmul_q_plain

    world = torch.distributed.get_world_size()
    dev = torch.device("cuda", 0 if transport == "host" else rank)
    meshes = {"m": make_local_mesh(data=1, model=world, transport=transport, device=dev),
              "f": make_local_mesh(data=world, model=1, transport=transport, device=dev)}
    out = []
    for case in cases:
        mesh = meshes["f" if case["path"] == "fsdp" else "m"]
        backend, kind = BACKENDS[case["path"]]
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[case["dtype"]]
        x = _t(case["x"], dt).to(dev)
        full = [api.DipWeight.from_natural(_t(w, dt).to(dev)) for w in case["ws"]]
        if case.get("scheme"):
            full = [api.quant.quantize(w.to_natural().float(), case["scheme"]) for w in full]
        plan = WeightPlan(kind, axis="model", fsdp="data", mesh=mesh)
        loc = [shard_weight(w, plan, along="fsdp" if backend == "dip_fsdp" else "tp") for w in full]
        resid = None if case.get("resid") is None else _t(case["resid"], dt).to(dev)
        xl, rl = local_inputs(case["path"], mesh, x, resid)
        ops = (torch.from_numpy(case["bias"]).to(dev),) if case.get("bias") is not None else (
            (rl,) if rl is not None else ())
        launches = dip_matmul.launches + dip_matmul_q.launches
        comm.reset()
        got = api.matmul(xl, tuple(loc) if len(loc) == 2 else loc[0], backend=backend, epilogue=case["epilogue"],
                         epilogue_operands=ops)
        torch.cuda.synchronize(dev)
        counted = dip_matmul.launches + dip_matmul_q.launches - launches
        single_ops = (torch.from_numpy(case["bias"]).to(dev),) if case.get("bias") is not None else (
            (resid,) if resid is not None else ())
        single = api.matmul(x, tuple(full) if len(full) == 2 else full[0],
                            backend=None if case.get("scheme") else "dip", epilogue=case["epilogue"],
                            epilogue_operands=single_ops)
        partial = None
        if kind == "row":
            f32 = torch.float32 if dt == torch.bfloat16 else None
            xs, w = xl.contiguous(), loc[0]
            before = dip_matmul.launches + dip_matmul_q.launches
            if case.get("scheme"):
                pair = (dip_matmul_q(xs, w.data, w.scale, out_dtype=f32),
                        dip_matmul_q_plain(xs, w.data, w.scale, out_dtype=f32))
            else:
                pair = (dip_matmul(xs, w.data, out_dtype=f32), dip_matmul_plain(xs, w.data, out_dtype=f32))
            torch.cuda.synchronize(dev)
            partial = (_np(pair[0]), _np(pair[1]), str(pair[0].dtype),
                       dip_matmul.launches + dip_matmul_q.launches - before)
        out.append((_np(got.cpu()), _np(single.cpu()), comm.counts(), counted, partial))
    return out


def _layer0(lyr):
    from repro_torch import api

    return {k: v.with_data(v.data[0]) if isinstance(v, api.DipWeight) else v[0] for k, v in lyr.items()}


def moe_rank(rank, layer_cases, engine_cases):
    """A 2-rank world (data 1, model 2) for ``test_torch_sharded_moe.py``:
    each layer case is ``moe_ffn`` under its plan on layer 0 of the
    converted reference parameters (out, aux, dropped, the rank's expert
    ids, the communicator's counts and schedule of the call); each engine
    case the reduced model's ``Engine(plan=)`` (tokens, a decode step's
    collectives, the pools' shapes and ``bytes_per_block``)."""
    import warnings

    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.models import moe
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    from repro_torch.serving import kv_cache as kvc

    warnings.simplefilter("ignore", UserWarning)  # the reduced widths replicate (announced once)
    mesh = make_local_mesh(data=1, model=2)
    layers_out = {}
    for case in layer_cases:
        cfg = _serving_cfg(case["cfg"])
        plan = make_plan(mesh, cfg, "train")
        lp = _layer0(plan.shard_params(params_from_jax(case["params"], cfg, device="cpu"))["layers"])
        comm.reset(schedule=True)
        out, aux, dropped, ids = moe.moe_ffn(torch.from_numpy(case["x"]), lp, cfg, plan=plan, return_routing=True)
        layers_out[case["name"]] = dict(out=_np(out), aux=float(aux), dropped=int(dropped), ids=_np(ids),
                                        counts=comm.counts(), schedule=comm.schedule(),
                                        experts=int(lp["w_gate"].shape[0]),
                                        expert_plan=None if plan.expert_plan is None else plan.expert_plan.kind)
    engines_out = {}
    for case in engine_cases:
        cfg = _serving_cfg(case["cfg"])
        plan = make_plan(mesh, cfg, "decode")
        eng = Engine(cfg, params_from_jax(case["params"], cfg, device="cpu"),
                     engine_cfg=EngineConfig(slots=2, max_seq=32, prefill_chunk=8), device="cpu", plan=plan)
        for rid, p in enumerate(case["prompts"]):
            eng.add_request(p, SamplingParams(max_new_tokens=case["max_new"]), rid=rid)
        rec = {"tokens": eng.run(), "captured": eng.captured,
               "pools": {k: tuple(v.shape) for k, v in eng.kv.pools["layers"].items()},
               "bytes_per_block": kvc.bytes_per_block(cfg, eng.block_size, plan=plan),
               "experts": int(eng.params["layers"]["w_gate"].shape[1])}
        comm.reset()
        s = eng.ecfg.slots
        eng._decode(eng.params, eng.kv.pools, torch.full((s, 1), 5), torch.arange(s),
                    torch.as_tensor(eng.kv.block_tables, dtype=torch.long))
        rec["decode_counts"] = comm.counts()
        engines_out[case["name"]] = rec
    return layers_out, engines_out


def _engine_run(eng, prompts, max_new):
    from repro_torch.serving import SamplingParams

    for rid, p in enumerate(prompts):
        eng.add_request(p, SamplingParams(max_new_tokens=max_new), rid=rid)
    return eng.run()


def _decode_counts(eng):
    """The communicator's counts of one paged decode step of ``eng``."""
    from repro_torch.distributed import comm

    comm.reset()
    s = eng.ecfg.slots
    eng._decode(eng.params, eng.kv.pools, torch.full((s, 1), 5), torch.arange(s),
                torch.as_tensor(eng.kv.block_tables, dtype=torch.long))
    return comm.counts()


def _storage_shapes(params):
    """Every DiP leaf's storage shape and plan, by path."""
    from repro_torch import api

    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, api.DipWeight):
            out["/".join(path)] = (tuple(t.data.shape), t.plan.kind, t.plan.axis, t.plan.fsdp)
        elif isinstance(t, torch.Tensor):
            out["/".join(path)] = (tuple(t.shape), None, None, None)

    walk(params, ())
    return out


def sharded_model_rank(rank, strategy, cases):
    """A 2-rank world for ``test_torch_sharded_ssm.py`` (``tp``: data 1,
    model 2) and ``test_torch_sharded_fsdp.py`` (``fsdp``: data 2, model
    1).  Each case runs on the converted reference parameters: layer 0's
    Mamba2 block (a chunked prefill into a cache, then one O(1) decode
    token) where the case gives ``x``; ``forward`` on each of its token
    batches (logits and counts); the ``Engine`` (tokens, one decode step's
    counts, the pools' shapes); the rank's leaves; and the same parameters
    drawn from a seed on the rank alone (``init_params(plan=)``) against
    ``shard_params`` of the whole draw."""
    import warnings

    from repro_torch import tree
    from repro_torch.convert import params_from_jax
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig

    warnings.simplefilter("ignore", UserWarning)  # the reduced widths replicate (announced once)
    mesh = make_local_mesh(data=1, model=2) if strategy == "tp" else make_local_mesh(data=2, model=1)
    out = {}
    for case in cases:
        cfg = _serving_cfg(case["cfg"])
        plan = make_plan(mesh, cfg, "decode")
        params = plan.shard_params(params_from_jax(case["params"], cfg, device="cpu"))
        rec = {"leaves": _storage_shapes(params), "ssm_heads": plan.ssm_heads() if cfg.ssm_state else None}
        if case.get("x") is not None:
            lp = _layer0(params["layers"])
            x = torch.from_numpy(case["x"])
            cache = ssm.init_ssm_cache(x.shape[0], cfg, torch.float32, device="cpu", plan=plan)
            comm.reset()
            y0, c0 = ssm.ssd_block(x[:, :-1], lp, cfg, cache=cache, plan=plan)
            rec["block_counts"] = comm.counts()
            y1, c1 = ssm.ssd_block(x[:, -1:], lp, cfg, cache=c0, plan=plan)
            rec["block"] = {"chunk out": _np(y0), "chunk state": _np(c0["state"]), "chunk conv": _np(c0["conv"]),
                            "decode out": _np(y1), "decode state": _np(c1["state"]), "decode conv": _np(c1["conv"])}
        rec["forward"] = []
        for toks in case["tokens"]:
            comm.reset()
            logits, _ = tf_model.forward(params, cfg, tokens=torch.from_numpy(toks), plan=plan)
            rec["forward"].append((_np(logits), comm.counts()))
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=2, max_seq=32, prefill_chunk=8), device="cpu",
                     plan=plan)
        rec["tokens"] = _engine_run(eng, case["prompts"], case["max_new"])
        rec["prefill_chunks"] = eng.last_stats["prefill_chunks"]
        rec["pools"] = {k: tuple(v.shape) for k, v in eng.kv.pools["layers"].items() if k != "attn"}
        rec["attn_pools"] = {k: tuple(v.shape) for k, v in eng.kv.pools["layers"].get("attn", {}).items()}
        rec["decode_counts"] = _decode_counts(eng)
        drawn = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu", plan=plan)
        whole = plan.shard_params(tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu"))
        rec["draw_equal"] = all(torch.equal(a, b) for a, b in zip(tree.leaves(drawn), tree.leaves(whole))) and \
            _storage_shapes(drawn) == _storage_shapes(whole)
        out[case["name"]] = rec
    return out


def _own_rows_of(rows, a):
    """This rank's rows (m, .) of a whole (B, S, .) numpy batch under the
    ``sp`` layout ``rows``."""
    return rows.own(torch.from_numpy(np.asarray(a, np.float32)))


def sp_model_rank(rank, cases):
    """A 2-rank world (data 1, model 2) for ``test_torch_sharded_sp.py``.
    Each case runs under its ``sp`` plan on the converted reference
    parameters: layer 0's block on the rank's rows of ``x`` (the Mamba2
    block: a chunked prefill into a cache, then one O(1) decode token; the
    dense block: one chunk with no cache, its schedule recorded), then
    ``forward`` on each token batch, then the ``Engine`` (tokens, the
    counts of one decode step, the pools); where the case asks, the rank's
    own draw against its slice of the whole draw."""
    import warnings

    from repro_torch import tree
    from repro_torch.convert import params_from_jax
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.models import layers, ssm
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig

    warnings.simplefilter("ignore", UserWarning)  # the reduced widths replicate (announced once)
    mesh = make_local_mesh(data=1, model=2)
    out = {}
    for case in cases:
        cfg = _serving_cfg(case["cfg"])
        plan = make_plan(mesh, cfg, "decode")
        params = plan.shard_params(params_from_jax(case["params"], cfg, device="cpu"))
        rec = {"leaves": _storage_shapes(params)}
        x = case.get("x")
        if x is not None and cfg.ssm_state:
            lp = _layer0(params["layers"])
            b, s = x.shape[0], x.shape[1] - 1
            chunk, step = layers.SeqRows(plan, b, s), layers.SeqRows(plan, b, 1)
            cache = ssm.init_ssm_cache(b, cfg, torch.float32, device="cpu", plan=plan)
            comm.reset(schedule=True)
            y0, c0 = ssm.ssd_block(_own_rows_of(chunk, x[:, :-1]), lp, cfg, cache=cache, plan=plan, rows=chunk)
            rec["block_counts"], rec["block_schedule"] = comm.counts(), comm.schedule()
            y1, c1 = ssm.ssd_block(_own_rows_of(step, x[:, -1:]), lp, cfg, cache=c0, plan=plan, rows=step)
            rec["block"] = {"chunk out": _np(y0), "chunk state": _np(c0["state"]), "chunk conv": _np(c0["conv"]),
                            "decode out": _np(y1), "decode state": _np(c1["state"]), "decode conv": _np(c1["conv"])}
        elif x is not None:
            lp = _layer0(params["layers"])
            b, s = x.shape[:2]
            rows = layers.SeqRows(plan, b, s)
            pos = torch.arange(s)
            rope = layers.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
            comm.reset(schedule=True)
            y, _, _ = tf_model._transformer_block(_own_rows_of(rows, x), lp, cfg, positions=pos, rope=rope,
                                                  cache=None, plan=plan, rows=rows)
            rec["block_counts"], rec["block_schedule"] = comm.counts(), comm.schedule()
            rec["block"] = {"out": _np(y)}
        rec["forward"] = []
        for toks in case["tokens"]:
            comm.reset()
            logits, _ = tf_model.forward(params, cfg, tokens=torch.from_numpy(toks), plan=plan)
            rec["forward"].append((_np(logits), comm.counts(), comm.replicated()))
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=2, max_seq=32, prefill_chunk=8), device="cpu",
                     plan=plan)
        rec["tokens"] = _engine_run(eng, case["prompts"], case["max_new"])
        rec["prefill_chunks"] = eng.last_stats["prefill_chunks"]
        rec["pools"] = {k: tuple(v.shape) for k, v in eng.kv.pools["layers"].items() if k != "attn"}
        rec["attn_pools"] = {k: tuple(v.shape) for k, v in eng.kv.pools["layers"].get("attn", {}).items()}
        rec["decode_counts"] = _decode_counts(eng)
        if case.get("draw"):
            drawn = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu", plan=plan)
            whole = plan.shard_params(tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu"))
            rec["draw_equal"] = all(torch.equal(a, b) for a, b in zip(tree.leaves(drawn), tree.leaves(whole))) \
                and _storage_shapes(drawn) == _storage_shapes(whole)
        out[case["name"]] = rec
    return out


def moe_fsdp_rank(rank, layer_cases, cases):
    """A 2-rank world (data 2, model 1) for
    ``test_torch_sharded_moe_fsdp.py``.  Each layer case is layer 0's
    ``moe_ffn`` under its ``fsdp`` plan on this rank's sequence of ``x``
    (out, aux, dropped, ids, counts, schedule); each model case the rank's
    leaves, ``forward`` on each token batch, the ``Engine`` (tokens, one
    decode step's counts, the pools), the rank's draw against its slice of
    the whole draw, and the rank's slice through a checkpoint (restored
    into its own shapes; into the whole banks' it raises)."""
    import os
    import tempfile
    import warnings

    from repro_torch import tree
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.convert import params_from_jax
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf_model
    from repro_torch.serving import Engine, EngineConfig

    warnings.simplefilter("ignore", UserWarning)
    mesh = make_local_mesh(data=2, model=1)
    layers_out = {}
    for case in layer_cases:
        cfg = _serving_cfg(case["cfg"])
        plan = make_plan(mesh, cfg, "decode")
        lp = _layer0(plan.shard_params(params_from_jax(case["params"], cfg, device="cpu"))["layers"])
        x = torch.from_numpy(case["x"])
        n = x.shape[0] // 2
        comm.reset(schedule=True)
        o, aux, dropped, ids = moe.moe_ffn(x[rank * n:(rank + 1) * n], lp, cfg, plan=plan, return_routing=True)
        layers_out[case["name"]] = dict(out=_np(o), aux=float(aux), dropped=int(dropped), ids=_np(ids),
                                        counts=comm.counts(), schedule=comm.schedule(),
                                        banks={k: tuple(lp[k].shape) for k in ("router", "w_gate", "w_up",
                                                                               "w_down")})
    models_out = {}
    for case in cases:
        cfg = _serving_cfg(case["cfg"])
        plan = make_plan(mesh, cfg, "decode")
        whole = params_from_jax(case["params"], cfg, device="cpu")
        params = plan.shard_params(whole)
        rec = {"leaves": _storage_shapes(params), "forward": []}
        for toks in case["tokens"]:
            comm.reset()
            logits, _ = tf_model.forward(params, cfg, tokens=torch.from_numpy(toks), plan=plan)
            rec["forward"].append((_np(logits), comm.counts()))
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=2, max_seq=32, prefill_chunk=8), device="cpu",
                     plan=plan)
        rec["tokens"] = _engine_run(eng, case["prompts"], case["max_new"])
        rec["pools"] = {k: tuple(v.shape) for k, v in eng.kv.pools["layers"].items()}
        rec["decode_counts"] = _decode_counts(eng)
        drawn = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu", plan=plan)
        ref_draw = plan.shard_params(tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu"))
        rec["draw_equal"] = all(torch.equal(a, b) for a, b in zip(tree.leaves(drawn), tree.leaves(ref_draw))) \
            and _storage_shapes(drawn) == _storage_shapes(ref_draw)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "ck")
            save_pytree(path, params)
            got = restore_pytree(path, tree.unflatten(params, [torch.zeros_like(t) for t in tree.leaves(params)]))
            rec["restored_equal"] = all(torch.equal(a, b) for a, b in zip(tree.leaves(got), tree.leaves(params)))
            try:
                restore_pytree(path, dict(params, layers=dict(params["layers"], w_gate=whole["layers"]["w_gate"])))
                rec["whole_bank_restore"] = "restored"
            except ValueError as err:
                rec["whole_bank_restore"] = str(err)
        models_out[case["name"]] = rec
    return layers_out, models_out


def cuda_moe_fsdp_rank(rank, layers, tokens, seed):
    """The card's side of ``test_torch_cuda_sharded.py``'s DeepSeek-V2-Lite
    ``fsdp`` layer: a 2-rank world sharing card 0 (``host``); each rank
    draws the first ``layers`` layers at full width whole and, under the
    ``fsdp`` plan, only its slice (``init_params(plan=)``), then runs layer
    0's MoE on its sequence of a (2, ``tokens``) batch through the gathered
    banks beside the whole-bank layer on the whole batch."""
    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_local_mesh, make_plan
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf_model

    dev = torch.device("cuda", 0)
    mesh = make_local_mesh(data=2, model=1, transport="host", device=dev)
    base = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=layers, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    single = dataclasses.replace(base, matmul_backend="dip")
    fsdp = dataclasses.replace(base, matmul_backend="dip_fsdp", sharding="fsdp")
    plan = make_plan(mesh, fsdp, "decode")
    whole = _layer0(tf_model.init_params(single, make_generator(seed, dev), dev)["layers"])
    local = _layer0(tf_model.init_params(fsdp, make_generator(seed, dev), dev, plan=plan)["layers"])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((2, tokens, base.d_model), generator=gen, device=dev).to(torch.bfloat16)
    want, _, want_dropped, want_ids = moe.moe_ffn(x, whole, single, return_routing=True)
    comm.reset()
    got, _, dropped, ids = moe.moe_ffn(x[rank:rank + 1], local, fsdp, plan=plan, return_routing=True)
    torch.cuda.synchronize(dev)
    return {"got": _np(got), "want": _np(want[rank:rank + 1]), "ids_equal": bool(torch.equal(ids, want_ids[rank:rank + 1])),
            "dropped": int(dropped), "want_dropped": int(want_dropped), "counts": comm.counts(),
            "banks": {k: tuple(local[k].shape) for k in ("router", "w_gate", "w_up", "w_down")}}
