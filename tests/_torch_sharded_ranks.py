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


# ------------------------------------------------------------- training ---
def _seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32))


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _collective_case(name, mesh, dev="cpu"):
    """One differentiable collective as a rank uses it, and the single-rank
    function it computes on the whole inputs: the rank's gradients (the
    shares of a replicated input psummed) and the single-rank ones, as
    ``(got, want, counts of the backward)``."""
    from repro_torch.distributed import comm

    t, me, ax = mesh.shape["model"], mesh.coord("model"), "model"
    X = _seeded((t, 6, 4), 1).to(dev)
    R = _seeded((t, 6, 4), 2).to(dev)

    def single(fn):
        xw = X.clone().requires_grad_(True)
        return torch.autograd.grad(fn(xw), xw)[0][me]

    x = _leaf(X[me])
    if name == "psum":  # partial sums reduced, the result used whole by every rank
        loss = torch.sum(torch.sin(comm.psum(2 * x, mesh, ax)) * R[0])
        want = single(lambda xw: torch.sum(torch.sin((2 * xw).sum(0)) * R[0]))
    elif name == "psum_of_replicated":  # a replicated input into rank-specific work, then summed
        xr = _leaf(X[0])
        loss = torch.sum(torch.sin(comm.psum(xr * R[me], mesh, ax)))
        comm.reset()
        g = torch.autograd.grad(loss / t, xr)[0]
        counts = comm.counts()
        got = comm.psum(g, mesh, ax)  # a whole leaf's shares, summed after the backward
        xw = X[0].clone().requires_grad_(True)
        want = torch.autograd.grad(torch.sum(torch.sin((xw[None] * R).sum(0))), xw)[0]
        return _np(got), _np(want), counts
    elif name in ("all_gather_0", "all_gather_1"):  # the rank's block, the gathered whole used by every rank
        dim = int(name[-1])
        loss = torch.sum(torch.sin(comm.all_gather(x, mesh, ax, dim=dim)) * torch.cat(list(R), dim=dim))
        want = single(lambda xw: torch.sum(torch.sin(torch.cat(list(xw), dim=dim)) * torch.cat(list(R), dim=dim)))
    elif name == "psum_scatter":  # partial sums, each rank keeps its rows of the sum
        y = comm.psum_scatter(x, mesh, ax, dim=0)
        m = y.shape[0]
        loss = comm.psum(torch.sum(torch.sin(y) * R[0][me * m:(me + 1) * m]), mesh, ax)
        want = single(lambda xw: torch.sum(torch.sin(xw.sum(0)) * R[0]))
    elif name == "all_to_all":  # block j of dim 0 to rank j, concatenated on dim 1
        y = comm.all_to_all(x, mesh, ax, split_dim=0, concat_dim=1)

        def whole(xw):
            m = xw.shape[1] // t
            ys = [torch.cat([xw[j][r * m:(r + 1) * m] for j in range(t)], dim=1) for r in range(t)]
            return sum(torch.sum(torch.sin(ys[r]) * R[r][:m, :ys[r].shape[1]]) for r in range(t))

        R = torch.stack([_seeded((6 // t, 4 * t), 3 + r) for r in range(t)]).to(dev)
        loss = comm.psum(torch.sum(torch.sin(y) * R[me]), mesh, ax)
        want = single(whole)
    elif name == "hop":  # the previous rank's block, received over the ring
        y = comm.hop_grad(x, comm.ppermute_start(x, mesh, ax).wait(), mesh, ax)
        loss = comm.psum(torch.sum(torch.sin(y) * R[me]), mesh, ax)
        want = single(lambda xw: sum(torch.sum(torch.sin(xw[(r - 1) % t]) * R[r]) for r in range(t)))
    else:
        raise ValueError(name)
    comm.reset()
    got = torch.autograd.grad(loss / t, x)[0]
    return _np(got), _np(want), comm.counts()


def _backend_case(case, meshes, dev="cpu"):
    """One sharded dispatch's gradients (x, each weight's storage, the gain,
    the bias or residual) against the single-rank ``api.matmul``'s on the
    whole operands: the loss ``sum(out * R)`` over the whole output, every
    rank's share of a whole operand psummed."""
    from repro_torch import api
    from repro_torch.distributed import WeightPlan, comm, shard_weight

    path, epilogue, rms = case["path"], case["epilogue"], case["rmsnorm"]
    backend, kind = BACKENDS[path]
    mesh = meshes["f2" if path == "fsdp" else "m2"]
    axis = "data" if path == "fsdp" else "model"
    t = mesh.size
    m, k, n = 8, 128, 128
    x, R = _seeded((m, k), 10).to(dev), _seeded((m, n), 11).to(dev)
    ws = [_seeded((k, n), 12).to(dev) * 0.1] + ([_seeded((k, n), 13).to(dev) * 0.1] if epilogue == "swiglu" else [])
    gain, bias, resid = 1 + 0.1 * _seeded((k,), 14).to(dev), _seeded((n,), 15).to(dev), _seeded((m, n), 16).to(dev)
    full = [api.DipWeight.from_natural(w) for w in ws]
    nw = len(full)

    def run(ops, wts, be):
        """``ops``: [x, *storages, (gain), (bias or residual)] leaves."""
        w = [wi.with_data(d) for wi, d in zip(wts, ops[1:1 + nw])]
        rest = ops[1 + nw:]
        pro = dict(prologue="rmsnorm", prologue_operands=(rest[0],)) if rms else {}
        eops = (rest[-1],) if epilogue in ("bias", "residual") else ()
        return api.matmul(ops[0], tuple(w) if nw == 2 else w[0], backend=be, epilogue=epilogue,
                          epilogue_operands=eops, **pro)

    def operands(xa, wts, extra):
        return [_leaf(xa)] + [_leaf(w.data) for w in wts] + ([_leaf(gain)] if rms else []) + \
            ([_leaf(extra)] if epilogue in ("bias", "residual") else [])

    # single rank, whole operands
    whole = operands(x, full, bias if epilogue == "bias" else resid)
    want = list(torch.autograd.grad(torch.sum(run(whole, full, "dip") * R), whole))
    # this rank's slice
    plan = WeightPlan(kind, axis="model", fsdp="data", mesh=mesh)
    along = "fsdp" if backend == "dip_fsdp" else "tp"
    loc = [shard_weight(w, plan, along=along) for w in full]
    xl, rl = local_inputs(path, mesh, x, resid)
    mine = operands(xl, loc, bias if epilogue == "bias" else rl)
    comm.reset()
    y = run(mine, loc, backend)
    me, dme = mesh.coord("model"), mesh.coord("data")
    if path in ("tp_col", "sp_col"):  # this rank's columns, every row
        n_loc = y.shape[1]
        loss = comm.psum(torch.sum(y * R[:, me * n_loc:(me + 1) * n_loc]), mesh, axis)
    elif path == "tp_row":  # every row and column, alike on every rank
        loss = torch.sum(y * R)
    else:  # this rank's rows, every column
        rows, idx = y.shape[0], dme if path == "fsdp" else me
        loss = comm.psum(torch.sum(y * R[idx * rows:(idx + 1) * rows]), mesh, axis)
    fwd = comm.counts()
    comm.reset()
    got = list(torch.autograd.grad(loss / t, mine))
    bwd = comm.counts()
    # the shares of what every rank holds whole, summed: the gain, the bias,
    # x under tp column, the residual where it is whole
    shared = list(range(1 + nw, len(mine))) if epilogue == "bias" or (
        epilogue == "residual" and path in ("tp_col", "tp_row", "sp_col")) else ([1 + nw] if rms else [])
    if path == "tp_col":
        shared.append(0)
    for i in shared:
        got[i] = comm.psum(got[i], mesh, axis)
    # the single-rank gradients cut as the rank's operands are
    xs, rs = local_inputs(path, mesh, want[0], want[-1] if epilogue == "residual" else None)
    cut = [xs] + [shard_weight(w.with_data(g), plan, along=along).data for w, g in zip(full, want[1:1 + nw])]
    cut += [want[1 + nw]] if rms else []
    cut += [want[-1] if epilogue == "bias" else rs] if epilogue in ("bias", "residual") else []
    return [(_np(g), _np(w)) for g, w in zip(got, cut)], fwd, bwd


def train_grad_rank(rank, collective_names, backend_cases):
    """The differentiable collectives (``_collective_case``) and the sharded
    backends' backward (``_backend_case``) on a 2-rank world: meshes ``m2``
    (data 1, model 2) and ``f2`` (data 2, model 1)."""
    from repro_torch.distributed import make_local_mesh

    meshes = {"m2": make_local_mesh(data=1, model=2), "f2": make_local_mesh(data=2, model=1)}
    coll = {name: _collective_case(name, meshes["m2"]) for name in collective_names}
    back = [_backend_case(c, meshes) for c in backend_cases]
    return coll, back


def cuda_train_grad_rank(rank, collective_names, backend_cases):
    """``train_grad_rank`` on the card: 2 ranks sharing card 0 over the
    ``host`` transport, every operand on the card, each shard launch the
    kernel (f32 x: the IEEE route), each backward the f32 recompute."""
    from repro_torch.distributed import make_local_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    meshes = {"m2": make_local_mesh(data=1, model=2, transport="host", device=dev),
              "f2": make_local_mesh(data=2, model=1, transport="host", device=dev)}
    coll = {name: _collective_case(name, meshes["m2"], dev) for name in collective_names}
    back = [_backend_case(c, meshes, dev) for c in backend_cases]
    return coll, back


def _train_mesh(strategy):
    from repro_torch.distributed import make_local_mesh

    return make_local_mesh(data=2, model=1) if strategy == "fsdp" else make_local_mesh(data=1, model=2)


def _padding_max(t) -> float:
    """The largest |value| in the padding of every DiP storage of ``t``
    (rows past d_in, columns past d_out, read in natural layout)."""
    from repro_torch import api
    from repro_torch.core import permute

    if isinstance(t, dict):
        return max([_padding_max(v) for v in t.values()] + [0.0])
    if not isinstance(t, api.DipWeight):
        return 0.0
    nat = permute.unpermute_tiled(t.data.reshape((-1,) + tuple(t.data.shape[-2:])), t.perm_tile)
    pads = [nat[:, t.d_in:], nat[:, :, t.d_out:]]
    return max([float(p.abs().max()) for p in pads if p.numel()] + [0.0])


def train_pairs_rank(rank, cases):
    """One ``train_step_fn(plan=)`` AdamW step, then a second, for every
    (strategy, family) case on the converted reference parameters: the
    losses, global norms and collective / launch counts of each step, and
    the whole parameters after the first step (``plan.gather_params``),
    leaf by leaf in ``tree.leaves`` order."""
    import warnings

    from repro_torch import tree
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import comm, make_plan
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    warnings.simplefilter("ignore", UserWarning)  # the reduced widths replicate (announced once)
    meshes, out = {}, {}
    for case in cases:
        strategy = case["cfg"]["sharding"]
        mesh = meshes.setdefault(strategy == "fsdp", _train_mesh(strategy))
        cfg = _serving_cfg(case["cfg"])
        plan = make_plan(mesh, cfg, "train")
        params = plan.shard_params(params_from_jax(case["params"], cfg, device="cpu"))
        opt = AdamW(lr=case["lr"])
        state = {"params": params, "opt_state": opt.init(params), "step": 0}
        step = tf_model.train_step_fn(cfg, opt, plan=plan)
        rec = {"loss": [], "grad_norm": [], "counts": []}
        for i, batch in enumerate(case["batches"]):
            comm.reset()
            state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            rec["counts"].append(comm.counts())
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            if i == 0:
                whole = plan.gather_params(state["params"])
                moments = plan.gather_params({k: state["opt_state"][k] for k in ("mu", "nu")})
                rec["padding"] = max(_padding_max(whole), _padding_max(moments))
                # copies: a whole leaf is the rank's own tensor, which step 2 updates in place
                rec["params"] = [_np(t).copy() for t in tree.leaves(whole)] if rank == 0 else None
        out[case["name"]] = rec
    return out


def train_trainer_rank(rank, ckpt_dir, steps):
    """``Trainer(plan=)`` on the reduced llama3-8b (4 KV heads, so that the
    ``tp`` and ``fsdp`` plans split the same leaves): ``steps`` steps with a
    checkpoint at step 2 under ``tp``; a second trainer on the same mesh
    resuming from it; the step-2 checkpoint restored under ``tp``, under
    ``fsdp`` and whole on one rank; the guard's joint skip."""
    import dataclasses as dc
    import warnings

    from repro_torch import reliability, tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.distributed import make_plan
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer, TrainerConfig

    warnings.simplefilter("ignore", UserWarning)
    base = dc.replace(get_config("llama3-8b").reduced(), n_kv_heads=4, compute_dtype="float32",
                      param_dtype="float32", matmul_backend="dip")
    cfgs = {s: dc.replace(base, sharding=s, matmul_backend=f"dip_{s}") for s in ("tp", "fsdp")}
    plans = {s: make_plan(_train_mesh(s), cfgs[s], "train") for s in ("tp", "fsdp")}

    def trainer(strategy, guard=False, hook=None):
        tcfg = TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=ckpt_dir, log_every=100, guard=guard,
                             recover_on_fault=False)
        return Trainer(cfgs[strategy], tcfg, optimizer=AdamW(lr=1e-3), plan=plans[strategy], seq_len=16,
                       global_batch=2, device="cpu", step_hook=hook)

    def whole_np(plan, state):
        return [np.array(_np(t)) if isinstance(t, torch.Tensor) else np.asarray(t)
                for t in tree.leaves(plan.gather_params(state))]

    out = {}
    first = trainer("tp").run(seed=0)
    out["losses"] = [m["loss"] for m in first["metrics"]]
    out["final"] = whole_np(plans["tp"], first["state"]["params"])
    again = trainer("tp").run(seed=0)  # resumes from the step-2 checkpoint
    out["resumed_losses"] = [m["loss"] for m in again["metrics"]]
    out["resumed_final"] = whole_np(plans["tp"], again["state"]["params"])
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    restored = {}
    for s in ("tp", "fsdp"):
        like = trainer(s).init_state(seed=1)  # other values: every leaf must come from the file
        state, meta = ckpt.restore(like, step=2, plan=plans[s])
        restored[s] = whole_np(plans[s], state)
        out[f"{s}_slices"] = {p: tuple(t.shape) for p, t in tree.paths(state) if isinstance(t, torch.Tensor)}
    out["restored"] = restored
    opt = AdamW(lr=1e-3)
    one = tf_model.init_params(base, make_generator(1, "cpu"), "cpu")
    one_state, _ = ckpt.restore({"params": one, "opt_state": opt.init(one), "step": 0}, step=2)
    out["one_rank"] = [np.array(_np(t)) if isinstance(t, torch.Tensor) else np.asarray(t)
                       for t in tree.leaves(one_state)]
    # the guard: rank 1's fingerprint reference is off, so its screen fails;
    # the joint verdict makes both ranks skip
    plan = plans["tp"]
    params = tf_model.init_params(cfgs["tp"], make_generator(0, "cpu"), "cpu", plan=plan)
    gopt = AdamW(lr=1e-3)
    gstate = reliability.init_guard_state({"params": params, "opt_state": gopt.init(params), "step": 0})
    if rank == 1:
        gstate["fingerprint"] = gstate["fingerprint"] * 2
    before = [t.clone() for t in tree.leaves(params)]
    step = tf_model.train_step_fn(cfgs["tp"], gopt, guard=True, plan=plan)
    from repro_torch.data import SyntheticLM

    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(vocab_size=base.vocab_size, seq_len=16,
                                                           global_batch=2).batch(0).items()}
    gstate, gm = step(gstate, batch)
    out["guard_poisoned"] = {k: int(gm[k]) for k in ("skipped", "weight_fault")}
    out["guard_unchanged"] = all(torch.equal(a, b) for a, b in zip(before, tree.leaves(gstate["params"])))
    gstate["fingerprint"] = reliability.guard.fingerprint(gstate["params"])
    gstate, gm = step(gstate, batch)
    out["guard_clean"] = {k: int(gm[k]) for k in ("skipped", "weight_fault")}
    return out


def train_counts_rank(rank, cases):
    """One ``train_step_fn(plan=)`` step's collectives and launches a rank
    for each case (a configuration drawn from a seed, batch 2 x 64)."""
    import warnings

    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, make_plan
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    warnings.simplefilter("ignore", UserWarning)
    out = {}
    for name, fields in cases.items():
        cfg = _serving_cfg({k: v for k, v in fields.items() if k != "strict"})
        # strict: every projection must split (the full widths' layout), none replicates
        plan = make_plan(_train_mesh(cfg.sharding), cfg, "train", strict=fields.get("strict", False))
        params = tf_model.init_params(cfg, make_generator(0, "cpu"), "cpu", plan=plan)
        opt = AdamW()
        state = {"params": params, "opt_state": opt.init(params), "step": 0}
        batch = {k: torch.as_tensor(v) for k, v in
                 SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2).batch(0).items()}
        comm.reset()
        tf_model.train_step_fn(cfg, opt, plan=plan)(state, batch)
        out[name] = comm.counts()
    return out
