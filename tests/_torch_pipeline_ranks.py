"""Rank bodies of the pipeline and compression tests
(``test_torch_pipeline*.py``, ``test_torch_compression.py``): module-level
functions that ``distributed.run_world`` spawns.  Imports no JAX: the
tests compute the reference's side in their own process and pass numpy.
"""

import dataclasses
import zlib

import numpy as np
import torch

F32 = dict(compute_dtype="float32", param_dtype="float32")
REPLICATED = ("embed", "final_norm", "lm_head")  # the leaves every stage holds whole


def _np(t):
    return t.detach().cpu().numpy()


def _crc(t) -> int:
    return zlib.crc32(np.ascontiguousarray(_np(t).reshape(-1)).view(np.uint8))


def _cfg(fields):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig

    fields = dict(fields)
    if "arch" in fields:
        return dataclasses.replace(get_config(fields.pop("arch")).reduced(), **fields)
    return ArchConfig(**fields)


# ---------------------------------------------------------------- pipeline_apply ---
def apply_rank(rank, w, b, x, cot):
    """``pipeline_apply`` of the reference test's case on a 4-stage mesh:
    this rank holds stage ``rank``'s ``tanh(x @ w + b)``.  The output
    against sequential application in the port (bit for bit), the
    collective log of the forward (each tick's ``ppermute`` before its
    stage compute, marked by a ``launch``) and the backward's counts, and
    the gradients of its share of ``sum(out * cot)`` against sequential
    autograd's."""
    from repro_torch.distributed import comm, make_local_mesh, pipeline_apply

    mesh = make_local_mesh(1, 1, stage=w.shape[0])
    s = mesh.coord("stage")
    mine = {"w": torch.from_numpy(w[s]).requires_grad_(True), "b": torch.from_numpy(b[s]).requires_grad_(True)}
    xs = torch.from_numpy(x).requires_grad_(True)

    def stage_fn(p, a):
        comm.note_launch()  # marks the stage compute in the log
        return torch.tanh(a @ p["w"] + p["b"])

    comm.reset(schedule=True)
    out = pipeline_apply(mesh, stage_fn, mine, xs)
    rec = {"schedule": comm.schedule(), "forward": comm.counts()}
    comm.reset()
    share = (out * torch.from_numpy(cot)).sum() / mesh.size  # this rank's share of the replicated loss
    gw, gb, gx = torch.autograd.grad(share, [mine["w"], mine["b"], xs])
    rec["backward"] = comm.counts()
    # sequential application in the port, and its autograd
    whole_w, whole_b = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    xq = torch.from_numpy(x).requires_grad_(True)
    seq = xq
    for i in range(w.shape[0]):
        seq = torch.tanh(seq @ whole_w[i] + whole_b[i])
    sw, sb, sx = torch.autograd.grad((seq * torch.from_numpy(cot)).sum(), [whole_w, whole_b, xq])
    rec.update(out=_np(out), bit_equal=torch.equal(out, seq), gw=_np(gw), gb=_np(gb), gx=_np(gx),
               want_gw=_np(sw[s]), want_gb=_np(sb[s]), want_gx=_np(sx) if s == 0 else np.zeros_like(x))
    return rec


# ------------------------------------------------------- the pipelined train step ---
def _pp_plan(cfg, stages=2):
    from repro_torch.distributed import make_local_mesh, make_plan

    return make_plan(make_local_mesh(1, 1, stage=stages), cfg, "train")


def _replicated_crcs(params):
    return {k: _crc(params[k].data if hasattr(params[k], "d_in") else params[k]) for k in REPLICATED if k in params}


def pp_step_rank(rank, case, trainer_case):
    """``pipeline_train_step_fn`` on the converted reference parameters
    (``case``): two steps' losses, norms and counts, the whole parameters
    after the first (rank 0), the crc32 of the leaves every rank holds
    whole after each step; then ``trainer_case``'s ``Trainer`` drill."""
    from repro_torch import tree
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import comm, pipeline_train_step_fn
    from repro_torch.optim import AdamW

    cfg = _cfg(case["cfg"])
    plan = _pp_plan(cfg)
    params = plan.shard_params(params_from_jax(case["params"], cfg, device="cpu"))
    opt = AdamW(lr=case["lr"])
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    step = pipeline_train_step_fn(cfg, opt, plan, n_micro=case["n_micro"])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    rec = {"loss": [], "grad_norm": [], "counts": [], "replicated": [],
           "shapes": {p: tuple(t.shape) for p, t in tree.paths(params)}}
    for i in range(2):
        comm.reset()
        state, m = step(state, batch)
        rec["counts"].append(comm.counts())
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["replicated"].append(_replicated_crcs(state["params"]))
        if i == 0:
            whole = plan.gather_params(state["params"])
            rec["params"] = [_np(t).copy() for t in tree.leaves(whole)] if rank == 0 else None
    return rec, _trainer_drill(rank, trainer_case)


def _trainer_drill(rank, case):
    """``Trainer(plan=pp)`` with a compressing AdamW: ``steps`` steps with a
    checkpoint at step 2; a second trainer on the same mesh resuming from
    it (step 3 bit for bit); the step-2 checkpoint restored under ``tp``
    and on one rank (no plan), every leaf of the state, the transform's
    buffers included, gathered whole."""
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.device import make_generator
    from repro_torch.distributed import compression_transform, make_local_mesh, make_plan
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer, TrainerConfig

    base = _cfg(case["cfg"])
    pp = dataclasses.replace(base, sharding="pp")
    plan = _pp_plan(pp)

    def opt():
        return AdamW(lr=1e-3, grad_transform=compression_transform())

    def trainer():
        tcfg = TrainerConfig(steps=case["steps"], ckpt_every=2, ckpt_dir=case["ckpt_dir"], log_every=100)
        return Trainer(pp, tcfg, optimizer=opt(), plan=plan, seq_len=16, global_batch=4, device="cpu")

    def whole_np(p, state):
        return [np.array(_np(t)) if isinstance(t, torch.Tensor) else np.asarray(t)
                for t in tree.leaves(p.gather_params(state) if p is not None else state)]

    out = {}
    first = trainer().run(seed=0)
    out["losses"] = [m["loss"] for m in first["metrics"]]
    out["final"] = whole_np(plan, first["state"]["params"])
    again = trainer().run(seed=0)  # resumes from the step-2 checkpoint
    out["resumed_losses"] = [m["loss"] for m in again["metrics"]]
    out["resumed_final"] = whole_np(plan, again["state"]["params"])
    ckpt = CheckpointManager(case["ckpt_dir"], keep=2)
    tp = dataclasses.replace(base, sharding="tp", matmul_backend="dip_tp")
    tp_plan = make_plan(make_local_mesh(1, 2), tp, "train")
    restored = {}
    for name, p, c in (("pp", plan, pp), ("tp", tp_plan, tp)):
        params = tf_model.init_params(c, make_generator(1, "cpu"), "cpu", plan=p)  # other values
        o = opt()
        state, _ = ckpt.restore({"params": params, "opt_state": o.init(params), "step": 0}, step=2, plan=p)
        restored[name] = whole_np(p, state)
        out[f"{name}_transform_shapes"] = sorted({tuple(t.shape) for t in tree.leaves(state["opt_state"]["transform"])})
    one = tf_model.init_params(base, make_generator(1, "cpu"), "cpu")
    o = opt()
    one_state, _ = ckpt.restore({"params": one, "opt_state": o.init(one), "step": 0}, step=2)
    restored["one"] = whole_np(None, one_state)
    out["restored"] = restored
    return out


# -------------------------------------------------------------- compression ---
def compression_rank(rank, whole, cases, psum_x):
    """Under a plan: the transform of this rank's slices of ``whole`` (three
    steps of error feedback, the scales shared by ``comm.pmax``) against
    the slices of the whole leaves' transform, bit for bit, with its
    count; ``compressed_psum`` of this rank's row of ``psum_x``; and one
    compressed step of each case (``pp`` / ``tp``) on the converted
    reference parameters: loss, norm, counts, the parameters after it
    gathered whole (rank 0)."""
    from repro_torch import tree
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import (comm, compressed_psum, compression_transform, make_local_mesh, make_plan,
                                         pipeline_train_step_fn)
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    mesh = make_local_mesh(1, 2)
    out = {}
    # the slice contract: "w" cut by columns (tp's column split), "v" by its leading axis (pp's), "u" whole
    cut = {"w": lambda t: t.chunk(2, dim=-1)[rank], "v": lambda t: t.chunk(2, dim=0)[rank], "u": lambda t: t}
    gt = compression_transform()
    steps = [{k: torch.from_numpy(v) for k, v in g.items()} for g in whole]
    err_whole, err_mine = gt.init(steps[0]), gt.init({k: cut[k](v) for k, v in steps[0].items()})
    equal = []
    comm.reset()
    for g in steps:
        got, err_mine = gt.fn({k: cut[k](v).clone() for k, v in g.items()}, err_mine,
                              reduce_max=lambda t: comm.pmax(t, mesh, "model"))
        want, err_whole = gt.fn({k: v.clone() for k, v in g.items()}, err_whole)
        equal.append(all(torch.equal(got[k], cut[k](want[k])) and torch.equal(err_mine[k], cut[k](err_whole[k]))
                         for k in g))
    out["slice_equal"], out["slice_counts"] = equal, comm.counts()
    comm.reset()
    out["psum"] = _np(compressed_psum(torch.from_numpy(psum_x[rank]), mesh, "model"))
    out["psum_counts"] = comm.counts()
    for case in cases:
        cfg = _cfg(case["cfg"])
        plan = _pp_plan(cfg) if cfg.sharding == "pp" else make_plan(mesh, cfg, "train")
        params = plan.shard_params(params_from_jax(case["params"], cfg, device="cpu"))
        opt = AdamW(lr=case["lr"], grad_transform=compression_transform())
        state = {"params": params, "opt_state": opt.init(params), "step": 0}
        step = (pipeline_train_step_fn(cfg, opt, plan, n_micro=2) if cfg.sharding == "pp"
                else tf_model.train_step_fn(cfg, opt, plan=plan))
        comm.reset()
        state, m = step(state, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "counts": comm.counts()}
        whole_p = plan.gather_params(state["params"])
        out[cfg.sharding] = dict(rec, params=[_np(t).copy() for t in tree.leaves(whole_p)] if rank == 0 else None)
    return out


# ------------------------------------------------------------------ the card ---
def cuda_pp_rank(rank, device="cuda"):
    """On the card, 2 ranks sharing it over the ``host`` transport (or, to
    rehearse it, on the CPU over gloo): one
    pipelined step (plain AdamW, then a compressing one) of the reduced
    llama3-8b in f32 against the single-rank flat step on the same card
    (its loss, norm and parameters after the step, gathered whole), the
    counts, and ``comm.pmax`` of each rank's values."""
    from repro_torch import tree
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.distributed import comm, compression_transform, make_local_mesh, make_plan
    from repro_torch.kernels.dip_matmul import dip_matmul
    from repro_torch.models import transformer as tf_model
    from repro_torch.optim import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 recompute backward: IEEE products
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = make_local_mesh(1, 1, stage=2, transport="host" if dev.type == "cuda" else None, device=dev)
    base = _cfg(dict(arch="llama3-8b", matmul_backend="dip", **F32))
    cfg = dataclasses.replace(base, sharding="pp")
    plan = make_plan(mesh, cfg, "train")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4).batch(1).items()}
    out = {"pmax": _np(comm.pmax(torch.tensor([float(rank), -float(rank)], device=dev), mesh, "stage"))}
    for name, gt in (("plain", None), ("compressed", compression_transform())):
        whole = tf_model.init_params(base, make_generator(0, dev), dev)
        opt = AdamW(lr=1e-3, grad_transform=gt)
        ref, rm = tf_model.train_step_fn(base, opt, fused_ce=False)(
            {"params": whole, "opt_state": opt.init(whole), "step": 0}, batch)
        params = tf_model.init_params(cfg, make_generator(0, dev), dev, plan=plan)
        opt = AdamW(lr=1e-3, grad_transform=gt)
        comm.reset()
        dip_matmul.launches = 0
        state, m = tf_model.train_step_fn(cfg, opt, plan=plan)(
            {"params": params, "opt_state": opt.init(params), "step": 0}, batch)
        rec = {"counts": comm.counts(), "dip_launches": dip_matmul.launches,
               "loss": (float(m["loss"]), float(rm["loss"])),
               "grad_norm": (float(m["grad_norm"]), float(rm["grad_norm"]))}
        got = tree.leaves(plan.gather_params(state["params"]))
        rec["param_err"] = [float((g - w).detach().abs().max()) / max(1.0, float(w.detach().abs().max()))
                            for g, w in zip(got, tree.leaves(ref["params"]))]
        out[name] = rec
    return out
