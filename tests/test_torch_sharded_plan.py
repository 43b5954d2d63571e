"""The port's ``ShardingPlan`` and ``WeightPlan`` metadata against the
reference's, with no world: plans are made against abstract meshes (axis
sizes, no process groups) on both sides (the reference's ``AbstractMesh``).

``attach_params`` gives every DiP leaf of the reduced llama3-8b,
DeepSeek-V2-Lite and Zamba2 the reference's kind and axes, and
``param_pspec`` every template leaf the reference's spec; the divisibility
fallback warns once and raises under ``strict``; the plan rides through
``tree`` and checkpoints, the reference's manifests included, and restore
validates it; the dispatch rules of the ``"sharded"`` layout hold.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro import api as rapi
from repro.checkpoint import save_pytree as ref_save
from repro.configs import get_config as ref_config
from repro.distributed.plan import WeightPlan as RefWeightPlan
from repro.distributed.plan import make_plan as ref_make_plan
from repro.models import transformer as ref_model

from repro_torch import api, tree
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.device import make_generator
from repro_torch.distributed import WeightPlan, abstract_mesh, make_local_mesh, make_plan, shard_weight
from repro_torch.models import transformer as tf_model
from repro_torch.serving import Engine, EngineConfig

ARCHS = ("llama3-8b", "deepseek-v2-lite-16b", "zamba2-2.7b")


def _ref_kinds(name, strategy="tp"):
    cfg = dataclasses.replace(ref_config(name.replace("-", "_").replace(".", "_")).reduced(), sharding=strategy,
                              matmul_backend=f"dip_{strategy}")
    plan = ref_make_plan(AbstractMesh((1, 2), ("data", "model")), cfg, "decode")
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif getattr(t, "plan", None) is not None:
            out[path] = (t.plan.kind, t.plan.axis, t.plan.fsdp)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        walk(plan.attach_params(ref_model.param_specs(cfg)), ())
    return plan, out


def _port_plan(name, strategy="tp", **opts):
    cfg = dataclasses.replace(get_config(name).reduced(), sharding=strategy, matmul_backend=f"dip_{strategy}")
    return make_plan(abstract_mesh(data=1, model=2), cfg, "decode", **opts)


@pytest.mark.parametrize("name", ARCHS)
def test_attach_params_matches_the_reference(name):
    """Under ``tp`` and under ``ep``: every DiP leaf's kind and axes, every
    template leaf's spec and every paged-cache pool's spec."""
    cfg = dataclasses.replace(get_config(name).reduced(), matmul_backend="dip")
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")
    for strategy in ("tp", "ep"):
        ref_plan, want = _ref_kinds(name, strategy)
        plan = _port_plan(name, strategy)
        got = {}

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (k,))
            elif getattr(t, "plan", None) is not None:
                got[path] = (t.plan.kind, t.plan.axis, t.plan.fsdp)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            walk(plan.attach_params(params), ())
        assert got == want and len(got) > 5, strategy

        # and every template leaf's spec
        def leaves(t, path=()):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from leaves(v, path + (k,))
                else:
                    yield k, tuple(v[0])

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for leaf, shape in leaves(tf_model.param_template(cfg)):
                assert plan.param_pspec(leaf, shape) == tuple(ref_plan.param_pspec(leaf, shape)), (leaf, strategy)
        # and every paged-cache pool's
        pools = tf_model.init_paged_cache(cfg, 3, 4, slots=2, device="cpu")["layers"]
        for nm, t in pools.items():
            shape = tuple(t.shape) if nm != "attn" else None
            if shape is not None:
                assert plan.paged_cache_pspec(nm, shape) == tuple(ref_plan.paged_cache_pspec(nm, shape)), nm


def test_divisibility_fallback_warns_once_and_raises_under_strict():
    from repro_torch.distributed import plan as plan_mod

    plan = _port_plan("llama3-8b")
    plan_mod._WARNED.discard(("wq", 320, "model", 2))  # another test may have met this leaf first
    with pytest.warns(UserWarning, match="does not divide"):
        wp = plan.weight_plan("wq", (64, 320), 64)  # 320 / 2 = 160 columns: not a 64-tile shard
    assert wp.kind == "replicated" and wp.axis is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert plan.weight_plan("wq", (64, 320), 64).kind == "replicated"  # once
    with pytest.raises(ValueError, match="strict=True"):
        _port_plan("llama3-8b", strict=True).weight_plan("wq", (64, 320), 64)


def test_weight_plan_validation_and_describe():
    with pytest.raises(ValueError, match="column | row | replicated"):
        WeightPlan("diagonal")
    mesh = abstract_mesh(data=1, model=1)
    p = WeightPlan("row", axis="model", fsdp="data", mesh=mesh)
    ref = RefWeightPlan("row", axis="model", fsdp="data", mesh=AbstractMesh((1, 1), ("data", "model")))
    assert p.describe() == ref.describe() == {"kind": "row", "axis": "model", "fsdp": "data",
                                               "mesh_axes": {"data": 1, "model": 1}}
    assert p.fsdp_size == 1 and p.tp_size == 1
    assert WeightPlan("row", axis="ghost", mesh=mesh).tp_size == 1
    assert WeightPlan("replicated").describe()["mesh_axes"] is None
    assert p == WeightPlan("row", axis="model", fsdp="data", mesh=abstract_mesh(data=1, model=1))
    assert hash(p) == hash(WeightPlan("row", axis="model", fsdp="data", mesh=abstract_mesh(data=1, model=1)))


def _plan_col(model=1):
    return WeightPlan("column", axis="model", fsdp="data", mesh=abstract_mesh(data=1, model=model))


def test_plan_rides_through_tree_and_layer_slices():
    plan = _plan_col()
    w = api.DipWeight.from_natural(torch.randn(3, 100, 130), plan=plan)
    back = tree.unflatten(w, tree.leaves(w))
    assert isinstance(back, api.DipWeight) and back.plan == plan
    assert w.with_data(w.data[0]).plan == plan and w.astype(torch.bfloat16).plan == plan
    q = api.quant.quantize(torch.randn(100, 130), "int8").with_plan(plan)
    assert q.with_data(q.data, q.scale).plan == plan and q.dequantize().plan == plan
    assert q.with_plan(plan) is q


def test_weight_plan_survives_checkpoint_and_validates_on_restore(tmp_path):
    plan = _plan_col()
    r = np.random.default_rng(5)
    w = torch.from_numpy(r.normal(0, 1, (100, 130)).astype(np.float32))
    state = {"wq": api.DipWeight.from_natural(w, plan=plan)}
    path = str(tmp_path / "ck")
    save_pytree(path, state)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    entry = manifest["dip_weights"]["['wq']"]
    assert entry["plan"] == {"kind": "column", "axis": "model", "fsdp": "data",
                             "mesh_axes": {"data": 1, "model": 1}}
    like = {"wq": api.DipWeight(torch.zeros_like(state["wq"].data), 100, 130, plan=plan)}
    got = restore_pytree(path, like)
    assert got["wq"].plan == plan and torch.equal(got["wq"].data, state["wq"].data)
    bad = WeightPlan("row", axis="model", fsdp="data", mesh=abstract_mesh(data=1, model=1))
    with pytest.raises(ValueError, match="ShardingPlan mismatch"):
        restore_pytree(path, {"wq": like["wq"].with_plan(bad)})
    lost = WeightPlan("column", axis="model", fsdp=None, mesh=abstract_mesh(stage=1))
    with pytest.raises(ValueError, match="ShardingPlan mismatch"):
        restore_pytree(path, {"wq": like["wq"].with_plan(lost)})
    assert restore_pytree(path, {"wq": like["wq"].with_plan(None)})["wq"].plan is None


def test_reference_checkpoint_plan_validates_in_the_port(tmp_path):
    """A checkpoint the reference writes with a plan restores into the port
    under a compatible plan and refuses an incompatible one."""
    r = np.random.default_rng(6)
    w = r.normal(0, 1, (100, 130)).astype(np.float32)
    ref_plan = RefWeightPlan("column", axis="model", fsdp="data", mesh=AbstractMesh((1, 2), ("data", "model")))
    path = str(tmp_path / "ref")
    ref_save(path, {"wq": rapi.DipWeight.from_natural(jnp.asarray(w), plan=ref_plan)})
    live = WeightPlan("column", axis="model", fsdp="data", mesh=abstract_mesh(data=1, model=2))
    like = {"wq": api.DipWeight(torch.zeros((128, 192)), 100, 130, plan=live)}
    got = restore_pytree(path, like)
    np.testing.assert_array_equal(got["wq"].to_natural().numpy(), w)
    with pytest.raises(ValueError, match="ShardingPlan mismatch"):
        restore_pytree(path, {"wq": like["wq"].with_plan(WeightPlan("row", axis="model", mesh=live.mesh))})


def test_convert_carries_kind_and_axes_and_shard_params_slices():
    """``params_from_jax`` keeps a reference plan's kind and axes (its JAX
    mesh stays behind); ``shard_params`` under a live plan decides anew and
    cuts this rank's slice of the reference's storage."""
    import jax

    rcfg = dataclasses.replace(ref_config("llama3_8b").reduced(), sharding="tp", matmul_backend="dip_tp",
                               compute_dtype="float32", param_dtype="float32")
    rplan = ref_make_plan(AbstractMesh((1, 2), ("data", "model")), rcfg, "decode")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rparams = rplan.attach_params(ref_model.init_params(jax.random.PRNGKey(0), rcfg))
    np_params = jax.tree_util.tree_map(np.asarray, rparams)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), sharding="tp", matmul_backend="dip_tp",
                              compute_dtype="float32", param_dtype="float32")
    params = params_from_jax(np_params, cfg, device="cpu")
    assert params["layers"]["wo"].plan == WeightPlan("row", axis="model", fsdp="data")
    assert params["layers"]["wq"].plan.mesh is None
    mesh = abstract_mesh(data=1, model=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        local = make_plan(mesh, cfg, "decode").shard_params(params)
    wq, wo = local["layers"]["wq"], local["layers"]["wo"]
    assert wq.plan.mesh == mesh and wq.data.shape == (2, 128, 64) and wo.data.shape == (2, 64, 128)
    np.testing.assert_array_equal(wq.data.numpy(), np.asarray(rparams["layers"]["wq"].data)[..., :64])
    np.testing.assert_array_equal(wo.data.numpy(), np.asarray(rparams["layers"]["wo"].data)[:, :64])
    assert local["embed"].shape == (cfg.padded_vocab // 2, cfg.d_model)
    assert local["layers"]["wk"].plan.kind == "replicated" and local["layers"]["wk"].data.shape == (2, 128, 64)
    assert local["lm_head"].data.shape == (128, cfg.padded_vocab // 2)


def _leaf_objects(t, prefix=""):
    """(path, leaf) with the weights whole (``tree.paths`` splits them)."""
    if isinstance(t, dict):
        return [pl for k in sorted(t) for pl in _leaf_objects(t[k], f"{prefix}/{k}")]
    return [(prefix, t)]


@pytest.mark.parametrize("quantization", ["none", "int8"])
def test_init_params_under_a_plan_draws_each_ranks_slice(quantization):
    """``init_params(plan=)`` gives each rank the values of
    ``shard_params(init_params())`` from the same draws (reduced llama3-8b,
    bf16 DiP storage and int8), which ``shard_params`` then passes through;
    a leaf that is neither whole nor the rank's slice raises."""
    from repro_torch.distributed import Mesh

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), sharding="tp", matmul_backend="dip_tp",
                              param_dtype="bfloat16", compute_dtype="bfloat16", quantization=quantization)
    whole = tf_model.init_params(cfg, make_generator(3, "cpu"), "cpu")
    for rank in (0, 1):
        plan = make_plan(Mesh({"data": 1, "model": 2}, rank=rank), cfg, "decode")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = plan.shard_params(whole)
            got = tf_model.init_params(cfg, make_generator(3, "cpu"), "cpu", plan=plan)
            again = plan.shard_params(got)
        flat_w, flat_g, flat_a = (_leaf_objects(t) for t in (want, got, again))
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g] == [p for p, _ in flat_a]
        for (path, w), (_, g), (_, a) in zip(flat_w, flat_g, flat_a):
            assert a is g, path
            assert type(g) is type(w), path
            if isinstance(w, (api.DipWeight, api.QuantizedDipWeight)):
                assert g.plan == w.plan, path
                torch.testing.assert_close(g.data, w.data, rtol=0, atol=0)
                if quantization != "none":
                    torch.testing.assert_close(g.scale, w.scale, rtol=0, atol=0)
            else:
                torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert got["embed"].shape == (cfg.padded_vocab // 2, cfg.d_model)
        assert got["layers"]["wo"].data.shape[-2] * 2 == whole["layers"]["wo"].data.shape[-2]
    with pytest.raises(ValueError, match="neither the whole"):
        plan.shard_params(dict(got, embed=got["embed"][:-1]))
    with pytest.raises(ValueError, match="neither the whole"):
        wo = got["layers"]["wo"]
        cut = wo.data[..., :32, :]
        plan.shard_leaf("wo", wo.with_data(cut) if quantization == "none" else wo.with_data(cut, wo.scale))


def test_plan_free_weights_decompose():
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.normal(0, 1, (4, 100)).astype(np.float32))
    w = torch.from_numpy(r.normal(0, 1, (100, 130)).astype(np.float32))
    dw = api.DipWeight.from_natural(w)
    for backend in ("dip_tp", "dip_fsdp", "dip_sp", "dip_ep"):
        torch.testing.assert_close(api.matmul(x, dw, backend=backend), api.matmul(x, dw, backend="dip"),
                                   rtol=0, atol=0)
        torch.testing.assert_close(api.matmul(x, dw, backend=backend), x @ w, rtol=2e-3, atol=2e-3)
    qw = api.quant.quantize(w, "int8")
    assert torch.equal(api.matmul(x, qw, backend="dip_tp"), api.matmul(x, qw))
    rep = api.DipWeight.from_natural(w, plan=WeightPlan("replicated"))
    torch.testing.assert_close(api.matmul(x, rep, backend="dip_tp"), x @ w, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(api.matmul(x, rep, backend="dip_ep"), x @ w, rtol=2e-3, atol=2e-3)


def test_sharded_registration_rules():
    for name in ("dip_tp", "dip_fsdp", "dip_sp", "dip_ep"):
        be = api.get_backend(name)
        assert api.backend_layout(name) == "sharded" and not be.tiled
        assert set(be.epilogues) == set(api.EPILOGUES) and set(be.prologues) == set(api.PROLOGUES)
    assert "dip_tp" in api.list_backends() and "dip_ep" in api.list_backends()
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip_tp")
    assert cfg.uses_dip_storage


def test_sharded_dispatch_validates_inputs():
    plan = _plan_col(model=2)
    w = torch.ones(128, 256)
    shard = shard_weight(api.DipWeight.from_natural(w), plan)
    assert shard.data.shape == (128, 128) and (shard.d_in, shard.d_out) == (128, 256)
    with pytest.raises(ValueError, match="contraction"):
        api.matmul(torch.ones(4, 96), shard, backend="dip_tp")
    with pytest.raises(ValueError, match="2-D"):
        api.matmul(torch.ones(4, 128), shard_weight(api.DipWeight.from_natural(torch.ones(2, 128, 256)), plan),
                   backend="dip_tp")
    other = WeightPlan("column", axis="model", fsdp=None, mesh=plan.mesh)
    with pytest.raises(ValueError, match="share one WeightPlan"):
        api.matmul(torch.ones(4, 128), (shard, shard.with_plan(other)), backend="dip_tp", epilogue="swiglu")
    with pytest.raises(ValueError, match="one rank's shard"):
        api.matmul(torch.ones(4, 128), shard, backend="dip")
    with pytest.raises(ValueError, match="not this plan's shard"):
        api.matmul(torch.ones(4, 128), api.DipWeight.from_natural(w, plan=plan), backend="dip_tp")


def test_constrain_hooks_resolve_and_see_the_stream():
    """``layers.resolve_constrain``: a plan's ``constrain`` (the identity)
    wins over a bare hook, which the model calls at the residual stream and
    the logits."""
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip", compute_dtype="float32")
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")
    tags = []

    def hook(x, tag):
        tags.append(tag)
        return x

    toks = torch.arange(2, 8)[None]
    got = tf_model.forward(params, cfg, tokens=toks, constrain=hook)[0]
    torch.testing.assert_close(got, tf_model.forward(params, cfg, tokens=toks)[0], rtol=0, atol=0)
    assert tags == ["act_btd"] * (cfg.n_layers + 1) + ["logits"]
    plan = _port_plan("llama3-8b")
    x = torch.ones(2)
    assert layers.resolve_constrain(plan, hook)(x, "act_btd") is x and len(tags) == cfg.n_layers + 2
    assert layers.resolve_constrain(None, None)(x, "logits") is x
    # and the loss takes the unfused path through them, equal to forcing it
    batch = {"tokens": toks, "labels": toks}
    tags.clear()
    torch.testing.assert_close(tf_model.loss_fn(params, cfg, batch, constrain=hook),
                               tf_model.loss_fn(params, cfg, batch, fused_ce=False), rtol=0, atol=0)
    assert tags[-1] == "logits"


def test_refusals_outside_the_slice():
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip_tp", compute_dtype="float32")
    params = tf_model.init_params(dataclasses.replace(cfg, matmul_backend="dip"), make_generator(0, "cpu"),
                                  device="cpu")
    with pytest.raises(ValueError, match="ShardingPlan"):  # the reference's test_engine_sharded_backend_requires_plan
        Engine(cfg, params, engine_cfg=EngineConfig(slots=1, max_seq=16), device="cpu")
    mesh = abstract_mesh(data=1, model=2)
    # ep and the moe family under tp run now (test_torch_sharded_moe.py); pp runs over a stage axis
    # alone (test_torch_pipeline_train.py), not beside a model axis, and a stage axis only under pp
    assert make_plan(mesh, dataclasses.replace(cfg, sharding="ep"), "decode").expert_plan.kind == "expert"
    pp = dataclasses.replace(cfg, sharding="pp", matmul_backend="dip")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_plan(abstract_mesh(stage=2, data=1, model=2), pp, "decode")
    with pytest.raises(ValueError, match="'stage' axis"):
        make_plan(mesh, pp, "decode")
    with pytest.raises(NotImplementedError, match="gspmd"):
        make_plan(mesh, cfg, "decode")
    with pytest.raises(NotImplementedError, match="stage axis under the 'tp' strategy"):
        make_plan(abstract_mesh(stage=2, data=1, model=1), dataclasses.replace(cfg, sharding="tp"), "decode")
    with pytest.raises(ValueError, match="must state how its ranks map to cards"):
        make_local_mesh(model=1, device="cuda")
    tp = dataclasses.replace(cfg, sharding="tp")
    plan = make_plan(mesh, tp, "decode")
    moe = dataclasses.replace(tp, family="moe", n_experts=4, moe_top_k=2, d_ff_expert=64)
    tf_model._require_plan(moe, plan)  # admitted
    # the SSM and hybrid families run under tp (test_torch_sharded_ssm.py) and stay refused under ep
    for arch in ("mamba2-370m", "zamba2-2.7b"):
        for strategy in ("tp", "ep"):
            fam = dataclasses.replace(get_config(arch).reduced(), sharding=strategy, matmul_backend=f"dip_{strategy}")
            fam_plan = make_plan(mesh, fam, "decode")
            if strategy == "tp":
                tf_model._require_plan(fam, fam_plan)  # admitted
                continue
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                tf_model.init_paged_cache(fam, 3, 4, slots=1, device="cpu", plan=fam_plan)
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                tf_model.paged_decode_step_fn(fam, plan=fam_plan)
    from repro_torch.optim import AdamW
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # training over both axes of a 2 x 2 mesh
        tf_model.train_step_fn(tp, AdamW(), plan=make_plan(abstract_mesh(data=2, model=2), tp, "train"))
    # the moe family under fsdp serves now (test_torch_sharded_moe_fsdp.py); under sp it does not
    moe_sp = dataclasses.replace(moe, sharding="sp", matmul_backend="dip_sp")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf_model._require_plan(moe_sp, make_plan(mesh, moe_sp, "decode"))
