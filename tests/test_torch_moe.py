"""The port's routed-expert FFN against ``repro.models.moe``: ``moe_capacity``
on a grid, the routing state of ``_route`` (top-k ids, the stable dispatch
order, the expert counts), and ``moe_ffn``'s ``(out, aux, dropped)`` in
float32 on the reference's own weights (``params_from_jax``) — on the
reference test's small configurations (``tests/test_moe.py``: the default
capacity, an overflow that drops tokens, a capacity so large that routing
is dense, one expert, shared experts, a zero router whose uniform
probabilities tie) and on ``reduced()`` of both MoE configurations, through
``pallas_dip`` against the port's ``dip`` and ``xla`` against ``torch``.

Tolerance: ``TOL["float32"]`` (1e-5) of max(1, max|reference|) for ``out``
and ``aux`` — the same f32 arithmetic in another summation order; the
routing state and ``dropped`` are integers and must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import TOL, assert_close
from repro.configs import get_config as ref_get
from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config as port_get
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models import transformer as tf_model

BACKENDS = [("xla", "torch"), ("pallas_dip", "dip")]


def _small(e=8, k=2, shared=0, cf=1.25, backends=("xla", "torch")):
    """The reference test's configuration on both sides (test_moe._cfg)."""
    kw = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0,
              vocab_size=64, head_dim=16, n_experts=e, moe_top_k=k, n_shared_experts=shared,
              d_ff_expert=16, capacity_factor=cf, remat="none", compute_dtype="float32")
    return (RefArchConfig(matmul_backend=backends[0], **kw), ArchConfig(matmul_backend=backends[1], **kw))


def _reduced(name, backends):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(ref_get(name).reduced(), matmul_backend=backends[0], **kw),
            dataclasses.replace(port_get(name).reduced(), matmul_backend=backends[1], **kw))


def _layer0(ref_cfg, cfg, seed=3):
    """Layer 0's parameters on both sides, from the reference's init."""
    params = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    rl = jax.tree_util.tree_map(lambda t: t[0], params["layers"])
    tl = tf_model._layers(params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg,
                                          device="cpu")["layers"], cfg.n_layers)[0]
    return rl, tl


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check(ref_cfg, cfg, rl, tl, x):
    want, waux, wdrop = ref_moe.moe_ffn(jnp.asarray(x), rl, ref_cfg)
    got, aux, dropped = moe.moe_ffn(torch.as_tensor(x), tl, cfg)
    assert_close(got, want, TOL["float32"])
    assert_close(aux, waux, TOL["float32"])
    assert dropped.dtype == torch.int32 and int(dropped) == int(wdrop)
    return got, int(dropped)


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
@pytest.mark.parametrize("e,k", [(1, 1), (4, 1), (8, 2), (64, 6), (128, 8)])
@pytest.mark.parametrize("tokens", [1, 4, 13, 64, 256, 1024])
def test_capacity_matches_reference(tokens, e, k, cf):
    ref_cfg, cfg = _small(e=e, k=k, cf=cf)
    cap = moe.moe_capacity(tokens, cfg)
    assert cap == ref_moe.moe_capacity(tokens, ref_cfg)
    assert cap >= 8 and cap % 8 == 0


def test_capacity_at_the_deepseek_shapes():
    """A 256-token prefill chunk gets 32 slots an expert (mean load 24), a
    decode row 8."""
    cfg = port_get("deepseek-v2-lite-16b")
    assert (moe.moe_capacity(256, cfg), moe.moe_capacity(1, cfg)) == (32, 8)


CASES = {  # name: (config fields, x shape) — the reference test's cases
    "default": (dict(), (2, 8, 32)),
    "overflow": (dict(cf=0.05), (2, 32, 32)),
    "huge_capacity": (dict(e=4, k=2, cf=64.0), (1, 6, 32)),
    "one_expert": (dict(e=1, k=1), (2, 16, 32)),
    "shared": (dict(shared=1), (1, 4, 32)),
}


@pytest.mark.parametrize("backends", BACKENDS, ids=[b for _, b in BACKENDS])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case, backends):
    fields, shape = CASES[case]
    ref_cfg, cfg = _small(backends=backends, **fields)
    rl, tl = _layer0(ref_cfg, cfg)
    got, dropped = _check(ref_cfg, cfg, rl, tl, _x(shape))
    if case == "overflow":
        assert dropped > 0  # 128 (token, slot) pairs for 8 experts x 8 slots a group
    elif case in ("huge_capacity", "one_expert", "default"):
        assert dropped == 0
    if case == "one_expert":  # one expert at gate 1.0 is the dense FFN on its weights
        dense = moe.dense_ffn(torch.as_tensor(_x(shape)), {nm: tl[nm][0] for nm in ("w_gate", "w_up", "w_down")},
                              dataclasses.replace(cfg, matmul_backend="torch"))
        torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)
    if case == "shared":  # the shared expert is added densely to the routed output
        routed, _, _ = moe.moe_ffn(torch.as_tensor(_x(shape)), {nm: v for nm, v in tl.items()
                                                                 if not nm.startswith("shared")},
                                   dataclasses.replace(cfg, n_shared_experts=0))
        sh = moe.dense_ffn(torch.as_tensor(_x(shape)), moe._shared_params(tl), cfg)
        torch.testing.assert_close(got, routed + sh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_zero_router_ties_break_like_reference(k):
    """A zero router gives every expert the same probability, so top-k
    ties everywhere: the lower expert id wins, as in ``jax.lax.top_k``, and
    the dispatch order, counts and drops follow the reference's exactly."""
    ref_cfg, cfg = _small(e=4, k=k)
    rl, tl = _layer0(ref_cfg, cfg)
    rl = dict(rl, router=jnp.zeros_like(rl["router"]))
    tl = dict(tl, router=torch.zeros_like(tl["router"]))
    x = _x((1, 64, 32), seed=1)
    _, dropped = _check(ref_cfg, cfg, rl, tl, x)
    cap = moe.moe_capacity(64, cfg)
    want = ref_moe._route(jnp.asarray(x), rl["router"], ref_cfg, cap)
    got = moe._route(torch.as_tensor(x), tl["router"], cfg, cap)
    assert (got["ids"] == torch.arange(k)).all()
    for nm in ("order", "inv_order", "sorted_ids", "start", "counts"):
        np.testing.assert_array_equal(got[nm].numpy(), np.asarray(want[nm]), err_msg=nm)
    assert dropped == 64 * k - k * cap  # every token on the first k experts, each keeps cap


@pytest.mark.parametrize("backends", BACKENDS, ids=[b for _, b in BACKENDS])
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"])
def test_reduced_configs_moe_ffn_and_routing(name, backends):
    """``moe_ffn`` at ``reduced()`` (8 experts, top-2, shared experts for
    DeepSeek), on a prefill-sized group that drops pairs and on decode rows
    (one token a group), with the routing state equal to the reference's."""
    ref_cfg, cfg = _reduced(name, backends)
    rl, tl = _layer0(ref_cfg, cfg)
    for shape in ((1, 40, cfg.d_model), (4, 1, cfg.d_model)):
        x = _x(shape, seed=shape[1])
        _check(ref_cfg, cfg, rl, tl, x)
        cap = moe.moe_capacity(shape[1], cfg)
        want = ref_moe._route(jnp.asarray(x), rl["router"], ref_cfg, cap)
        got = moe._route(torch.as_tensor(x), tl["router"], cfg, cap)
        for nm in ("order", "counts"):
            np.testing.assert_array_equal(got[nm].numpy(), np.asarray(want[nm]), err_msg=nm)
        assert_close(got["gates_flat"], want["gates_flat"], TOL["float32"])


def test_expert_parallel_path_raises():
    """The expert-parallel layer runs now (``test_torch_sharded_moe.py``);
    it still refuses banks that are not the plan's E / T experts a rank
    (the whole banks, not ``ShardingPlan.shard_params``), and so does the
    expert-split layer, before any collective."""
    from repro_torch.distributed import comm, make_plan

    ref_cfg, cfg = _small()
    _, tl = _layer0(ref_cfg, cfg)
    for strategy, shape in (("ep", (2, 4, 32)), ("tp", (1, 4, 32))):
        plan = make_plan(comm.Mesh({"data": 1, "model": 2}), dataclasses.replace(cfg, sharding=strategy), "decode")
        with pytest.raises(ValueError, match="shard_params"):
            moe.moe_ffn(torch.zeros(shape), tl, cfg, plan=plan)


def test_replayed_routing_follows_the_given_ids():
    """``route_ids`` replays a routing: the layer's own top-k ids give its
    own output exactly; other ids are taken as given, with the gates the
    renormalized probabilities at those ids and the capacity applied to
    them (the reference ``_route`` with its top-k swapped for the ids)."""
    ref_cfg, cfg = _small(e=8, k=2, cf=0.5)
    rl, tl = _layer0(ref_cfg, cfg)
    x = torch.as_tensor(_x((2, 16, 32), seed=3))
    out, aux, dropped, ids = moe.moe_ffn(x, tl, cfg, return_routing=True)
    again = moe.moe_ffn(x, tl, cfg, return_routing=True, route_ids=ids)
    assert torch.equal(again[0], out) and torch.equal(again[3], ids) and int(again[2]) == int(dropped)
    other = torch.stack([ids[..., 1], ids[..., 0]], -1).flip(1)  # the same experts per slot, reordered tokens
    forced = moe.moe_ffn(x, tl, cfg, return_routing=True, route_ids=other)
    assert torch.equal(forced[3], other)
    cap = moe.moe_capacity(16, cfg)
    r = moe._route(x, tl["router"], cfg, cap, other)
    probs = torch.softmax(torch.einsum("bsd,de->bse", x, tl["router"]), -1)
    g = torch.gather(probs, -1, other)
    torch.testing.assert_close(r["gates_flat"], (g / g.sum(-1, keepdim=True)).reshape(2, -1))
