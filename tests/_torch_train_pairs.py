"""Shared by ``test_torch_sharded_train_models.py`` and
``test_torch_sharded_train_ssm.py``: one ``train_step_fn(plan=)`` step (and
a second step's loss) of each (strategy, family) pair on 2 gloo ranks,
against the reference's single-device ``train_step_fn(..., fused_ce=False)``
on the same parameters and numpy batches.

Each family's reference step runs once in the test process (jitted, for
every strategy of the family).  The port's rank step starts from the
reference's parameters (``params_from_jax``, then ``plan.shard_params``);
its parameters after the step are gathered whole (``plan.gather_params``).

Tolerances (the reference's own sharded-step bound,
``tests/test_multidevice.py``: 1e-4): the loss, ``grad_norm`` and the
second step's loss within 1e-4 of max(1, |reference|); every parameter
leaf after the step within 1e-4 of max(1, max|leaf|) where the gradient
stands clear of AdamW's eps (|g| > 1000 eps, read from the reference's
second moment), and within two steps of lr elsewhere, where the update
g / (|g| + eps) turns the f32 gradients' summation-order difference into
up to a whole step either way (``test_torch_train_families_step.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from _torch_parity import as_np, family_batch
from repro.configs import get_config as ref_get
from repro.models import transformer as ref_tf
from repro.optim import AdamW as RefAdamW
from repro_torch.configs import get_config as port_get
from repro_torch.distributed import run_world
from repro_torch.optim import AdamW

import _torch_sharded_ranks as ranks

LR = 1e-3
TOL = 1e-4
F32 = dict(compute_dtype="float32", param_dtype="float32")
FAMILIES = {"dense": "llama3-8b", "moe": "deepseek-v2-lite-16b", "ssm": "mamba2-370m", "hybrid": "zamba2-2.7b"}
# port-side variants held to their family's reference step: block remat
# reruns each block's forward, collectives and routing included, in the
# backward (the reference's remat changes no value)
VARIANTS = {"moe_remat": ("moe", {"remat": "block"})}
BACKEND = {"tp": "dip_tp", "fsdp": "dip_fsdp", "sp": "dip_sp", "ep": "dip_ep"}


def reference_steps(family):
    """The reference's two single-device steps on ``family``'s reduced
    configuration: (numpy initial parameters, numpy batches, metrics of
    both steps, numpy state after the first)."""
    arch = FAMILIES[family]
    ref_cfg = dataclasses.replace(ref_get(arch).reduced(), matmul_backend="xla", dip_weights=True, **F32)
    port_cfg = dataclasses.replace(port_get(arch).reduced(), **F32)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    opt = RefAdamW(lr=LR)
    step = jax.jit(ref_tf.train_step_fn(ref_cfg, opt, fused_ce=False))
    state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    batches, metrics, after = [], [], None
    for i in (1, 2):
        rb, _ = family_batch(port_cfg, step=i)
        batches.append({k: np.asarray(v) for k, v in rb.items()})
        state, m = step(state, rb)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        if after is None:
            after = jax.tree_util.tree_map(np.asarray, state)
    return jax.tree_util.tree_map(np.asarray, params), batches, metrics, after


def world(pairs):
    """Run every (strategy, family) pair of ``pairs`` in one 2-rank world;
    returns ``{(strategy, family): (rank records, reference)}``."""
    base = {f: VARIANTS.get(f, (f, {}))[0] for _, f in pairs}
    refs = {fam: reference_steps(fam) for fam in sorted(set(base.values()))}
    cases = []
    for strategy, fam in pairs:
        np_params, batches, _, _ = refs[base[fam]]
        cases.append({"name": f"{strategy}/{fam}", "params": np_params, "batches": batches, "lr": LR,
                      "cfg": dict(arch=FAMILIES[base[fam]], sharding=strategy, matmul_backend=BACKEND[strategy],
                                  **F32, **VARIANTS.get(fam, (fam, {}))[1])})
    out = run_world(ranks.train_pairs_rank, 2, cases, timeout=300)
    return {(s, f): ([r[f"{s}/{f}"] for r in out], refs[base[f]]) for s, f in pairs}


def check_pair(got_ranks, ref, strategy, family, counts):
    """The holds of the module doc, and the step's pinned counts."""
    from repro_torch import tree
    from repro_torch.convert import params_from_jax

    _, _, metrics, after = ref
    for r in got_ranks:
        for i, m in enumerate(metrics):
            assert abs(r["loss"][i] - m["loss"]) <= TOL * max(1.0, abs(m["loss"])), (i, r["loss"][i], m["loss"])
            assert r["counts"][i] == counts, (i, r["counts"][i])
        assert abs(r["grad_norm"][0] - metrics[0]["grad_norm"]) <= TOL * max(1.0, metrics[0]["grad_norm"])
    assert got_ranks[0]["loss"] == got_ranks[1]["loss"]  # every rank reports the global loss
    assert all(r["padding"] == 0.0 for r in got_ranks)  # the storages' padding and both moments
    cfg = dataclasses.replace(port_get(FAMILIES[VARIANTS.get(family, (family,))[0]]).reduced(), matmul_backend="dip",
                              **F32)
    want = tree.leaves(params_from_jax(after["params"], cfg, device="cpu"))
    nus = jax.tree_util.tree_leaves(after["opt_state"]["nu"])
    b2, eps = AdamW().b2, AdamW().eps
    assert len(want) == len(got_ranks[0]["params"]) == len(nus)
    for g, w, nu in zip(got_ranks[0]["params"], want, nus):
        w = as_np(w)
        assert g.shape == w.shape
        err = np.abs(g - w)
        clear = np.sqrt(nu / (1 - b2)) > 1000 * eps
        base = TOL * max(1.0, float(np.abs(w).max()))
        assert float(err[clear].max(initial=0.0)) <= base, float(err[clear].max())
        assert float(err.max()) <= base + 2 * LR, float(err.max())
