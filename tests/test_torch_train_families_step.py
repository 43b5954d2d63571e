"""One AdamW step of the MoE/MLA, SSM, hybrid and stub-frontend families
against the JAX reference on the CPU (their losses and gradients:
test_torch_train_families.py, whose setup this file shares).

* One ``train_step_fn`` with AdamW for each family against the reference's:
  loss, gradient norm, both moments and the parameters; AdamW decays every
  leaf with ndim >= 2 on both sides, the stacked (L, H) SSM scalars and
  (L, d) norms included.  The reference's state after the step converts
  into the port's (``opt_state_from_jax`` over a tree without ``lm_head``,
  the plain stacked banks, ``A_log`` and the hybrid's ``shared_attn``).
* ``microbatch=2`` for DeepSeek-V2-Lite against the reference's microbatched
  step: each slice routes with its own capacity, as the reference's scan
  over microbatches does.

Tolerances: the loss and the gradient norm 1e-5 of max(1, |reference|); a
moment leaf 5e-5 of max|reference leaf| (the gradients' bound,
test_torch_train_families.py); the parameters after a step as in
test_torch_train.py, 1e-5 of max(1, max|leaf|) plus 5% of one step, where
the gradient stands clear of AdamW's eps (|g| > 1000 eps); within that of 0
the update g / (|g| + eps) turns the gradients' f32 difference into up to a
whole step either way (measured: DiP storage elements beside the padding of
the reduced Mamba2's in_proj, ~1e-10 gradients, 10% of a step), so there the
bound is two steps of lr.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_parity import FAMILIES, as_np, assert_close, family_batch, family_configs, leaf_close
from repro.models import transformer as ref_tf
from repro.optim import AdamW as RefAdamW
from repro_torch import tree
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.models import transformer as tf_model
from repro_torch.optim import AdamW

LOSS_TOL = 1e-5
LEAF_TOL = 5e-5
LR = 1e-3


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    ref_cfg, cfg = family_configs(request.param)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _port(family):
    _, cfg, _, np_params = family
    return params_from_jax(np_params, cfg, device="cpu")


def _step(cfg, params, batch, microbatch=1):
    opt = AdamW(lr=LR)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    return tf_model.train_step_fn(cfg, opt, microbatch=microbatch)(state, batch)


def _state_close(got, got_m, want, want_m):
    assert got["step"] == got_m["step"] == 1 and got["opt_state"]["count"] == 1
    assert_close(got_m["loss"], want_m["loss"], LOSS_TOL)
    assert_close(got_m["grad_norm"], want_m["grad_norm"], LOSS_TOL)
    np_want = jax.tree_util.tree_map(np.asarray, want)
    for name in ("mu", "nu"):
        for g, w in zip(tree.leaves(got["opt_state"][name]), jax.tree_util.tree_leaves(np_want["opt_state"][name])):
            leaf_close(g, w, LEAF_TOL)
    # parameters: 1e-5 plus 5% of one step where the gradient stands clear
    # of eps (|g| > 1000 eps); where it is within that of 0, AdamW's
    # g / (|g| + eps) turns the gradients' f32 difference (held above, in
    # the moments) into up to a whole step of lr, either way
    b2 = AdamW().b2
    for g, w, nu in zip(tree.leaves(got["params"]), jax.tree_util.tree_leaves(np_want["params"]),
                        jax.tree_util.tree_leaves(np_want["opt_state"]["nu"])):
        err = np.abs(as_np(g) - w)
        clear = np.sqrt(nu / (1 - b2)) > 1000 * AdamW().eps
        base = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert float(err[clear].max(initial=0.0)) <= base + 0.05 * LR, float(err[clear].max())
        assert float(err.max()) <= base + 2 * LR, float(err.max())
    return np_want


def test_one_adamw_step_matches_reference(family):
    ref_cfg, cfg, params, _ = family
    rb, pb = family_batch(cfg, step=1)
    ref_opt = RefAdamW(lr=LR)
    ref_state = {"params": params, "opt_state": ref_opt.init(params), "step": jnp.zeros((), jnp.int32)}
    want, want_m = ref_tf.train_step_fn(ref_cfg, ref_opt)(ref_state, rb)
    got, got_m = _step(cfg, _port(family), pb)
    np_want = _state_close(got, got_m, want, want_m)
    conv = opt_state_from_jax(np_want["opt_state"], device="cpu")
    assert conv["count"] == 1 and [p for p, _ in tree.paths(conv["mu"])] == [p for p, _ in tree.paths(got["params"])]
    for a, b in zip(tree.leaves(conv["nu"]), tree.leaves(got["opt_state"]["nu"])):
        leaf_close(b, a, LEAF_TOL)


def test_microbatched_moe_step_matches_reference():
    """Two slices of 2 rows: each slice routes with its own capacity, as the
    reference's scan over microbatches does."""
    ref_cfg, cfg = family_configs("deepseek-v2-lite-16b")
    params = ref_tf.init_params(jax.random.PRNGKey(1), ref_cfg)
    rb, pb = family_batch(cfg, step=2, batch=4)
    ref_opt = RefAdamW(lr=LR)
    ref_state = {"params": params, "opt_state": ref_opt.init(params), "step": jnp.zeros((), jnp.int32)}
    want, want_m = ref_tf.train_step_fn(ref_cfg, ref_opt, microbatch=2)(ref_state, rb)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    got, got_m = _step(cfg, tparams, pb, microbatch=2)
    _state_close(got, got_m, want, want_m)
