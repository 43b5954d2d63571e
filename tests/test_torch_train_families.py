"""Training the MoE/MLA, SSM, hybrid and stub-frontend families: the port
against the JAX reference on the CPU.

Each family at ``reduced()`` in f32, batch 2 x 32 from ``SyntheticLM`` (the
stub frontends' batches carry the pipeline's ``embeddings`` in place of
tokens), with the reference's own ``init_params`` weights through numpy into
``convert.params_from_jax``.  The reference runs its ``xla`` backend on the
same DiP storage (``dip_weights=True``: every projection de-shears the
storage and multiplies), so that its cost stays small; the port runs ``dip``
(``FusedDispatch`` over the DiP kernel's plain version) and the fused
lm_head + cross-entropy through ``lm_head_ce``'s plain version.

* ``loss_fn`` fused and unfused, and every leaf's gradient, against
  ``jax.value_and_grad(repro.models.transformer.loss_fn)``: the MoE router
  aux loss inside the loss, the gradients through the routing gates, the
  expert banks' gathers and einsums, MLA's naive form, the chunked SSD, the
  hybrid's shared block at its two sites and the tied head (whose gradient
  into ``embed`` adds to the lookup's).  A model fed embeddings has a
  separate head, so its ``embed`` takes no gradient (zeros on both sides).
* The aux term alone: the summed router aux of ``forward`` against the
  reference's, and the port's loss less its cross entropy equal to it.
* (One AdamW step and the microbatched step: test_torch_train_families_step.py.)
* Block remat against no remat: bit-identical gradients, the same expert
  ids, ``moe_trace`` recorded once per layer (the rerun's ids in
  ``recompute_ids``, equal to the forward's).
* MLA's naive form (D = 192 keys, Dv = 128 values at full width; 48 / 32
  reduced) on the KV-chunked attention path, and the chunked SSD over a
  length that is no multiple of its chunk (the dt = 0 padding), with their
  gradients against the reference's.

Tolerances: the loss 1e-5 of max(1, |reference|); a gradient leaf 5e-5 of
max|reference leaf|: f32 in another summation order, carried through the
chunked scan's cumulative sums and exponentials for the SSM families
(measured up to 8e-6, at Zamba2's ``A_log``), within 2e-6 elsewhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from _torch_parity import FAMILIES, assert_close, family_batch, family_configs, leaf_close
from repro.models import transformer as ref_tf
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.kernels import lm_head_ce
from repro_torch.models import transformer as tf_model

LOSS_TOL = 1e-5
LEAF_TOL = 5e-5


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    ref_cfg, cfg = family_configs(request.param)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _port(family):
    _, cfg, _, np_params = family
    return params_from_jax(np_params, cfg, device="cpu")


def _grads(params, cfg, batch, **kw):
    """The loss and every leaf's gradient (zeros where the loss does not
    reach a leaf, as ``jax.grad`` gives them)."""
    leaves = tree.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = tf_model.loss_fn(params, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ce", "unfused"])
def test_loss_and_every_leaf_gradient_match_reference(family, fused):
    ref_cfg, cfg, params, _ = family
    rb, pb = family_batch(cfg)
    want, want_g = jax.value_and_grad(lambda p: ref_tf.loss_fn(p, ref_cfg, rb, fused_ce=fused))(params)
    tparams = _port(family)
    got, grads = _grads(tparams, cfg, pb, fused_ce=fused)
    assert_close(got, want, LOSS_TOL)
    ref_paths = ["/".join(str(k) for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(want_g)[0]]
    assert ref_paths == [p for p, _ in tree.paths(tparams)]
    for (path, _), g, wg in zip(tree.paths(tparams), grads, jax.tree_util.tree_leaves(want_g)):
        fed = path == "['embed']" and "embeddings" in pb and not cfg.tie_embeddings
        assert (g.abs().sum() == 0) == fed, f"{path}: a zero gradient only where the loss does not reach"
        leaf_close(g, wg, LEAF_TOL)


def test_the_aux_term_matches_reference(family):
    ref_cfg, cfg, params, _ = family
    rb, pb = family_batch(cfg)
    _, _, want = ref_tf.forward(params, ref_cfg, tokens=rb.get("tokens"), embeddings=rb.get("embeddings"),
                                return_hidden=True)
    tparams = _port(family)
    with torch.no_grad():
        hidden, _, aux = tf_model.forward(tparams, cfg, tokens=pb.get("tokens"), embeddings=pb.get("embeddings"),
                                          return_hidden=True, return_aux=True)
        ce = lm_head_ce.fused_cross_entropy_loss(hidden[:, :-1], tf_model._natural_head(tparams, cfg),
                                                 pb["labels"][:, 1:], vocab_size=cfg.vocab_size)
        loss = tf_model.loss_fn(tparams, cfg, pb)
    assert_close(aux, want, LOSS_TOL)
    assert_close(loss - ce, aux, LOSS_TOL)
    assert (float(aux) > 0) == cfg.is_moe  # the load-balance term is at least router_aux_loss


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "zamba2-2.7b", "mamba2-370m"])
def test_block_remat_keeps_gradients_and_routing(name):
    """``remat="block"`` reruns every block's forward in the backward: the
    gradients equal the un-remat'd ones bit for bit, the forward records
    each MoE layer's routing once, and the rerun routes as the forward did."""
    ref_cfg, cfg = family_configs(name)
    np_params = jax.tree_util.tree_map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(2), ref_cfg))
    _, pb = family_batch(cfg)
    out = {}
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        trace = {}
        loss, grads = _grads(params_from_jax(np_params, c, device="cpu"), c, pb, moe_trace=trace)
        out[remat] = (loss, grads, trace)
    (l0, g0, t0), (l1, g1, t1) = out["none"], out["block"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    n_moe = cfg.n_layers if cfg.is_moe else 0
    for t in (t0, t1):
        assert all(len(t.get(k, [])) == n_moe for k in ("aux", "dropped", "ids"))
    assert "recompute_ids" not in t0
    assert sorted(t1.get("recompute_ids", {})) == list(range(n_moe))
    for i in range(n_moe):
        assert torch.equal(t0["ids"][i], t1["ids"][i])
        assert torch.equal(t1["recompute_ids"][i], t1["ids"][i])


@pytest.mark.parametrize("name,kw", [("deepseek-v2-lite-16b", dict(kv_chunk=8)), ("mamba2-370m", dict(seq=45))],
                         ids=["mla_kv_chunk", "ssd_padded_chunk"])
def test_paths_the_default_batch_misses(name, kw):
    """The KV-chunked attention under MLA (D != Dv) and an SSD chunk padded
    with dt = 0 steps (45 tokens: a chunk of 32, then 13 padded to 32):
    loss and every leaf's gradient against the reference's (unfused), the
    padding giving finite gradients equal to the reference's."""
    ref_cfg, cfg = family_configs(name)
    params = ref_tf.init_params(jax.random.PRNGKey(3), ref_cfg)
    rb, pb = family_batch(cfg, seq=kw.get("seq", 32))
    chunk = dict(kv_chunk=kw["kv_chunk"]) if "kv_chunk" in kw else {}
    want, want_g = jax.value_and_grad(lambda p: ref_tf.loss_fn(p, ref_cfg, rb, fused_ce=False, **chunk))(params)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    got, grads = _grads(tparams, cfg, pb, fused_ce=False, **chunk)
    assert_close(got, want, LOSS_TOL)
    for g, wg in zip(grads, jax.tree_util.tree_leaves(want_g)):
        assert bool(torch.isfinite(g).all())
        leaf_close(g, wg, LEAF_TOL)
