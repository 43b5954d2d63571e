"""The port's training path against the JAX reference on the CPU.

* ``api.matmul`` gradients: dx, the weight cotangent (in the permutated
  layout for ``dip``), the rmsnorm gain's and the bias / residual
  cotangents, against ``jax.grad`` of ``repro.api.matmul`` on ``pallas_dip``
  and ``ws`` (Pallas in interpret mode), for every epilogue with and without
  the prologue.  Tolerance f32 1e-5 of max(1, max|reference|): the same f32
  recompute in another summation order.
* The reduced llama3-8b in f32 with the reference's own weights
  (``params_from_jax``): ``loss_fn`` fused and unfused, every parameter
  leaf's gradient (each also nonzero, which a cut ``grad_fn`` would break),
  one ``train_step_fn`` with AdamW (params, mu, nu, grad_norm), microbatching
  and the KV-chunked attention.  Tolerances: the loss 1e-5 of
  max(1, |reference|); a gradient or moment leaf 1e-5 of max|reference
  leaf| (two layers of f32 in another summation order; about 2e-6 measured);
  parameters after a step 1e-5 of max(1, max|leaf|).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import TOL, as_np, assert_close, reduced_configs, reference_params
from repro import api as ref_api
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tf
from repro.optim import AdamW as RefAdamW
from repro_torch import api, tree
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import permute
from repro_torch.kernels import dip_matmul as dip_mod
from repro_torch.kernels import epilogue as epi
from repro_torch.models import attention
from repro_torch.models import transformer as tf_model
from repro_torch.optim import AdamW

F32 = TOL["float32"]
M, K, N = 37, 100, 70


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(requires_grad)


# ------------------------------------------------------------ api.matmul --
@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("layout", [("pallas_dip", "dip"), ("ws", "ws")], ids=["dip", "ws"])
def test_matmul_gradients_match_reference(layout, epilogue, prologue):
    ref_backend, backend = layout
    r = np.random.default_rng(0)
    x = r.normal(size=(2, M, K)).astype(np.float32)
    ws = [(r.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32) for _ in range(2)]
    g = (r.random(K) + 0.5).astype(np.float32)
    s = epi.spec(epilogue)
    op = (r.normal(size=(N,)) if s.bias else r.normal(size=(2, M, N))).astype(np.float32)
    cot = r.normal(size=(2, M, N)).astype(np.float32)
    n_w = 2 if s.dual_weight else 1
    has_op = s.bias or s.residual
    dip = backend == "dip"
    # the weights enter as the storage the backend consumes
    store = [np.asarray(ref_api.DipWeight.from_natural(jnp.asarray(w)).data) if dip else w for w in ws[:n_w]]

    def ref_f(xx, wl, gg, oo):
        wt = [ref_api.DipWeight(w, K, N) if dip else w for w in wl]
        out = ref_api.matmul(xx, tuple(wt) if n_w == 2 else wt[0], backend=ref_backend, epilogue=epilogue,
                             epilogue_operands=(oo,) if has_op else (),
                             prologue=prologue, prologue_operands=(gg,) if prologue == "rmsnorm" else ())
        return jnp.sum(out * cot)

    want = jax.grad(ref_f, argnums=(0, 1, 2, 3))(jnp.asarray(x), [jnp.asarray(w) for w in store],
                                                 jnp.asarray(g), jnp.asarray(op))
    tx, tws, tg, top = _t(x, True), [_t(w, True) for w in store], _t(g, True), _t(op, True)
    wt = [api.DipWeight(w, K, N) if dip else w for w in tws]
    out = api.matmul(tx, tuple(wt) if n_w == 2 else wt[0], backend=backend, epilogue=epilogue,
                     epilogue_operands=(top,) if has_op else (),
                     prologue=prologue, prologue_operands=(tg,) if prologue == "rmsnorm" else ())
    leaves = [tx, *tws] + ([tg] if prologue == "rmsnorm" else []) + ([top] if has_op else [])
    got = torch.autograd.grad((out * _t(cot)).sum(), leaves)
    refs = [want[0], *want[1]] + ([want[2]] if prologue == "rmsnorm" else []) + ([want[3]] if has_op else [])
    for a, b in zip(got, refs):
        assert_close(a, b, F32)


def test_dip_gradient_leaves_padding_at_zero():
    """A ragged DiP weight: the cotangent of the padded storage stays 0
    outside the logical (d_in, d_out) block, so AdamW never moves it."""
    r = np.random.default_rng(1)
    w = api.DipWeight.from_natural(_t(r.normal(size=(K, N))))
    w.data.requires_grad_(True)
    out = api.matmul(_t(r.normal(size=(5, K))), w, backend="dip")
    (dp,) = torch.autograd.grad(out.sum(), [w.data])
    natural = permute.unpermute_tiled(dp)
    assert dp.shape == (128, 128)
    assert not natural[K:].any() and not natural[:, N:].any()
    assert natural[:K, :N].abs().sum() > 0


# ---------------------------------------------------------- reduced model --
BACKENDS = [("pallas_dip", "dip"), ("xla", "torch")]


def _batch(seed=0, b=2, s=16, vocab=512):
    r = np.random.default_rng(seed)
    toks = r.integers(2, vocab, (b, s)).astype(np.int32)
    labels = toks.copy()
    labels[0, 3] = -100
    mask = np.ones((b, s), np.int32)
    mask[1, 5:9] = 0
    return ({k: jnp.asarray(v) for k, v in dict(tokens=toks, labels=labels, loss_mask=mask).items()},
            {k: torch.as_tensor(v) for k, v in dict(tokens=toks, labels=labels, loss_mask=mask).items()})


@pytest.fixture(scope="module", params=BACKENDS, ids=[b for _, b in BACKENDS])
def model(request):
    ref_cfg, cfg = reduced_configs(*request.param)
    params, np_params = reference_params(ref_cfg)
    return ref_cfg, cfg, params, np_params


def _port_params(model):
    _, cfg, _, np_params = model
    return params_from_jax(np_params, cfg, device="cpu")


def _leaf_close(got, want, rel=F32):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), f"max|err| {err} > {rel} x max|ref|"


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ce", "unfused"])
def test_loss_and_every_leaf_gradient_match_reference(model, fused):
    ref_cfg, cfg, params, _ = model
    rb, pb = _batch()
    want, want_g = jax.value_and_grad(lambda p: ref_tf.loss_fn(p, ref_cfg, rb, fused_ce=fused))(params)
    tparams = _port_params(model)
    leaves = tree.leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = tf_model.loss_fn(tparams, cfg, pb, fused_ce=fused)
    grads = torch.autograd.grad(got, leaves)
    assert_close(got.detach(), want, F32)
    ref_paths = ["/".join(str(k) for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(want_g)[0]]
    assert ref_paths == [p for p, _ in tree.paths(tparams)]
    for (path, _), g, wg in zip(tree.paths(tparams), grads, jax.tree_util.tree_leaves(want_g)):
        assert g.abs().sum() > 0, f"{path}: zero gradient (a cut grad_fn?)"
        _leaf_close(g, wg)


def test_default_loss_takes_the_fused_kernel(model, monkeypatch):
    _, cfg, _, _ = model
    calls = []
    real = tf_model.lm_head_ce.fused_cross_entropy_loss
    monkeypatch.setattr(tf_model.lm_head_ce, "fused_cross_entropy_loss",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, pb = _batch()
    with torch.no_grad():
        a = tf_model.loss_fn(_port_params(model), cfg, pb)
        b = tf_model.loss_fn(_port_params(model), cfg, pb, fused_ce=False)
    assert calls == [1]
    assert_close(a, b, F32)


def test_one_adamw_step_matches_reference(model):
    ref_cfg, cfg, params, _ = model
    rb, pb = _batch(seed=1)
    ref_opt, opt = RefAdamW(lr=1e-3), AdamW(lr=1e-3)
    ref_state = {"params": params, "opt_state": ref_opt.init(params), "step": jnp.zeros((), jnp.int32)}
    want, want_m = ref_tf.train_step_fn(ref_cfg, ref_opt)(ref_state, rb)
    state = {"params": _port_params(model), "step": 0}
    state["opt_state"] = opt.init(state["params"])
    got, got_m = tf_model.train_step_fn(cfg, opt)(state, pb)
    assert got["step"] == got_m["step"] == 1 and got["opt_state"]["count"] == 1
    assert_close(got_m["loss"], want_m["loss"], F32)
    assert_close(got_m["grad_norm"], want_m["grad_norm"], F32)
    np_want = jax.tree_util.tree_map(np.asarray, want)
    for name in ("mu", "nu"):
        for g, w in zip(tree.leaves(got["opt_state"][name]), jax.tree_util.tree_leaves(np_want["opt_state"][name])):
            _leaf_close(g, w)
    # a parameter moves by lr * m/(sqrt(n) + eps); where |g| is within a few
    # eps = 1e-8 of 0 that ratio amplifies the gradients' f32 summation-order
    # difference, so parameters are held to 1e-5 plus 5% of one step (the
    # update arithmetic itself is held exactly below, on shared gradients)
    for g, w in zip(tree.leaves(got["params"]), jax.tree_util.tree_leaves(np_want["params"])):
        err = float(np.abs(as_np(g) - w).max())
        assert err <= F32 * max(1.0, float(np.abs(w).max())) + 0.05 * 1e-3, err
    # the converted reference state continues the same way as the port's own
    conv = opt_state_from_jax(np_want["opt_state"], device="cpu")
    assert conv["count"] == 1
    for a, b in zip(tree.leaves(conv["mu"]), tree.leaves(got["opt_state"]["mu"])):
        _leaf_close(b, a)


def test_adamw_update_matches_reference_on_the_same_gradients():
    """Three steps of both optimizers on one tree (a DipWeight leaf, a
    matrix, a vector) with the same gradients and a warm-up schedule:
    parameters and moments agree to f32 rounding (1e-6 of max|leaf|)."""
    from repro import api as rapi
    from repro.optim import linear_warmup as ref_warmup
    from repro_torch.optim import linear_warmup

    r = np.random.default_rng(7)
    w = (r.normal(size=(100, 70)) * 0.1).astype(np.float32)
    params_np = {"w": np.asarray(rapi.DipWeight.from_natural(jnp.asarray(w)).data),
                 "m": r.normal(size=(3, 5)).astype(np.float32), "v": r.normal(size=(7,)).astype(np.float32)}
    ref_p = {"w": rapi.DipWeight(jnp.asarray(params_np["w"]), 100, 70),
             "m": jnp.asarray(params_np["m"]), "v": jnp.asarray(params_np["v"])}
    port_p = {"w": api.DipWeight(_t(params_np["w"]), 100, 70), "m": _t(params_np["m"]), "v": _t(params_np["v"])}
    ref_opt, opt = RefAdamW(lr=ref_warmup(1e-2, 2)), AdamW(lr=linear_warmup(1e-2, 2))
    ref_s, st = ref_opt.init(ref_p), opt.init(port_p)
    for i in range(3):
        gs = [r.normal(size=a.shape).astype(np.float32) * (3.0 if i == 1 else 0.2) for a in params_np.values()]
        ref_g = {"w": rapi.DipWeight(jnp.asarray(gs[0]), 100, 70), "m": jnp.asarray(gs[1]), "v": jnp.asarray(gs[2])}
        upd, ref_s = ref_opt.update(ref_g, ref_s, ref_p)
        ref_p = jax.tree_util.tree_map(lambda a, b: a + b, ref_p, upd)
        port_g = {"w": api.DipWeight(_t(gs[0]), 100, 70), "m": _t(gs[1]), "v": _t(gs[2])}
        port_p, st = opt.update(port_g, st, port_p)
        assert_close(st["grad_norm"], ref_s["grad_norm"], 1e-6)
    for a, b in zip(tree.leaves(port_p), jax.tree_util.tree_leaves(ref_p)):
        _leaf_close(a, b, 1e-6)
    for name in ("mu", "nu"):
        for a, b in zip(tree.leaves(st[name]), jax.tree_util.tree_leaves(ref_s[name])):
            _leaf_close(a, b, 1e-6)
    assert st["count"] == int(ref_s["count"]) == 3


def test_adamw_slabs_give_the_same_bits(monkeypatch):
    """The update walks each leaf in slabs of its leading axis, clipping as
    it goes: with slabs of a few elements (rows split, a row larger than a
    slab alone) the parameters and moments equal the one-slab update bit for
    bit, a bf16 leaf and a clipped step included."""
    from repro_torch.optim import adamw

    r = np.random.default_rng(8)

    def tree_of(scale):
        return {"w": api.DipWeight(_t(r.normal(size=(3, 64, 128)) * scale), 100, 70),
                "b16": _t(r.normal(size=(5, 7)) * scale).to(torch.bfloat16), "v": _t(r.normal(size=(9,)) * scale)}

    params, grads = tree_of(0.1), tree_of(30.0)  # norm >> clip_norm: the clip scales every slab
    out = []
    for slab in (adamw.SLAB, 5):
        monkeypatch.setattr(adamw, "SLAB", slab)
        opt = AdamW(lr=1e-2)
        p = tree.map_tree(lambda t: t.clone(), params)
        st = opt.init(p)
        for _ in range(2):
            p, st = opt.update(grads, st, p)
        out.append((p, st))
    (p0, s0), (p1, s1) = out
    for a, b in zip(tree.leaves(p1) + tree.leaves(s1["mu"]) + tree.leaves(s1["nu"]),
                    tree.leaves(p0) + tree.leaves(s0["mu"]) + tree.leaves(s0["nu"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(s1["grad_norm"], s0["grad_norm"]) and float(s0["grad_norm"]) > AdamW().clip_norm


def test_microbatch_matches_the_full_batch(model):
    """Every token valid, so the two halves' mean losses average to the full
    batch's (with a mask the halves would hold different token counts, in
    the reference as here)."""
    _, cfg, _, _ = model
    r = np.random.default_rng(2)
    toks = torch.as_tensor(r.integers(2, cfg.vocab_size, (4, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    res = []
    for mb in (1, 2):
        opt = AdamW(lr=1e-3)
        state = {"params": _port_params(model), "step": 0}
        state["opt_state"] = opt.init(state["params"])
        res.append(tf_model.train_step_fn(cfg, opt, microbatch=mb)(state, batch))
    (a, am), (b, bm) = res
    assert_close(bm["loss"], am["loss"], F32)
    assert_close(bm["grad_norm"], am["grad_norm"], F32)
    for x, y in zip(tree.leaves(b["opt_state"]["mu"]), tree.leaves(a["opt_state"]["mu"])):
        _leaf_close(x, y)


def test_kv_chunk_path_matches_dense_and_reference(model):
    ref_cfg, cfg, params, _ = model
    r = np.random.default_rng(3)
    b, s, h, kvh, d = 2, 16, 4, 2, 32
    q, k, v = (r.normal(size=(b, s, n, d)).astype(np.float32) for n in (h, kvh, kvh))
    pos = np.arange(s)
    dense = attention.attention_core(_t(q), _t(k), _t(v), torch.as_tensor(pos), torch.as_tensor(pos))
    chunked = attention.attention_core(_t(q), _t(k), _t(v), torch.as_tensor(pos), torch.as_tensor(pos),
                                       kv_chunk=4)
    want = ref_attn.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                   jnp.asarray(pos), kv_chunk=4)
    assert_close(chunked, dense, F32)
    assert_close(chunked, want, F32)
    rb, pb = _batch(seed=4)
    want_loss = ref_tf.loss_fn(params, ref_cfg, rb, kv_chunk=4)
    with torch.no_grad():
        got = tf_model.loss_fn(_port_params(model), cfg, pb, kv_chunk=4)
        dense_loss = tf_model.loss_fn(_port_params(model), cfg, pb)
    assert_close(got, want_loss, F32)
    assert_close(got, dense_loss, F32)
    with pytest.raises(ValueError, match="divide"):
        attention.attention_core(_t(q), _t(k), _t(v), torch.as_tensor(pos), torch.as_tensor(pos), kv_chunk=5)


def test_block_remat_reruns_each_forward_and_keeps_the_gradients(monkeypatch):
    """With ``remat="block"`` each block's forward runs again in the
    backward: the DiP dispatches of a step double (6 per layer forward, 6
    more in the backward), the gradients stay the same.  On the card these
    are ``dip_matmul`` launches; here the plain version is counted."""
    ref_cfg, cfg = reduced_configs("pallas_dip", "dip")
    _, np_params = reference_params(ref_cfg)
    calls = []
    real = dip_mod.dip_matmul_plain
    monkeypatch.setattr(dip_mod, "dip_matmul_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, pb = _batch(seed=5)
    grads = {}
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        tparams = params_from_jax(np_params, c, device="cpu")
        leaves = tree.leaves(tparams)
        for leaf in leaves:
            leaf.requires_grad_(True)
        calls.clear()
        loss = tf_model.loss_fn(tparams, c, pb)
        grads[remat] = torch.autograd.grad(loss, leaves)
        assert len(calls) == 6 * cfg.n_layers * (2 if remat == "block" else 1), remat
    for a, b in zip(grads["none"], grads["block"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("what", ["guard", "plan", "grad_transform", "tied"])
def test_training_branches_outside_the_slice_raise(what):
    """A plan over a (data, model) mesh with both axes above 1 still raises
    (training under a plan over one axis: test_torch_sharded_train_*.py);
    a gradient transform trains now (test_torch_compression.py holds it
    against the reference): the compressing step's loss is the plain
    step's, its buffers are shaped like the parameters and carry the
    residual, and a guarded step that skips keeps them; a tied head
    trains now: the fused loss's head is the embedding's transpose, a view
    of its storage (test_torch_train_families.py holds its gradient); so
    does the guard: a guarded step's loss and norm are the unguarded step's
    (test_torch_reliability_guard.py holds its skips)."""
    _, cfg = reduced_configs()
    if what == "guard":
        from repro_torch import reliability
        from repro_torch.data import SyntheticLM
        batch = {k: torch.as_tensor(v) for k, v in
                 SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2).batch(0).items()}
        metrics = []
        for guard in (False, True):
            params = tf_model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            state = {"params": params, "opt_state": AdamW().init(params), "step": 0}
            state = reliability.init_guard_state(state) if guard else state
            state, m = tf_model.train_step_fn(cfg, AdamW(), guard=guard)(state, batch)
            metrics.append(m)
        assert torch.equal(metrics[0]["loss"], metrics[1]["loss"])
        assert torch.equal(metrics[0]["grad_norm"], metrics[1]["grad_norm"])
        assert (metrics[1]["skipped"], metrics[1]["weight_fault"], state["step"]) == (0, 0, 1)
        return
    if what == "grad_transform":
        from repro_torch import reliability, tree
        from repro_torch.data import SyntheticLM
        from repro_torch.distributed import compression_transform
        batch = {k: torch.as_tensor(v) for k, v in
                 SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2).batch(0).items()}
        losses = []
        for gt in (None, compression_transform()):
            params = tf_model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            opt = AdamW(grad_transform=gt)
            state = {"params": params, "opt_state": opt.init(params), "step": 0}
            state, m = tf_model.train_step_fn(cfg, opt)(state, batch)
            losses.append(m["loss"])
        assert torch.equal(losses[0], losses[1])
        err = tree.leaves(state["opt_state"]["transform"])
        assert [e.shape for e in err] == [p.shape for p in tree.leaves(state["params"])]
        assert all(e.dtype == torch.float32 for e in err) and any(bool(e.any()) for e in err)
        # a weight fault between steps: the guarded step skips and keeps the buffers
        state = reliability.init_guard_state(state)
        kept = [e.clone() for e in err]
        with torch.no_grad():
            state["params"]["final_norm"].add_(1.0)
        state, m = tf_model.train_step_fn(cfg, opt, guard=True)(state, batch)
        assert (m["skipped"], m["weight_fault"]) == (1, 1)
        for a, b in zip(tree.leaves(state["opt_state"]["transform"]), kept):
            assert torch.equal(a, b)
        return
    if what == "tied":
        tied = dataclasses.replace(cfg, tie_embeddings=True)
        params = {"embed": torch.randn(tied.padded_vocab, tied.d_model)}
        head = tf_model._natural_head(params, tied)
        assert head.shape == (tied.d_model, tied.padded_vocab)
        assert torch.equal(head, params["embed"].t()) and head.data_ptr() == params["embed"].data_ptr()
        return
    from repro_torch.distributed import abstract_mesh, make_plan

    tp = dataclasses.replace(cfg, sharding="tp", matmul_backend="dip_tp")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf_model.train_step_fn(tp, AdamW(), plan=make_plan(abstract_mesh(data=2, model=2), tp, "train"))
