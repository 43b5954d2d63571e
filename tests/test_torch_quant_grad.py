"""The quantized dispatch's straight-through backward against the
reference's (``_build_quantized_caller``), on the CPU.

* ``api.matmul`` with a ``QuantizedDipWeight`` (int8 W8A8 and fp8-e4m3, a
  ragged K and N so the storage is padded): dx, the rmsnorm gain's and the
  bias / residual cotangents, for every epilogue with and without the
  prologue, against ``jax.grad`` of ``repro.api.matmul`` (Pallas in
  interpret mode for the forward).  Both backwards recompute
  ``epilogue(prologue(x) @ W)`` in f32 against the dequantized, de-sheared
  weight, so they agree to the f32 tolerance (1e-5 of max(1, max|reference|),
  another summation order); the storage and its scales take no gradient.
* The reduced llama3-8b in f32 with the reference's quantized weights:
  ``loss_fn`` (the fused head + CE, and the unfused head through the
  quantized kernel) and the gradients of the float leaves (the embedding,
  the norms, the lm_head's scales through the dequantized head of the fused
  loss; a projection's scales take none), against ``jax.value_and_grad``.
  The loss within 1e-5 of max(1, |reference|), as test_torch_train.py; a
  gradient leaf within 1e-4 of max|reference leaf|, as the int8 forward's
  activation codes may sit one code apart (test_torch_quant_serving.py) and
  the backward then starts from another point.
* A quantized tied head (the reduced Mamba2 in int8, f32) no longer raises:
  the fused loss's head is the float embedding's transpose, and the loss and
  the embedding's gradient (lookup and head summed) match the reference's,
  at the bounds above.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import TOL, assert_close, reduced_configs, reference_params
from repro import api as ref_api
from repro.models import transformer as ref_tf
from repro_torch import api
from repro_torch.configs import get_config as port_get
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import epilogue as epi
from repro_torch.models import transformer as tf_model

F32 = TOL["float32"]
GRAD_TOL = 1e-4
M, K, N = 37, 100, 70
SCHEMES = ["int8", "fp8_e4m3"]


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(requires_grad)


@pytest.mark.parametrize("prologue", ["none", "rmsnorm"])
@pytest.mark.parametrize("epilogue", epi.EPILOGUES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantized_matmul_gradients_match_reference(scheme, epilogue, prologue):
    r = np.random.default_rng(0)
    x = r.normal(size=(2, M, K)).astype(np.float32)
    ws = [(r.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32) for _ in range(2)]
    g = (r.random(K) + 0.5).astype(np.float32)
    s = epi.spec(epilogue)
    op = (r.normal(size=(N,)) if s.bias else r.normal(size=(2, M, N))).astype(np.float32)
    cot = r.normal(size=(2, M, N)).astype(np.float32)
    n_w = 2 if s.dual_weight else 1
    has_op = s.bias or s.residual
    pro = prologue == "rmsnorm"
    rqs = [ref_api.quant.quantize(jnp.asarray(w), scheme) for w in ws[:n_w]]

    def ref_f(xx, gg, oo):
        out = ref_api.matmul(xx, tuple(rqs) if n_w == 2 else rqs[0], epilogue=epilogue,
                             epilogue_operands=(oo,) if has_op else (),
                             prologue=prologue, prologue_operands=(gg,) if pro else ())
        return jnp.sum(out * cot)

    want = jax.grad(ref_f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(op))
    tqs = [api.QuantizedDipWeight(tensor_from_numpy(q.data, "cpu"), _t(q.scale, True), q.d_in, q.d_out,
                                  q.perm_tile, scheme) for q in rqs]
    tx, tg, top = _t(x, True), _t(g, True), _t(op, True)
    out = api.matmul(tx, tuple(tqs) if n_w == 2 else tqs[0], epilogue=epilogue,
                     epilogue_operands=(top,) if has_op else (),
                     prologue=prologue, prologue_operands=(tg,) if pro else ())
    leaves = [tx] + ([tg] if pro else []) + ([top] if has_op else [])
    got = torch.autograd.grad((out * _t(cot)).sum(), leaves + [q.scale for q in tqs], allow_unused=True)
    refs = [want[0]] + ([want[1]] if pro else []) + ([want[2]] if has_op else [])
    for a, b in zip(got, refs):
        assert a.abs().sum() > 0
        assert_close(a, b, F32)
    # the storage is int8 (no gradient) or fp8; the scales take none
    assert all(d is None for d in got[len(leaves):])


def _batch(seed=0, b=2, s=16, vocab=512):
    r = np.random.default_rng(seed)
    toks = r.integers(2, vocab, (b, s)).astype(np.int32)
    labels = toks.copy()
    labels[0, 3] = -100
    return ({k: jnp.asarray(v) for k, v in dict(tokens=toks, labels=labels).items()},
            {k: torch.as_tensor(v) for k, v in dict(tokens=toks, labels=labels).items()})


@pytest.fixture(scope="module", params=SCHEMES)
def qmodel(request):
    scheme = request.param
    backend = api.quant.scheme_info(scheme).backend
    ref_cfg, cfg = reduced_configs(backend, backend, quantization=scheme)
    params, np_params = reference_params(ref_cfg)
    return ref_cfg, cfg, params, np_params


def _float_leaves(tree, prefix=""):
    """(path, tensor) of every float tensor a model's loss can differentiate:
    the plain leaves and each ``QuantizedDipWeight``'s scales."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _float_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, api.QuantizedDipWeight):
        return [(f"{prefix}.scale", tree.scale)]
    return [(prefix, tree)]


def _ref_float_grads(params, ref_cfg, batch, fused):
    """The reference's loss and its gradient for each float leaf, named as
    :func:`_float_leaves` names the port's (its storage leaves are held
    constant)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)

    def name(path):
        keys = [k.key if isinstance(k, jax.tree_util.DictKey) else k.name for k in path]
        return "/" + "/".join(keys[:-1]) + ".scale" if keys[-1] == "scale" else "/" + "/".join(keys)

    is_data = [getattr(path[-1], "name", None) == "data" for path, _ in flat]
    names = [name(path) for (path, _), d in zip(flat, is_data) if not d]

    def f(float_vals):
        it = iter(float_vals)
        leaves = [leaf if d else next(it) for (_, leaf), d in zip(flat, is_data)]
        return ref_tf.loss_fn(jax.tree_util.tree_unflatten(treedef, leaves), ref_cfg, batch, fused_ce=fused)

    loss, grads = jax.value_and_grad(f)([leaf for (_, leaf), d in zip(flat, is_data) if not d])
    return loss, dict(zip(names, grads))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_quantized_loss_and_float_gradients_match_reference(qmodel, fused):
    ref_cfg, cfg, params, np_params = qmodel
    rb, pb = _batch()
    want, want_g = _ref_float_grads(params, ref_cfg, rb, fused)
    tparams = params_from_jax(np_params, cfg, device="cpu")
    leaves = _float_leaves(tparams)
    assert {p for p, _ in leaves} == set(want_g)
    for _, t in leaves:
        t.requires_grad_(True)
    got = tf_model.loss_fn(tparams, cfg, pb, fused_ce=fused)
    grads = torch.autograd.grad(got, [t for _, t in leaves], allow_unused=True)
    assert_close(got.detach(), want, F32)
    for (path, _), g in zip(leaves, grads):
        wg = np.array(want_g[path], np.float32)
        if g is None:  # a projection's scales: the reference's zeros
            assert not wg.any(), path
            continue
        assert g.abs().sum() > 0, f"{path}: zero gradient (a cut grad_fn?)"
        err = float((g.detach() - torch.from_numpy(wg)).abs().max())
        assert err <= GRAD_TOL * max(float(np.abs(wg).max()), 1e-30), f"{path}: max|err| {err}"
    # the fused loss dequantizes the head, so its scales take a gradient; the
    # unfused head runs the quantized kernel, whose scales take none
    assert (grads[[p for p, _ in leaves].index("/lm_head.scale")] is None) == (not fused)


def test_a_tied_head_still_raises():
    """No longer raises: the tied model's quantized loss and its float
    leaves' gradients, the embedding's included, against the reference."""
    kw = dict(param_dtype="float32", compute_dtype="float32", quantization="int8")
    from repro.configs import get_config as ref_get
    ref_cfg = dataclasses.replace(ref_get("mamba2-370m").reduced(), matmul_backend="dip_int8w", **kw)
    cfg = dataclasses.replace(port_get("mamba2-370m").reduced(), matmul_backend="dip_int8w", **kw)
    params, np_params = reference_params(ref_cfg)
    tparams = params_from_jax(np_params, cfg, device="cpu")
    assert tf_model._natural_head(tparams, cfg).data_ptr() == tparams["embed"].data_ptr()
    toks = np.random.default_rng(5).integers(2, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, want_g = jax.value_and_grad(lambda e: ref_tf.loss_fn(
        dict(params, embed=e), ref_cfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}))(params["embed"])
    embed = tparams["embed"].requires_grad_(True)
    t = torch.as_tensor(toks)
    got = tf_model.loss_fn(tparams, cfg, {"tokens": t, "labels": t})
    (g,) = torch.autograd.grad(got, [embed])
    assert_close(got.detach(), want, F32)
    err = float((g - torch.from_numpy(np.array(want_g))).abs().max())
    assert err <= GRAD_TOL * float(np.abs(np.asarray(want_g)).max()), err
