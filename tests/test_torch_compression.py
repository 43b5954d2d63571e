"""Gradient compression (``distributed.compression``) against the reference's
``repro/distributed/compression.py`` and ``AdamW(grad_transform=)``.

* ``quantize_int8`` / ``dequantize_int8`` byte for byte on seeded inputs
  (.5 boundaries, zeros, a single element); ``compression_transform`` over
  50 steps of error feedback: every step's compressed gradients and
  residual buffers byte for byte.
* The counterparts of ``tests/test_compression.py``'s three tests.
* ``AdamW(grad_transform=compression_transform())`` against the
  reference's over 5 updates: the transform's state byte for byte, the
  parameters and moments within 1e-6.
* In one 2-rank gloo world (``_torch_pipeline_ranks.compression_rank``):
  the transform of a rank's slices (a column half, a leading-axis half, a
  whole leaf) with the scales shared by ``comm.pmax`` equal, bit for bit,
  to the slices of the whole leaves' transform over 3 steps (one ``pmax``
  a step); ``compressed_psum`` against its numpy formula, bit for bit, and
  the mean within the reference test's 2%; one compressed training step
  under ``pp`` and under ``tp`` on the reduced llama3-8b in f32 against
  the reference's flat compressed step: the loss and the compressed
  gradients' norm within 1e-4, every parameter within 1e-4 of max(1,
  max|leaf|) but for the elements excused and counted: a gradient whose
  scaled value sits at a rounding boundary can take the neighbouring int8
  code on the other side of a sum in another order, and where that code
  is 0 on one side and +-1 on the other AdamW's first step moves the
  parameter by a whole lr (bound: 2 lr, and at most 1 in 1000 elements).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import family_batch
from repro.configs import get_config as ref_get
from repro.distributed.compression import compression_transform as ref_transform
from repro.distributed.compression import dequantize_int8 as ref_dequantize
from repro.distributed.compression import quantize_int8 as ref_quantize
from repro.models import transformer as ref_tf
from repro.optim import AdamW as RefAdamW
from repro_torch.configs import get_config as port_get
from repro_torch.distributed import run_world
from repro_torch.distributed.compression import compression_transform, dequantize_int8, quantize_int8
from repro_torch.optim import AdamW

import _torch_pipeline_ranks as ranks

LR = 1e-3


def _inputs(seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(33, 17)).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]  # .5 boundaries once scaled by 127 / max
    x[1, 0] = 127.0  # the largest: the scale is exactly 1 + 1e-12
    return [x, np.zeros((5,), np.float32), np.asarray([3.0], np.float32), x * 1e-6, -np.abs(x[:3])]


@pytest.mark.parametrize("i", range(5), ids=["normal", "zeros", "one", "tiny", "negative"])
def test_quantize_and_dequantize_byte_for_byte(i):
    x = _inputs(0)[i]
    q_ref, s_ref = ref_quantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert s.dtype == torch.float32 and s.numpy().tobytes() == np.asarray(s_ref, np.float32).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy().view(np.uint32),
                                  np.asarray(ref_dequantize(q_ref, s_ref)).view(np.uint32))


def test_error_feedback_byte_for_byte_over_50_steps():
    shapes = {"a": (8, 16), "b": {"c": (33,), "d": (2, 3, 4)}}
    r = np.random.default_rng(1)

    def draw():
        return jax.tree_util.tree_map(lambda s: r.normal(size=s).astype(np.float32), shapes,
                                      is_leaf=lambda s: isinstance(s, tuple))

    ref, port = ref_transform(), compression_transform()
    zero = jax.tree_util.tree_map(lambda a: np.zeros_like(a), draw())
    e_ref = ref.init(jax.tree_util.tree_map(jnp.asarray, zero))
    e_port = port.init(jax.tree_util.tree_map(torch.from_numpy, zero))
    for _ in range(50):
        g = draw()
        out_ref, e_ref = ref.fn(jax.tree_util.tree_map(jnp.asarray, g), e_ref)
        out_port, e_port = port.fn(jax.tree_util.tree_map(torch.from_numpy, g), e_port)
        for a, b in zip(jax.tree_util.tree_leaves(out_ref) + jax.tree_util.tree_leaves(e_ref),
                        jax.tree_util.tree_leaves(out_port) + jax.tree_util.tree_leaves(e_port)):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(128,)).astype(np.float32))
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-6


def test_error_feedback_carries_residual():
    gt = compression_transform()
    state = gt.init({"w": torch.zeros(4)})
    g = torch.tensor([1e-4, 2e-4, -1e-4, 1.0])  # tiny grads vanish in int8
    total = torch.zeros(4)
    gt.fn({"w": g.clone()}, state)
    for _ in range(2000):  # the residual accumulates and eventually releases the small components
        out, state = gt.fn({"w": g.clone()}, state)
        total += out["w"]
    np.testing.assert_allclose((total / 2000).numpy(), g.numpy(), rtol=0.05, atol=2e-5)


def test_compressed_training_still_converges():
    opt = AdamW(lr=0.05, weight_decay=0.0, clip_norm=1e9, grad_transform=compression_transform())
    params = {"w": torch.tensor([4.0, -3.0])}
    state = opt.init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        params, state = opt.update({"w": 2 * (params["w"] - target)}, state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_adamw_with_the_transform_matches_the_reference_over_5_updates():
    r = np.random.default_rng(2)
    p0 = {"w": r.normal(size=(6, 5)).astype(np.float32), "v": r.normal(size=(7,)).astype(np.float32)}
    ref_opt = RefAdamW(lr=1e-2, grad_transform=ref_transform())
    opt = AdamW(lr=1e-2, grad_transform=compression_transform())
    rp = jax.tree_util.tree_map(jnp.asarray, p0)
    rs = ref_opt.init(rp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ps = opt.init(pp)
    for _ in range(5):
        g = {k: r.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        upd, rs = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        rp = jax.tree_util.tree_map(lambda a, u: a + u, rp, upd)
        pp, ps = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
        for k in p0:
            assert np.asarray(rs["transform"][k]).tobytes() == ps["transform"][k].numpy().tobytes()
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(ps["mu"][k].numpy(), np.asarray(rs["mu"][k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ps["nu"][k].numpy(), np.asarray(rs["nu"][k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(ps["grad_norm"]), float(rs["grad_norm"]), rtol=1e-6)
    with pytest.raises(ValueError, match="transformed gradients' norm"):
        opt.update({k: torch.from_numpy(v) for k, v in p0.items()}, ps, pp, gnorm=torch.ones(()))


def test_opt_state_from_jax_reads_the_transform_state():
    from repro_torch.convert import opt_state_from_jax

    r = np.random.default_rng(4)
    params = {"w": jnp.asarray(r.normal(size=(3, 4)).astype(np.float32))}
    ref_opt = RefAdamW(lr=1e-2, grad_transform=ref_transform())
    upd, rs = ref_opt.update({"w": jnp.asarray(r.normal(size=(3, 4)).astype(np.float32))}, ref_opt.init(params),
                             params)
    got = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, rs), device="cpu")
    assert set(got) == {"mu", "nu", "count", "grad_norm", "transform"} and got["count"] == 1
    assert got["transform"]["w"].numpy().tobytes() == np.asarray(rs["transform"]["w"]).tobytes()


# ------------------------------------------------------------- under a plan ---
def _reference_compressed_step():
    """The reference's flat compressed step on the reduced llama3-8b in f32
    (``xla`` on DiP storage, so that the port's ``dip`` converts leaf for
    leaf), batch 4 x 32: the numpy parameters before it and after it, the
    batch, the loss and the norm."""
    rcfg = dataclasses.replace(ref_get("llama3-8b").reduced(), matmul_backend="xla", dip_weights=True,
                               **ranks.F32)
    pcfg = dataclasses.replace(port_get("llama3-8b").reduced(), **ranks.F32)
    params = ref_tf.init_params(jax.random.PRNGKey(0), rcfg)
    opt = RefAdamW(lr=LR, grad_transform=ref_transform())
    rb, _ = family_batch(pcfg, step=1, batch=4)
    state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    after, m = jax.jit(ref_tf.train_step_fn(rcfg, opt, fused_ce=False))(state, rb)
    return (jax.tree_util.tree_map(np.asarray, params), {k: np.asarray(v) for k, v in rb.items()},
            jax.tree_util.tree_map(np.asarray, after["params"]), float(m["loss"]), float(m["grad_norm"]))


# one compressed step's collectives a rank: pp as test_torch_pipeline_train.py's step, tp as
# test_torch_sharded_train_models.py's ("tp", "dense"), and one pmax of the leaves' maxima; the
# norm's psum is taken once, of the compressed gradients
COMPRESSED_COUNTS = {
    "pp": dict(psum=4, all_gather=0, reduce_scatter=0, ppermute=6, all_to_all=0, launch=0, pmax=1),
    "tp": dict(psum=12, all_gather=1, reduce_scatter=1, ppermute=0, all_to_all=0, launch=9, pmax=1),
}


@pytest.fixture(scope="module")
def world():
    r = np.random.default_rng(3)
    whole = [{"w": r.normal(size=(6, 8)).astype(np.float32), "v": r.normal(size=(4, 5)).astype(np.float32),
              "u": r.normal(size=(7,)).astype(np.float32)} for _ in range(3)]
    psum_x = (np.arange(16, dtype=np.float32).reshape(2, 8) / 7.0)
    np_params, batch, after, loss, gnorm = _reference_compressed_step()
    cases = [{"cfg": dict(arch="llama3-8b", sharding=s, matmul_backend="dip" if s == "pp" else "dip_tp", **ranks.F32),
              "params": np_params, "batch": batch, "lr": LR} for s in ("pp", "tp")]
    got = run_world(ranks.compression_rank, 2, whole, cases, psum_x, timeout=240)
    return got, psum_x, (after, loss, gnorm)


def test_a_slice_compresses_as_the_whole_leaf_with_the_shared_scale(world):
    got, _, _ = world
    for r in got:
        assert r["slice_equal"] == [True, True, True]
        assert r["slice_counts"]["pmax"] == 3 and r["slice_counts"]["psum"] == 0  # one pmax a step


def test_compressed_psum_is_the_numpy_formula(world):
    got, x, _ = world
    scale = np.max(np.abs(x), axis=1).astype(np.float32) / np.float32(127.0) + np.float32(1e-12)
    scale = np.float32(scale.max())
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int32)
    want = (q.sum(0).astype(np.float32) * scale / np.float32(2.0)).astype(np.float32)
    for r in got:
        assert r["psum"].tobytes() == want.tobytes()
        np.testing.assert_allclose(r["psum"], x.mean(0), rtol=0.02)  # the reference test's bound
        assert r["psum_counts"]["pmax"] == 1 and r["psum_counts"]["psum"] == 1


@pytest.mark.parametrize("strategy", ["pp", "tp"])
def test_a_compressed_step_under_a_plan_matches_the_reference_compressed_step(world, strategy):
    from repro_torch import tree
    from repro_torch.convert import params_from_jax

    got, _, (after, loss, gnorm) = world
    for r in got:
        g = r[strategy]
        assert abs(g["loss"] - loss) <= 1e-4 * max(1.0, abs(loss))
        assert abs(g["grad_norm"] - gnorm) <= 1e-4 * max(1.0, gnorm)
        assert g["counts"] == COMPRESSED_COUNTS[strategy]
    assert got[0][strategy]["loss"] == got[1][strategy]["loss"]
    cfg = dataclasses.replace(port_get("llama3-8b").reduced(), matmul_backend="dip", **ranks.F32)
    want = [t.numpy() for t in tree.leaves(params_from_jax(after, cfg, device="cpu"))]
    assert len(want) == len(got[0][strategy]["params"])
    excused = total = 0
    for a, b in zip(got[0][strategy]["params"], want):
        err = np.abs(a - b)
        base = 1e-4 * max(1.0, float(np.abs(b).max()))
        over = err > base
        assert float(err.max()) <= base + 2 * LR, float(err.max())
        excused += int(over.sum())
        total += err.size
    assert excused <= total // 1000, (excused, total)
