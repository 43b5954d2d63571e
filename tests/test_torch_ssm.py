"""The port's Mamba2 SSD block against ``repro.models.ssm`` on
``mamba2_370m.reduced()`` (d_model 128, d_inner 256, 8 heads of 32, state
16, conv width 4, chunk 32), with the reference's layer-0 weights loaded
through ``params_from_jax``: the chunked SSD with a sequence length that is
a multiple of ``ssm_chunk``, one that is not (the inert dt = 0 padding) and
one shorter than a chunk; the chunked SSD continuing from a cache; the O(1)
decode; decode steps reaching the state a chunked prefill reaches; and the
causal conv with a history.  ``pallas_dip`` against the port's ``dip`` and
``xla`` against ``torch``, in float32 and bfloat16.

Tolerance, of max(1, max|reference|), on the block output, the new conv
history and the f32 state alike.  float32: ``TOL`` (1e-5), one block of
f32 arithmetic in another summation order.  bfloat16: ``BF16_BLOCK_TOL``
(3e-2).  The two sides round the conv's bf16 products, sums and SiLU at
different points (XLA's CPU logistic is not torch's: a third of the conv
outputs land one bf16 step apart on the same inputs), and the SSM sums
those outputs into the f32 state over the whole sequence, which then
feeds the gated norm and the out projection: measured up to 1.1e-2 of
the state's scale on these inputs, where a wrong mask, decay or chunk
boundary moves it by order 1.  The conv alone is held to ``TOL`` (8e-3,
one bf16 step).  The port's decode against its own chunked prefill shares
its arithmetic and is held to 1e-5 on the state in either dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import TOL, assert_close
from repro.configs import get_config as ref_get
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config as port_get
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm
from repro_torch.models import transformer as tf_model

BACKENDS = [("pallas_dip", "dip"), ("xla", "torch")]
DTYPES = ["float32", "bfloat16"]
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_BLOCK_TOL = 3e-2
BLOCK_TOL = {"float32": TOL["float32"], "bfloat16": BF16_BLOCK_TOL}


@pytest.fixture(scope="module", params=[(b, d) for b in BACKENDS for d in DTYPES],
                ids=[f"{b[1]}-{d}" for b in BACKENDS for d in DTYPES])
def layer(request):
    (ref_be, port_be), dt = request.param
    kw = dict(param_dtype=dt, compute_dtype=dt)
    ref_cfg = dataclasses.replace(ref_get("mamba2_370m").reduced(), matmul_backend=ref_be, **kw)
    cfg = dataclasses.replace(port_get("mamba2-370m").reduced(), matmul_backend=port_be, **kw)
    params = ref_tf.init_params(jax.random.PRNGKey(3), ref_cfg)
    rl = jax.tree_util.tree_map(lambda t: t[0], params["layers"])
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, cfg, rl, tf_model._layers(tparams["layers"], cfg.n_layers)[0], dt


def _x(shape, seed, dt):
    """The same input on both sides, rounded to ``dt`` once."""
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).astype(dt)
    return x, torch.as_tensor(np.array(x.astype(jnp.float32))).to(_TORCH_DT[dt])


def _caches(ref_cfg, cfg, dt, batch=2):
    return (ref_ssm.init_ssm_cache(batch, ref_cfg, jnp.dtype(dt)),
            ssm.init_ssm_cache(batch, cfg, _TORCH_DT[dt], device="cpu"))


def _cache_close(got, want, tol, dt):
    """The conv history in the compute dtype, the state in f32, both close."""
    assert got["conv"].dtype == _TORCH_DT[dt] and got["state"].dtype == torch.float32
    assert_close(got["conv"], want["conv"], tol)
    assert_close(got["state"], want["state"], tol)
    assert int(got["pos"]) == int(want["pos"])


def test_dims_and_cache_shapes():
    cfg = port_get("mamba2-370m")
    assert ssm.ssm_dims(cfg) == ref_ssm.ssm_dims(ref_get("mamba2_370m"))
    c = ssm.init_ssm_cache(3, cfg, torch.bfloat16, device="cpu")
    assert tuple(c["conv"].shape) == (3, 3, 2304) and c["conv"].dtype == torch.bfloat16
    assert tuple(c["state"].shape) == (3, 32, 64, 128) and c["state"].dtype == torch.float32


@pytest.mark.parametrize("seqlen", [64, 45, 7], ids=["chunk-multiple", "padded", "short"])
def test_chunked_ssd_matches_reference(layer, seqlen):
    """No cache: 64 tokens are two whole chunks of 32, 45 are padded to 64
    with inert steps, 7 make one short chunk; with the residual fused."""
    ref_cfg, cfg, rl, tl, dt = layer
    rx, tx = _x((2, seqlen, cfg.d_model), seqlen, dt)
    want, wc = ref_ssm.ssd_block(rx, rl, ref_cfg, residual=rx)
    got, gc = ssm.ssd_block(tx, tl, cfg, residual=tx)
    assert wc is None and gc is None and got.dtype == _TORCH_DT[dt]
    assert_close(got, want, BLOCK_TOL[dt])
    want, _ = ref_ssm.ssd_block(rx, rl, ref_cfg)
    assert_close(ssm.ssd_block(tx, tl, cfg)[0], want, BLOCK_TOL[dt])


def test_chunked_ssd_continues_from_a_cache(layer):
    """Two chunked calls through one cache (40 tokens, then 24): outputs,
    the conv history and the state after each."""
    ref_cfg, cfg, rl, tl, dt = layer
    rx, tx = _x((2, 64, cfg.d_model), 1, dt)
    rc, tc = _caches(ref_cfg, cfg, dt)
    for lo, hi in ((0, 40), (40, 64)):
        want, rc = ref_ssm.ssd_block(rx[:, lo:hi], rl, ref_cfg, cache=rc)
        got, tc = ssm.ssd_block(tx[:, lo:hi], tl, cfg, cache=tc)
        assert_close(got, want, BLOCK_TOL[dt])
        _cache_close(tc, rc, BLOCK_TOL[dt], dt)


def test_decode_matches_reference(layer):
    """A 20-token chunked prefill, then three O(1) decode steps."""
    ref_cfg, cfg, rl, tl, dt = layer
    rx, tx = _x((2, 23, cfg.d_model), 2, dt)
    rc, tc = _caches(ref_cfg, cfg, dt)
    _, rc = ref_ssm.ssd_block(rx[:, :20], rl, ref_cfg, cache=rc)
    _, tc = ssm.ssd_block(tx[:, :20], tl, cfg, cache=tc)
    for t in range(20, 23):
        want, rc = ref_ssm.ssd_block(rx[:, t:t + 1], rl, ref_cfg, cache=rc, residual=rx[:, t:t + 1])
        got, tc = ssm.ssd_block(tx[:, t:t + 1], tl, cfg, cache=tc, residual=tx[:, t:t + 1])
        assert_close(got, want, BLOCK_TOL[dt])
        _cache_close(tc, rc, BLOCK_TOL[dt], dt)


def test_decode_reaches_the_prefill_state(layer):
    """Token by token through the O(1) path from an empty cache gives the
    outputs, conv history and state of one chunked call over the same 37
    tokens.  Both paths feed the state the same conv outputs, so it agrees
    to f32 rounding in either dtype; the bf16 outputs may round one step
    apart."""
    ref_cfg, cfg, rl, tl, dt = layer
    _, tx = _x((2, 37, cfg.d_model), 4, dt)
    _, tc_chunk = _caches(ref_cfg, cfg, dt)
    whole, tc_chunk = ssm.ssd_block(tx, tl, cfg, cache=tc_chunk)
    _, tc = _caches(ref_cfg, cfg, dt)
    steps = []
    for t in range(37):
        out, tc = ssm.ssd_block(tx[:, t:t + 1], tl, cfg, cache=tc)
        steps.append(out)
    assert_close(torch.cat(steps, dim=1), whole, 1e-5 if dt == "float32" else TOL[dt])
    assert tc["pos"] == tc_chunk["pos"] == 37
    assert_close(tc["conv"], tc_chunk["conv"], 1e-5 if dt == "float32" else TOL[dt])
    assert_close(tc["state"], tc_chunk["state"], 1e-5)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_reference(dt, history):
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 48), (4, 48), (48,), (2, 3, 48))]
    ref = [jnp.asarray(a).astype(dt) for a in arrs]
    port = [torch.as_tensor(np.array(r.astype(jnp.float32))).to(_TORCH_DT[dt]) for r in ref]
    want = ref_ssm._causal_conv(*ref[:3], history=ref[3] if history else None)
    got = ssm._causal_conv(*port[:3], history=port[3] if history else None)
    assert got.dtype == _TORCH_DT[dt]
    assert_close(got, want, TOL[dt])
