"""``distributed.pipeline_apply`` against sequential application, on the
reference test's own case (``tests/test_multidevice.py::
test_pipeline_parallel_equals_sequential``: 4 stages, 8 microbatches of
2 x 16, ``tanh(x @ w + b)``, its inputs drawn with ``jax.random``) in one
4-rank gloo world (``_torch_pipeline_ranks.apply_rank``).

* the output bit-equal to sequential application in the port, and within
  1e-6 of the reference's sequential ``jnp`` run (the reference's own test
  cannot run here: jax 0.9.0 rejects its ``shard_map(check_rep=)``);
* the collective log: 8 + 2 (4 - 1) = 14 ticks, each opening with its
  ``ppermute``, issued before that tick's stage compute (a ``launch`` the
  stage function logs), then the one masked ``psum``; the backward's
  12 reverse hops (one a tick whose received block a later tick reads) and
  the ``psum``'s transpose;
* the gradients of each rank's share of the replicated ``sum(out * cot)``
  against sequential autograd's: its stage's ``w`` and ``b``, and ``x``'s
  on stage 0 alone (every other stage's is 0), within 1e-5 (the
  microbatches' sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.distributed import run_world

import _torch_pipeline_ranks as ranks

N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16
TICKS = N_MICRO + 2 * (N_STAGES - 1)


@pytest.fixture(scope="module")
def case():
    key = jax.random.PRNGKey(0)
    w = jax.random.normal(key, (N_STAGES, D, D)) * 0.3
    b = jax.random.normal(key, (N_STAGES, D)) * 0.1
    x = jax.random.normal(key, (N_MICRO, MB, D))
    ref = x
    for s in range(N_STAGES):
        ref = jnp.tanh(ref @ w[s] + b[s])
    cot = np.random.default_rng(1).normal(size=(N_MICRO, MB, D)).astype(np.float32)
    args = [np.asarray(a, np.float32) for a in (w, b, x)] + [cot]
    return np.asarray(ref), run_world(ranks.apply_rank, N_STAGES, *args, timeout=120)


def test_pipeline_apply_is_bit_equal_to_sequential_application(case):
    ref, got = case
    for r in got:
        assert r["bit_equal"]
        np.testing.assert_array_equal(r["out"], got[0]["out"])  # every rank holds the last stage's outputs
        np.testing.assert_allclose(r["out"], ref, rtol=0, atol=1e-6)


def test_each_tick_sends_before_its_stage_computes(case):
    _, got = case
    for r in got:
        assert r["schedule"] == ["ppermute", "launch"] * TICKS + ["psum"]
        assert r["forward"] == dict(psum=1, all_gather=0, reduce_scatter=0, ppermute=TICKS, all_to_all=0,
                                    launch=TICKS)
        assert r["backward"] == dict(psum=1, all_gather=0, reduce_scatter=0, ppermute=TICKS - 2, all_to_all=0,
                                     launch=0)


def test_gradients_match_sequential_autograd(case):
    _, got = case
    for r in got:
        for name in ("gw", "gb", "gx"):
            np.testing.assert_allclose(r[name], r[f"want_{name}"], rtol=1e-5, atol=1e-5)
    assert not np.any(got[1]["gx"]) and np.any(got[0]["gx"])  # x's cotangent reaches stage 0 alone
