"""The ``sp`` model path of the hybrid family (the reduced Zamba2, with
``in_proj`` replicated and, at ``ssm_state=32``, column-parallel) over a
2-rank gloo world against the reference's single-device model: layer 0's
Mamba2 block, the logits at M = 1, 3, 5 and a chunk, the collectives and
launches, the ``Engine``'s tokens and the pools, as
``test_torch_sharded_sp.py`` holds the dense and ssm families (its doc;
cases and checks in ``_torch_sp_checks.py``).  A file of its own, so that
each file's world stays well inside a test worker's share of the run."""

import pytest

import _torch_sp_checks as checks

NAMES = ("zamba2", "zamba2_col")


@pytest.fixture(scope="module")
def served():
    return checks.serve(NAMES, 32)


@pytest.mark.parametrize("name", NAMES)
def test_block_under_sp_matches_the_reference(served, name):
    checks.check_block(served, name)


@pytest.mark.parametrize("name", NAMES)
def test_forward_under_sp_matches_the_reference(served, name):
    checks.check_forward(served, name)


@pytest.mark.parametrize("name", NAMES)
def test_engine_under_sp_serves_the_reference_tokens(served, name):
    checks.check_engine(served, name)


@pytest.mark.parametrize("name", NAMES)
def test_pools_are_the_tp_pools(served, name):
    checks.check_pools(served, name)
