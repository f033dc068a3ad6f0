"""End-to-end parity of the port's partition() with the JAX reference: cube.

Small cube cases (``tests/torch_parity.py``) on the dense and ell backends and
k in {2, 8}, T=2, coarse_target=64: the best parts, every trial's parts,
the cuts, the balance flags, the best trial and every integer of
``level_stats`` must be equal.  Each file also holds its cases of the
committed golden summaries against a live JAX run, so that file (read by
``chip_smoke.py`` on a machine without JAX) cannot go stale.  The other graphs
live in sibling files so the suite's workers share the cost.
"""
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402

CASES = tp.case_names("cube8", ("dense", "ell"))


@pytest.mark.parametrize("name", CASES)
def test_partition_matches_reference(name):
    tp.assert_matches_reference(name)


@pytest.mark.parametrize("name", CASES)
def test_golden_is_current(name):
    assert tp.load_golden()[name] == tp.summary(tp.jax_result(name))
