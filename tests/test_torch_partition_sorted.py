"""End-to-end parity of the port's partition() with the JAX reference on
the ``sorted`` backend: grid and cube.

Small grid 16x16 and cube 8^3 cases (``tests/torch_parity.py``) with the
sorted backend, k in {2, 8}, T=2, coarse_target=64: the best parts, every
trial's parts, the cuts, the balance flags, the best trial and every
integer of ``level_stats`` must be equal, and so must the committed golden
summaries.  The reference's three backends walk the same trajectories, so a
sorted case must also equal the dense case of the same graph and k.  The
rmat cases live in a sibling file so the suite's workers share the cost.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402

CASES = tp.case_names("grid16", ("sorted",)) + tp.case_names("cube8",
                                                              ("sorted",))


@pytest.mark.parametrize("name", CASES)
def test_partition_matches_reference(name):
    tp.assert_matches_reference(name)


@pytest.mark.parametrize("name", CASES)
def test_golden_is_current(name):
    golden = tp.load_golden()
    assert golden[name] == tp.summary(tp.jax_result(name))
    assert golden[name] == golden[name.replace("sorted", "dense")]
