"""The port's torch-only graph suite (``repro_torch.data.graphs.SUITE``):
the same five names, parameters and paper classes as the reference's, and
each graph equal to the reference's array for array.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

from repro.data import graphs as jgen  # noqa: E402
from repro_torch.data import graphs as gen  # noqa: E402


@pytest.mark.parametrize("name", list(jgen.SUITE))
def test_suite_graph_matches_reference(name):
    fac, kw, cls = gen.SUITE[name]
    jfac, jkw, jcls = jgen.SUITE[name]
    assert (fac.__name__, kw, cls) == (jfac.__name__, jkw, jcls)
    assert list(gen.SUITE) == list(jgen.SUITE)
    for a, b in zip(gen.suite_graph(name), jgen.suite_graph(name)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
