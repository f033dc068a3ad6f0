"""Host-mode coarsening of the port against the JAX reference.

``coarsen_mode="host"`` repacks every coarse graph tightly with numpy
(``coarsen_once``).  The port's host hierarchy must equal the reference's
host hierarchy level by level (every array, every cmap, every stat), and
hold the same content as the port's own device hierarchy, whose padding
differs (as ``tests/test_coarsen_device.py`` holds the reference's two
modes).  End to end, the host-mode cases of ``tests/torch_parity.py`` must
equal the reference and the committed golden summaries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.core import coarsen as jco  # noqa: E402
from repro.data import graphs as jgen  # noqa: E402
from repro_torch.core import coarsen as co  # noqa: E402
from repro_torch.core import graph as gr  # noqa: E402

GRAPHS = {
    "grid": lambda: jgen.grid2d(20, 20),
    "cube": lambda: jgen.grid3d(8, 8, 8),
    "rmat": lambda: jgen.rmat(9),
    "smallworld": lambda: jgen.small_world(600, seed=2),
}


def _port(jg):
    return gr.from_numpy_arrays(*(np.asarray(a) for a in jg))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_host_hierarchy_matches_reference_and_device(name):
    jg = GRAPHS[name]()
    want = jco.multilevel_coarsen(jg, coarse_target=64, seed=3, mode="host")
    got = co.multilevel_coarsen(_port(jg), coarse_target=64, seed=3,
                                mode="host")
    dev = co.multilevel_coarsen(_port(jg), coarse_target=64, seed=3)
    assert len(got) == len(want) == len(dev) > 2
    for tl, jl, dl in zip(got, want, dev):
        for a, b in zip(tl.graph, jl.graph):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tl.stats == jl.stats
        n, m = tl.stats["n"], tl.stats["m"]
        assert (dl.stats["n"], dl.stats["m"]) == (n, m)
        for f in ("esrc", "adjncy", "adjwgt"):
            assert torch.equal(getattr(tl.graph, f)[:m],
                               getattr(dl.graph, f)[:m]), f
        assert torch.equal(tl.graph.vwgt[:n], dl.graph.vwgt[:n])
        assert torch.equal(tl.graph.xadj[:n + 1], dl.graph.xadj[:n + 1])
        if jl.cmap is None:
            assert tl.cmap is None and dl.cmap is None
        else:
            np.testing.assert_array_equal(tl.cmap.numpy(), np.asarray(jl.cmap))
            assert torch.equal(tl.cmap[:n], dl.cmap[:n])


@pytest.mark.parametrize("seed", [0, 7])
def test_coarsen_once_matches_reference(seed):
    jg = jgen.rmat(8).with_capacity(300, 2000)
    jgc, jcmap = jco.coarsen_once(jg, seed=seed)
    tgc, tcmap = co.coarsen_once(_port(jg), seed=seed)
    for a, b in zip(tgc, jgc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tcmap.numpy(), np.asarray(jcmap))


@pytest.mark.parametrize("name", tp.HOST_CASES)
def test_partition_matches_reference(name):
    tp.assert_matches_reference(name)


@pytest.mark.parametrize("name", tp.HOST_CASES)
def test_golden_is_current(name):
    assert tp.load_golden()[name] == tp.summary(tp.jax_result(name))
