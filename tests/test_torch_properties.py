"""Hypothesis property tests of the port, mirroring
``tests/test_properties.py`` by role: the Theorem 4.1 bound of slot
bucketing, the equivalence of the three connectivity backends, coarsening
conservation, and rebalancing never growing the largest part.  Small
example counts keep the file cheap; everything runs on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import coarsen, metrics, rebalance  # noqa: E402
from repro_torch.core import connectivity as cn  # noqa: E402
from repro_torch.core.graph import build_csr_host  # noqa: E402

cheap = settings(max_examples=15, deadline=None)


@st.composite
def random_graph(draw, max_n=32):
    n = draw(st.integers(4, max_n))
    n_edges = draw(st.integers(n - 1, min(3 * n, n * (n - 1) // 2)))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    # a spanning path keeps it connected
    path = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    edges = np.concatenate([path, rng.integers(0, n, (n_edges, 2))])
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.integers(1, 8, edges.shape[0])
    vw = rng.integers(1, 4, n)
    pad = draw(st.integers(0, 5))  # padding vertices and edges
    return build_csr_host(n, edges, w, vw, n_max=n + pad,
                          m_max=2 * edges.shape[0] + 3 * pad)


def _parts(g, k, t, seed):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.integers(0, k, (t, g.n_max)).astype(np.int32))
    return torch.where(g.vertex_mask(), p, k)


@cheap
@given(losses=st.lists(st.integers(0, 10_000), min_size=1, max_size=200),
       frac=st.floats(0.05, 0.95))
def test_theorem_4_1_bucketed_prefix_2x_bound(losses, frac):
    """loss(L'_x) <= 2 * loss(L_x): the slot-ordered prefix against the
    exact one, for uniform weights and non-negative losses."""
    losses = np.asarray(losses, dtype=np.int64)
    x = max(1, int(frac * len(losses)))
    exact = np.sort(losses)[:x]
    slots = rebalance.slot(torch.from_numpy(losses).int()).numpy()
    approx = losses[np.argsort(slots, kind="stable")][:x]
    assert approx.sum() <= 2 * exact.sum()


@cheap
@given(g=random_graph(), k=st.integers(2, 5), seed=st.integers(0, 2**31 - 1))
def test_connectivity_backends_equivalent(g, k, seed):
    parts = _parts(g, k, 2, seed)
    want = cn.queries(g, parts, k, "dense")
    for backend in ("sorted", "ell"):
        for a, b in zip(cn.queries(g, parts, k, backend), want):
            assert torch.equal(a[:, :int(g.n)], b[:, :int(g.n)]), backend
        state = cn.build_state(g, parts, k, backend)
        for a, b in zip(cn.state_queries(g, state, parts, k, backend), want):
            assert torch.equal(a[:, :int(g.n)], b[:, :int(g.n)]), backend


@cheap
@given(g=random_graph(), seed=st.integers(0, 1000))
def test_coarsen_conservation(g, seed):
    gc, cmap = coarsen.coarsen_once(g, seed=seed)
    assert int(gc.total_vweight()) == int(g.total_vweight())
    m = int(g.m)
    cu, cv = cmap[g.esrc[:m].long()], cmap[g.adjncy[:m].long()]
    w = g.adjwgt[:m]
    internal = int(w[cu == cv].sum()) // 2
    assert int(gc.adjwgt.sum()) // 2 + internal == int(w.sum()) // 2
    assert int(gc.n) <= int(g.n)


@cheap
@given(g=random_graph(), k=st.integers(2, 5))
def test_rebalance_never_increases_max_part(g, k):
    # everything in part 0: any rebalance iteration must shrink the max
    parts = torch.where(g.vertex_mask(), 0, k).int()[None]
    s0 = metrics.part_sizes(g, parts, k)
    for backend in cn.BACKENDS:
        for fn in (rebalance.jetrw_moves, rebalance.jetrs_moves):
            move, dest = fn(g, parts, k, 0.10, backend)
            parts2 = torch.where(move, dest, parts)
            assert metrics.part_sizes(g, parts2, k).max() <= s0.max()
            d = dest[move]
            if d.numel():
                assert d.min() >= 0 and d.max() < k
