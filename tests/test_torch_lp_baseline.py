"""The port's LP baselines against the JAX package, and the four
properties of ``tests/test_lp_baseline.py`` on the port.

``constrained_lp_refine`` must return the reference's best parts and
best_cost exactly, trial by trial, on grid and cube graphs, and at k=1030,
where its int32 admission key ``dest*2^21 + (2^20 - gain)`` wraps.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lp_baseline as jlp  # noqa: E402
from repro.data import graphs as jgen  # noqa: E402
from repro_torch.core import connectivity as cn  # noqa: E402
from repro_torch.core import graph as gr  # noqa: E402
from repro_torch.core import lp_baseline as lp  # noqa: E402
from repro_torch.core import metrics, refine  # noqa: E402
from repro_torch.data import graphs as gen  # noqa: E402


def _rand_parts(n_max, n, k, t, seed):
    rng = np.random.default_rng(seed)
    p = np.full((t, n_max), k, dtype=np.int32)
    p[:, :n] = rng.integers(0, k, (t, n))
    return p


def _cyclic_parts(n_max, n, k, t):
    """Balanced starts: vertex v in part (v + trial) % k."""
    v = np.arange(n_max)
    p = np.stack([(v + i) % k for i in range(t)]).astype(np.int32)
    p[:, n:] = k
    return p


def _wrap_parts(side, k, t):
    """Shuffled balanced parts on a side x side grid, where each part
    p >= 1024 also holds the four neighbors of a vertex of its own: that
    vertex gains 4 by moving to p, so LP proposes moves whose admission
    key dest*2^21 wraps in int32."""
    n = side * side
    out = []
    for i in range(t):
        p = np.random.default_rng(i).permutation(np.arange(n) % k)
        for j, part in enumerate(range(1024, k)):
            r = c = 4 + 9 * j + i
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                p[(r + dr) * side + c + dc] = part
        out.append(p)
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("graph,k,lam,start", [
    ("grid", 4, 0.05, "random"),
    ("grid", 8, 0.03, "cyclic"),
    ("cube", 8, 0.05, "random"),
    ("cube", 3, 0.10, "cyclic"),
    ("grid64", 1030, 1.5, "wrap"),  # the admission key wraps for k >= 1024
])
def test_constrained_lp_matches_reference(graph, k, lam, start):
    jg = {"grid": lambda: jgen.grid2d(24, 24),
          "cube": lambda: jgen.grid3d(8, 8, 8),
          "grid64": lambda: jgen.grid2d(64, 64)}[graph]()
    tg = gr.from_numpy_arrays(*(np.asarray(a) for a in jg))
    n, T = int(jg.n), 2
    parts0 = {"random": lambda: _rand_parts(jg.n_max, n, k, T, seed=k),
              "cyclic": lambda: _cyclic_parts(jg.n_max, n, k, T),
              "wrap": lambda: _wrap_parts(64, k, T)}[start]()
    p0 = torch.from_numpy(parts0)
    if k >= 1024:  # the wrap is exercised: proposals toward parts >= 1024
        q = cn.dense_queries(tg, p0, k)
        assert ((q.best_conn > q.conn_self) & (q.best_part >= 1024)).any()
    best, info = lp.constrained_lp_refine(tg, p0, k, lam=lam)
    assert bool((info["best_cost"] < 2**31 - 1).all())  # a balanced best
    for t in range(T):
        jbest, jinfo = jlp.constrained_lp_refine(jg, jnp.asarray(parts0[t]), k,
                                                 lam=lam)
        np.testing.assert_array_equal(best[t].numpy(), np.asarray(jbest))
        assert int(info["best_cost"][t]) == int(jinfo["best_cost"])


def test_reexports():
    assert lp.VARIANTS == refine.VARIANTS == (
        "baseline", "locks", "weak_ab", "full_ab", "full")
    assert lp.jetlp_moves is refine.jetlp_moves
    assert lp.variant_flags("full") == (True, True, True)


def _cut(g, parts):
    return int(metrics.cutsize(g, parts)[0])


def test_constrained_lp_improves_and_respects_balance():
    g = gen.grid2d(24, 24)
    k, lam = 4, 0.05
    parts0 = torch.from_numpy(_rand_parts(g.n_max, int(g.n), k, 1, seed=4))
    parts, _ = lp.constrained_lp_refine(g, parts0, k, lam=lam)
    sizes = metrics.part_sizes(g, parts, k)
    assert bool(metrics.is_balanced(sizes, g.total_vweight(), k, lam).all())
    assert _cut(g, parts) < _cut(g, parts0)


def test_jet_escapes_local_minimum_where_clp_is_stuck():
    """Row stripes on a k-divisible grid are a strict single-move local
    minimum: constrained LP cannot move, Jet's afterburner escapes."""
    g = gen.grid2d(24, 24)
    k, lam = 4, 0.05
    parts0 = torch.where(g.vertex_mask(),
                         torch.arange(g.n_max, dtype=torch.int32) % k, k)[None]
    lp_parts, _ = lp.constrained_lp_refine(g, parts0, k, lam=lam, iters=40)
    assert _cut(g, lp_parts) == _cut(g, parts0)  # stuck, by design
    jet_parts, _ = refine.jet_refine(g, parts0, k, lam=lam)
    assert _cut(g, jet_parts) < _cut(g, parts0)


def test_jet_beats_constrained_lp_on_mesh():
    g = gen.grid2d(32, 32)
    k, lam = 4, 0.03
    parts0 = torch.from_numpy(_rand_parts(g.n_max, int(g.n), k, 1, seed=9))
    lp_parts, _ = lp.constrained_lp_refine(g, parts0, k, lam=lam, iters=40)
    jet_parts, _ = refine.jet_refine(g, parts0, k, lam=lam)
    assert _cut(g, jet_parts) <= _cut(g, lp_parts)


def test_full_jetlp_beats_baseline_variant():
    g = gen.grid2d(32, 32)
    k, lam = 8, 0.03
    parts0 = torch.from_numpy(_rand_parts(g.n_max, int(g.n), k, 1, seed=11))
    cuts = {v: _cut(g, refine.jet_refine(g, parts0, k, lam=lam, variant=v)[0])
            for v in ("baseline", "full")}
    assert cuts["full"] <= cuts["baseline"], cuts
