"""Per-module parity of the PyTorch port against the JAX reference (CPU).

Each test feeds the same numpy-made inputs to ``repro`` and ``repro_torch``
and requires exact equality: the partitioner is integer arithmetic plus a
few float32 comparisons, reproduced in the same order.  The port is
trial-batched, so its (T, N) results are compared with the reference row by
row.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_parity as tp  # noqa: E402

from repro.core import coarsen as jco  # noqa: E402
from repro.core import connectivity as jcn  # noqa: E402
from repro.core import graph as jgr  # noqa: E402
from repro.core import initial as jinit  # noqa: E402
from repro.core import metrics as jme  # noqa: E402
from repro.core import rebalance as jrb  # noqa: E402
from repro.core import refine as jrf  # noqa: E402
from repro.data import graphs as jgen  # noqa: E402
from repro_torch.core import coarsen as co  # noqa: E402
from repro_torch.core import connectivity as cn  # noqa: E402
from repro_torch.core import graph as gr  # noqa: E402
from repro_torch.core import initial as init  # noqa: E402
from repro_torch.core import metrics as me  # noqa: E402
from repro_torch.core import partition as pa  # noqa: E402
from repro_torch.core import rebalance as rb  # noqa: E402
from repro_torch.core import refine as rf  # noqa: E402
from repro_torch.data import graphs as gen  # noqa: E402


def _port(jg):
    return gr.from_numpy_arrays(*(np.asarray(a) for a in jg))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _graph_eq(tg, jg):
    for a, b in zip(tg, jg):
        _eq(a.numpy(), b)


def _padded(jg, dn=37, dm=50):
    return jg.with_capacity(jg.n_max + dn, jg.m_max + dm)


def _rand_parts(jg, k, t, seed, skew=False):
    rng = np.random.default_rng(seed)
    if skew:  # most vertices in part 0: overweight, so rebalancing acts
        parts = np.where(rng.random((t, jg.n_max)) < 0.6, 0,
                         rng.integers(0, k, (t, jg.n_max)))
    else:
        parts = rng.integers(0, k, (t, jg.n_max))
    parts[:, int(jg.n):] = k
    return parts.astype(np.int32)


# -- graph and generators ---------------------------------------------------

GENERATORS = [
    ("grid2d", (9, 7), {}),
    ("grid3d", (4, 5, 3), {}),
    ("rmat", (8,), {"seed": 3}),
    ("small_world", (200,), {"k_ring": 6, "seed": 1}),
    ("random_geometric", (150,), {"seed": 2}),
    ("star", (12,), {}),
    ("complete", (9,), {}),
]


@pytest.mark.parametrize("fn,args,kw", GENERATORS)
def test_generators_match(fn, args, kw):
    _graph_eq(getattr(gen, fn)(*args, **kw), getattr(jgen, fn)(*args, **kw))


def test_build_csr_host_weights_and_capacity():
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 40, (300, 2))
    ew = rng.integers(1, 9, 300)
    vw = rng.integers(1, 4, 40)
    kw = dict(eweights=ew, vweights=vw, n_max=48, m_max=700)
    tg = gr.build_csr_host(40, edges, **kw)
    jg = jgr.build_csr_host(40, edges, **kw)
    _graph_eq(tg, jg)
    for a, b in zip(gr.graph_to_host(tg), jgr.graph_to_host(jg)):
        _eq(a, b)


def test_with_capacity_and_masks():
    jg = jgen.rmat(7)
    tg = _port(jg)
    for cap in [(jg.n_max + 10, jg.m_max + 3), (jg.n_max, jg.m_max)]:
        _graph_eq(tg.with_capacity(*cap), jg.with_capacity(*cap))
    jp = _padded(jg)
    tp = _port(jp)
    _eq(tp.vertex_mask().numpy(), jp.vertex_mask())
    _eq(tp.edge_mask().numpy(), jp.edge_mask())
    _eq(tp.degrees().numpy(), jp.degrees())
    assert int(tp.total_vweight()) == int(jp.total_vweight())


def test_csr_from_edge_runs():
    jg = _padded(jgen.grid2d(6, 6))
    cmap, nc = jco.coarse_map(jg, jco.heavy_edge_matching(jg, seed=1))
    runs = jco.contract_edges(jg, cmap)
    want = jgr.csr_from_edge_runs(*runs[:4], runs[4], runs[5], nc,
                                  n_max=jg.n_max, m_max=jg.m_max)
    t = [torch.tensor(np.asarray(a)) for a in (*runs, nc)]
    got = gr.csr_from_edge_runs(*t[:4], t[4], t[5], t[6], n_max=jg.n_max,
                                m_max=jg.m_max)
    _graph_eq(got, want)


# -- metrics -----------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 8, 33])
def test_metrics_match(k):
    jg = _padded(jgen.rmat(8))
    tg = _port(jg)
    parts = _rand_parts(jg, k, 3, seed=k)
    got_sizes = me.part_sizes(tg, torch.from_numpy(parts), k)
    got_cut = me.cutsize(tg, torch.from_numpy(parts))
    for t in range(3):
        jp = jnp.asarray(parts[t])
        sizes = jme.part_sizes(jg, jp, k)
        _eq(got_sizes[t].numpy(), sizes)
        assert int(got_cut[t]) == int(jme.cutsize(jg, jp))
        W = jg.total_vweight()
        ts = got_sizes[t]
        tW = tg.total_vweight()
        assert float(me.imbalance(ts, tW, k)) == float(jme.imbalance(sizes, W, k))
        for lam in (0.03, 0.1):
            assert bool(me.is_balanced(ts, tW, k, lam)) == \
                bool(jme.is_balanced(sizes, W, k, lam))


@pytest.mark.parametrize("lam", [0.03, 0.05, 0.1, 0.001])
def test_size_limit_float32_order(lam):
    W = np.arange(0, 300000, 7, dtype=np.int32)
    for k in (2, 3, 7, 64, 1000):
        _eq(me.size_limit(torch.from_numpy(W), k, lam).numpy(),
            jme.size_limit(jnp.asarray(W), k, lam))


# -- slot (Eq 4.5) -------------------------------------------------------------

def _xla_log2_exceptions():
    """{float32 bits: value} of the float32 values of int32 losses near
    powers of two at which the reference's floor(log2(x)) differs from the
    float32 exponent of x, from the live reference."""
    x = tp.pow2_window_floats()
    want = np.asarray(jnp.floor(jnp.log2(jnp.asarray(x))).astype(jnp.int32))
    bits = x.view(np.int32)
    differ = want != ((bits >> 23) & 0xFF) - 127
    return dict(zip(bits[differ].tolist(), want[differ].tolist()))


def test_slot_matches_reference():
    """slot() equals the reference on every loss in [-2^16, 2^22] and in the
    +-4096-ulp float32 windows around 2^j, and its correction table is
    exactly the live reference's set of log2 exceptions there."""
    table = _xla_log2_exceptions()
    assert len(table) == 63
    covered = {}
    for first, last, value in rb._XLA_LOG2_FLOOR:
        x = np.arange(first, last + 1, dtype=np.int32).view(np.float32)
        for bits in x[x == np.floor(x)].view(np.int32):
            covered[int(bits)] = value
    assert covered == table
    loss = tp.slot_losses()
    assert loss.min() == -2**16 and loss.max() == 2**31 - 1
    got = rb.slot(torch.from_numpy(loss)).numpy()
    want = np.asarray(jrb.slot(jnp.asarray(loss)))
    assert (got != want).sum() == 0, loss[got != want][:10]


# -- connectivity state --------------------------------------------------------

def _state_eq(ts, js, t, backend):
    _eq(ts.sizes[t].numpy(), js.sizes)
    assert int(ts.cut[t]) == int(js.cut)
    assert int(ts.moves_applied[t]) == int(js.moves_applied)
    if backend == "dense":
        _eq(ts.mat[t].numpy(), js.mat)
    elif backend == "sorted":
        _eq(ts.edge_dst_part[t].numpy(), js.edge_dst_part)
    else:
        _eq(ts.ell_nbr.numpy(), js.ell_nbr)
        _eq(ts.ell_wgt.numpy(), js.ell_wgt)
        _eq(ts.ell_parts[t].numpy(), js.ell_parts)


def _moves(jg, k, t, seed):
    rng = np.random.default_rng(seed)
    move = rng.random((t, jg.n_max)) < 0.25
    move[:, int(jg.n):] = False
    dest = rng.integers(0, k, (t, jg.n_max)).astype(np.int32)
    return move, dest


@pytest.mark.parametrize("backend", cn.BACKENDS)
@pytest.mark.parametrize("k", [2, 8, 33])
def test_conn_state_build_apply_rebuild(backend, k):
    jg = _padded(jgen.rmat(8))
    tg = _port(jg)
    T = 2
    parts = _rand_parts(jg, k, T, seed=k)
    md = int(jnp.max(jg.degrees()))
    ts = cn.build_state(tg, torch.from_numpy(parts), k, backend, max_degree=md)
    move, dest = _moves(jg, k, T, seed=k + 1)
    ts2 = cn.apply_moves(tg, ts, torch.from_numpy(parts),
                         torch.from_numpy(move), torch.from_numpy(dest), k,
                         backend)
    parts2 = np.where(move, dest, parts)
    tr = cn.rebuild_state(tg, ts2, torch.from_numpy(parts2), k, backend)
    tq = cn.state_queries(tg, ts2, torch.from_numpy(parts2), k, backend)
    valid = torch.from_numpy(np.random.default_rng(k).random((T, k)) < 0.5)
    trw = cn.rw_queries(tg, ts2, k, valid, backend)
    trs = cn.rs_queries(tg, ts2, k, valid, backend)
    for t in range(T):
        js = jcn.build_state(jg, jnp.asarray(parts[t]), k, backend,
                             max_degree=md)
        _state_eq(ts, js, t, backend)
        js2 = jcn.apply_moves(jg, js, jnp.asarray(parts[t]),
                              jnp.asarray(move[t]), jnp.asarray(dest[t]), k,
                              backend)
        _state_eq(ts2, js2, t, backend)
        _state_eq(tr, jcn.rebuild_state(jg, js2, jnp.asarray(parts2[t]), k,
                                        backend), t, backend)
        jq = jcn.state_queries(jg, js2, jnp.asarray(parts2[t]), k, backend)
        for a, b in zip(tq, jq):
            _eq(a[t].numpy(), b)
        jv = jnp.asarray(valid[t].numpy())
        for a, b in zip(trw, jcn.rw_queries(jg, js2, k, jv, backend)):
            _eq(a[t].numpy(), b)
        for a, b in zip(trs, jcn.rs_queries(jg, js2, k, jv, backend)):
            _eq(a[t].numpy(), b)
    # incremental == rebuilt, structure and all
    assert torch.equal(ts2.sizes, tr.sizes) and torch.equal(ts2.cut, tr.cut)
    assert torch.equal(ts2.mat, tr.mat)
    assert torch.equal(ts2.edge_dst_part, tr.edge_dst_part)
    assert torch.equal(ts2.ell_parts, tr.ell_parts)


def _shape_only_graph(n_max, m_max):
    """A graph of the given capacities whose arrays are broadcast views
    (no memory): enough for the host-side shape checks."""
    z = torch.zeros(1, dtype=torch.int32)
    return gr.Graph(z.expand(n_max + 1), z.expand(m_max), z.expand(m_max),
                    z.expand(n_max), z.expand(m_max), torch.tensor(0),
                    torch.tensor(0))


def test_sorted_backend_refuses_wrapping_keys(monkeypatch):
    """Past n_max*(k+1) = 2^32-1 the reference's uint32 keys wrap and its
    sorted connectivity is silently wrong; the port refuses the shape.
    Rows whose segment ids would pass int32 are not refused (the reference
    takes them): they reach segment_reduce in chunks of rows that fit."""
    cn.check_sorted(_shape_only_graph(65535, 64), 65536)  # 2^32-1: fits
    big = _shape_only_graph(65536, 64)
    parts = torch.zeros(1, 1, dtype=torch.int32).expand(1, 65536)
    with pytest.raises(ValueError, match="2\\^32-1"):
        cn.sorted_queries(big, parts, 65536)
    with pytest.raises(ValueError, match="2\\^32-1"):
        pa.partition(_shape_only_graph(2**22 + 1, 64),
                     pa.PartitionConfig(k=1024, backend="sorted"),
                     device="cpu")
    cn.check_sorted(_shape_only_graph(64, 2**30), 8)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(-9, 9, (3, 2, 40)).astype(np.int32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 7, (3, 2, 40)), -1)
                           .astype(np.int32))
    want = torch.zeros(6, 7, dtype=torch.int32).scatter_add_(
        1, seg.reshape(6, 40).long(), data.reshape(6, 40)).view(3, 2, 7)
    assert torch.equal(cn._segment_sum(data, seg, 7), want)
    monkeypatch.setattr(cn, "MAX_IDS", 4 * 7)  # four rows per launch
    assert torch.equal(cn._segment_sum(data, seg, 7), want)


# -- refinement moves ------------------------------------------------------------

@pytest.mark.parametrize("backend", cn.BACKENDS)
@pytest.mark.parametrize("variant", rf.VARIANTS)
def test_jetlp_moves_match(backend, variant):
    jg = _padded(jgen.grid3d(6, 6, 5))
    tg = _port(jg)
    k, T = 8, 2
    parts = _rand_parts(jg, k, T, seed=11)
    lock = np.random.default_rng(12).random((T, jg.n_max)) < 0.2
    move, dest = rf.jetlp_moves(tg, torch.from_numpy(parts), k,
                                torch.from_numpy(lock), 0.75, backend, variant)
    for t in range(T):
        jm, jd = jrf.jetlp_moves(jg, jnp.asarray(parts[t]), k,
                                 jnp.asarray(lock[t]), 0.75, backend, variant)
        _eq(move[t].numpy(), jm)
        _eq(dest[t].numpy(), jd)


@pytest.mark.parametrize("backend", cn.BACKENDS)
@pytest.mark.parametrize("k", [2, 8, 33])
@pytest.mark.parametrize("kind", ["jetrw_moves", "jetrs_moves"])
def test_rebalance_moves_match(backend, k, kind):
    jg = _padded(jgen.rmat(8))
    tg = _port(jg)
    T = 2
    parts = _rand_parts(jg, k, T, seed=k + 5, skew=True)
    ev, dest = getattr(rb, kind)(tg, torch.from_numpy(parts), k, 0.03, backend)
    assert ev.any()
    for t in range(T):
        jev, jdest = getattr(jrb, kind)(jg, jnp.asarray(parts[t]), k, 0.03,
                                        backend)
        _eq(ev[t].numpy(), jev)
        _eq(dest[t].numpy(), jdest)


@pytest.mark.parametrize("backend", cn.BACKENDS)
@pytest.mark.parametrize("rebuild_every", [0, 3])
def test_jet_refine_matches(backend, rebuild_every):
    jg = _padded(jgen.grid2d(12, 10))
    tg = _port(jg)
    k = 4
    parts = _rand_parts(jg, k, 2, seed=21, skew=True)
    best, stats = rf.jet_refine(tg, torch.from_numpy(parts), k, backend=backend,
                                rebuild_every=rebuild_every)
    for t in range(2):
        jbest, jstats = jrf.jet_refine(jg, jnp.asarray(parts[t]), k,
                                       backend=backend,
                                       rebuild_every=rebuild_every)
        _eq(best[t].numpy(), jbest)
        for key, val in jstats.items():
            assert int(stats[key][t]) == int(val), key


# -- initial partitioning ---------------------------------------------------------

@pytest.mark.parametrize("method", ["voronoi", "random"])
@pytest.mark.parametrize("k", [2, 8, 33])
def test_initial_partition_batch_matches(method, k):
    jg = _padded(jgen.rmat(7))
    seeds = (0, 5, -3, 123456789)
    got = init.initial_partition_batch(_port(jg), k, seeds, method)
    _eq(got.numpy(), jinit.initial_partition_batch(jg, k, seeds, method))


def test_spread_seeds_k_above_capacity():
    jg = jgen.star(20)
    got = init.spread_seeds(_port(jg), 33, torch.tensor([0, 7]))
    for t, s in enumerate((0, 7)):
        _eq(got[t].numpy(), jinit.spread_seeds(jg, 33, s))
    _eq(init.initial_partition_batch(_port(jg), 33, (0, 7)).numpy(),
        jinit.initial_partition_batch(jg, 33, (0, 7)))


# -- coarsening --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["grid", "rmat", "smallworld"])
@pytest.mark.parametrize("seed", [0, 5000])
def test_matching_and_coarsen_level_match(name, seed):
    jg = _padded({"grid": lambda: jgen.grid2d(12, 12),
                  "rmat": lambda: jgen.rmat(8),
                  "smallworld": lambda: jgen.small_world(300, seed=2)}[name]())
    tg = _port(jg)
    jm = jco.heavy_edge_matching(jg, seed=seed)
    tm = co.heavy_edge_matching(tg, seed=seed)
    _eq(tm.numpy(), jm)
    _eq(co.twohop_matching(tg, tm, 64, seed).numpy(),
        jco.twohop_matching(jg, jm, 64, seed))
    jgc, jcmap = jco.coarsen_level(jg, seed=seed)
    tgc, tcmap = co.coarsen_level(tg, seed=seed)
    _graph_eq(tgc, jgc)
    _eq(tcmap.numpy(), jcmap)
    jp = jnp.asarray(_rand_parts(jgc, 5, 1, seed=1)[0])
    _eq(co.project_partition(tcmap, torch.tensor(np.asarray(jp))).numpy(),
        jco.project_partition(jcmap, jp))


@pytest.mark.parametrize("name", ["grid", "cube", "rmat"])
def test_multilevel_coarsen_hierarchy_matches(name):
    jg = {"grid": lambda: jgen.grid2d(20, 20),
          "cube": lambda: jgen.grid3d(8, 8, 8),
          "rmat": lambda: jgen.rmat(9)}[name]()
    want = jco.multilevel_coarsen(jg, coarse_target=64, seed=3)
    got = co.multilevel_coarsen(_port(jg), coarse_target=64, seed=3)
    assert len(got) == len(want) > 2
    for tl, jl in zip(got, want):
        _graph_eq(tl.graph, jl.graph)
        assert tl.stats == jl.stats
        if jl.cmap is None:
            assert tl.cmap is None
        else:
            _eq(tl.cmap.numpy(), jl.cmap)


def test_shape_schedule_and_capacity_match():
    for n, m in [(1000, 6000), (64, 64), (10**6, 6 * 10**6), (3, 1)]:
        sched = co.shape_schedule(n, m)
        assert sched == jco.shape_schedule(n, m)
        for q in (1, n // 3 + 1, n):
            assert co.select_capacity(sched, q, min(m, q * 3)) == \
                jco.select_capacity(sched, q, min(m, q * 3))


# -- entry points ---------------------------------------------------------------------

def test_partition_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.partition(gen.grid2d(4, 4), pa.PartitionConfig(k=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.refine_only(gen.grid2d(4, 4), np.zeros(16, np.int32),
                       pa.PartitionConfig(k=2))


def test_argmax_argmin_take_first_index():
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (500, 40)))
    _eq(torch.argmax(x, dim=1).numpy(), np.argmax(x.numpy(), axis=1))
    _eq(torch.argmin(x, dim=1).numpy(), np.argmin(x.numpy(), axis=1))
