"""The port's fleet batching (``repro_torch.core.graph``) against the JAX
reference: ``bucket_graphs`` (derived and fixed ladders), ``BucketAssembler``
(natural width, ``lanes=`` with filler lanes tagged None), stack/unstack and
the graph methods on a stacked bucket, on the same numpy-made graphs; plus
hypothesis properties that mirror ``tests/test_bucket_properties.py``.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import coarsen as jco  # noqa: E402
from repro.core import graph as jgr  # noqa: E402
from repro.data import graphs as jgen  # noqa: E402
from repro_torch.core import coarsen as co  # noqa: E402
from repro_torch.core import graph as gr  # noqa: E402
from repro_torch.data import graphs as gen  # noqa: E402

SEEDS = [0, 1, 7]


def _fleet(gen_module, seed: int, count: int = 6):
    """A seeded mixed-family fleet with clustered sizes (so some members
    share rungs) and outliers (so some do not), as the reference's
    property tests make it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        fam = rng.integers(0, 3)
        if fam == 0:
            r = int(rng.integers(5, 14))
            out.append(gen_module.grid2d(r, max(2, r - int(rng.integers(0, 2)))))
        elif fam == 1:
            out.append(gen_module.small_world(int(rng.integers(32, 160)),
                                              seed=int(rng.integers(1 << 16))))
        else:
            out.append(gen_module.random_geometric(
                int(rng.integers(32, 128)), seed=int(rng.integers(1 << 16))))
    return out


def _graph_eq(tg, jg):
    for name, a, b in zip(gr.Graph._fields, tg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("seed", SEEDS)
def test_bucket_graphs_matches_reference(seed):
    schedule, buckets = gr.bucket_graphs(_fleet(gen, seed))
    jschedule, jbuckets = jgr.bucket_graphs(_fleet(jgen, seed))
    assert schedule == jschedule
    assert list(buckets.items()) == list(jbuckets.items())


@pytest.mark.parametrize("seed", SEEDS)
def test_fixed_schedule_matches_reference(seed):
    schedule = co.shape_schedule(512, 4096, align=64)
    assert schedule == jco.shape_schedule(512, 4096, align=64)
    got = gr.bucket_graphs(_fleet(gen, seed), schedule=schedule)
    assert got == jgr.bucket_graphs(_fleet(jgen, seed), schedule=schedule)
    small = co.shape_schedule(64, 256, align=64)
    with pytest.raises(ValueError, match="top rung"):
        gr.bucket_graphs([gen.grid2d(30, 30)], schedule=small)
    with pytest.raises(ValueError, match="top rung"):
        jgr.bucket_graphs([jgen.grid2d(30, 30)], schedule=small)


@pytest.mark.parametrize("lanes", [None, 2, 3])
def test_assembler_matches_reference(lanes):
    """Same buckets, tags (None for filler lanes), orig_n_max and stacked
    arrays as the reference's assembler, over two flushes."""
    schedule = co.shape_schedule(512, 4096, align=64)
    asm, jasm = gr.BucketAssembler(schedule, lanes), \
        jgr.BucketAssembler(schedule, lanes)
    for seed in (3, 4):
        for i, (g, jg) in enumerate(zip(_fleet(gen, seed), _fleet(jgen, seed))):
            asm.add(f"s{seed}g{i}", g)
            jasm.add(f"s{seed}g{i}", jg)
        assert len(asm) == len(jasm)
        got, want = asm.flush(), jasm.flush()
        assert len(asm) == 0 and asm.flush() == []
        assert [(b.capacity, b.tags, b.orig_n_max) for b in got] == \
            [(b.capacity, b.tags, b.orig_n_max) for b in want]
        for b, jb in zip(got, want):
            _graph_eq(b.graph, jb.graph)
    with pytest.raises(ValueError):
        gr.BucketAssembler(schedule, lanes=0)


def test_stack_unstack_and_methods_on_a_bucket():
    """stack/unstack match the reference; the graph methods of a stacked
    bucket read the last axis and equal each lane's own."""
    g1 = gen.grid2d(6, 6)
    g2 = gen.grid2d(5, 5).with_capacity(g1.n_max, g1.m_max)
    jg1 = jgen.grid2d(6, 6)
    jg2 = jgen.grid2d(5, 5).with_capacity(jg1.n_max, jg1.m_max)
    gb = gr.stack_graphs([g1, g2])
    _graph_eq(gb, jgr.stack_graphs([jg1, jg2]))
    assert gb.lanes == (2,) and (gb.n_max, gb.m_max) == (g1.n_max, g1.m_max)
    for b, g in enumerate((g1, g2)):
        _graph_eq(gr.unstack_graph(gb, b), jgr.unstack_graph(
            jgr.stack_graphs([jg1, jg2]), b))
        assert torch.equal(gb.vertex_mask()[b], g.vertex_mask())
        assert torch.equal(gb.edge_mask()[b], g.edge_mask())
        assert torch.equal(gb.degrees()[b], g.degrees())
        assert torch.equal(gb.total_vweight()[b], g.total_vweight())
        wide = gb.with_capacity(g1.n_max + 10, g1.m_max + 7)
        _graph_eq(gr.unstack_graph(wide, b),
                  (jg1, jg2)[b].with_capacity(g1.n_max + 10, g1.m_max + 7))
    with pytest.raises(ValueError):
        gr.stack_graphs([g1, gen.grid2d(5, 5)])
    with pytest.raises(ValueError):
        gr.bucket_graphs([])


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16), count=st.integers(1, 7))
def test_every_member_fits_its_smallest_rung(seed, count):
    graphs = _fleet(gen, seed, count)
    schedule, buckets = gr.bucket_graphs(graphs)
    assigned = {i: cap for cap, idxs in buckets.items() for i in idxs}
    assert sorted(assigned) == list(range(count))
    n_rungs = sorted({nc for nc, _ in schedule})
    m_rungs = sorted({mc for _, mc in schedule})
    for i, g in enumerate(graphs):
        n, m = int(g.n), int(g.m)
        n_cap, m_cap = assigned[i]
        assert n_cap == min(r for r in n_rungs if r >= n)
        assert m_cap == min(r for r in m_rungs if r >= m)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16), lanes=st.sampled_from([None, 1, 2, 4]))
def test_fixed_ladder_is_stable_and_lanes_round_trip(seed, lanes):
    """On a pinned ladder a graph's rung depends only on its own (n, m);
    every flushed lane unstacks to its member at the bucket's capacity,
    and filler lanes are copies of lane 0."""
    graphs = _fleet(gen, seed, 5)
    schedule = co.shape_schedule(512, 4096, align=64)
    _, together = gr.bucket_graphs(graphs, schedule=schedule)
    assigned = {i: cap for cap, idxs in together.items() for i in idxs}
    asm = gr.BucketAssembler(schedule, lanes)
    for i, g in enumerate(graphs):
        assert list(gr.bucket_graphs([g], schedule=schedule)[1]) == \
            [assigned[i]]
        asm.add(i, g)
    seen = []
    for sb in asm.flush():
        if lanes:
            assert len(sb.tags) == lanes
        for b, tag in enumerate(sb.tags):
            back = gr.unstack_graph(sb.graph, b)
            want = graphs[tag if tag is not None else sb.tags[0]] \
                .with_capacity(*sb.capacity)
            for leaf, orig in zip(back, want):
                assert torch.equal(leaf, orig)
            if tag is not None:
                assert sb.capacity == assigned[tag]
                assert sb.orig_n_max[b] == graphs[tag].n_max
                seen.append(tag)
    assert sorted(seen) == list(range(5))
