"""The port's fleet (``partition_fleet``) on the CPU.

The load-bearing property mirrors ``tests/test_fleet.py``: batching whole
graphs changes the schedule, never the values — every fleet member's parts,
cut, balance, levels, per-trial stats and per-level stats (its own levels)
equal its standalone ``partition()``, on every backend, with mixed bucket
occupancy and an over-padded member.  The reference side is the committed
golden file of the reference's standalone runs (``torch_parity.py
--write``), plus one live call of the reference's own ``partition_fleet``.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402

from repro_torch.core import connectivity as cn  # noqa: E402
from repro_torch.core import graph as gr  # noqa: E402
from repro_torch.core import partition as pa  # noqa: E402
from repro_torch.data import graphs as gen  # noqa: E402


def _graphs():
    return tp.fleet_graphs(gr, gen)


def _fleet(name, **kw):
    cfg = pa.PartitionConfig(**{**tp.fleet_config_kwargs(name), **kw})
    return pa.partition_fleet(_graphs(), cfg, device="cpu"), cfg


@pytest.mark.parametrize("backend", cn.BACKENDS)
@pytest.mark.parametrize("k", tp.FLEET_KS)
def test_fleet_equals_reference_standalone(backend, k):
    """Each member (T=1 and T=2) equals the reference's standalone
    partition() of that graph, bit for bit."""
    golden = tp.load_golden_fleet()
    for t in tp.FLEET_TRIALS:
        name = f"fleet_{backend}_k{k}_t{t}"
        fres, _ = _fleet(name)
        # mixed occupancy: the two big grids share a bucket, and the
        # over-padded member shares one with the 8x8 grid
        assert sorted(b.indices for b in fres.buckets) == [[0, 1], [2, 3]]
        for i, res in enumerate(fres.results):
            assert tp.member_summary(res) == golden[name][i], (name, i)
            assert res.times["shared_across_fleet"] is True


def test_fleet_equals_reference_fleet_live():
    """One T=1 dense fleet against the reference's own partition_fleet:
    buckets, per-member parts, cuts, imbalance and full level stats
    (bucket capacities and lane flags included)."""
    from repro.core import graph as jgr
    from repro.core import partition as jpa
    from repro.data import graphs as jgen

    name = "fleet_dense_k8_t1"
    fres, _ = _fleet(name)
    want = jpa.partition_fleet(tp.fleet_graphs(jgr, jgen),
                               jpa.PartitionConfig(
                                   **tp.fleet_config_kwargs(name)))
    assert [(b.capacity, b.indices, b.levels) for b in fres.buckets] == \
        [(b.capacity, b.indices, b.levels) for b in want.buckets]
    for got, ref in zip(fres.results, want.results):
        np.testing.assert_array_equal(got.parts.numpy(), np.asarray(ref.parts))
        assert (got.cut, got.imbalance, got.balanced, got.levels,
                got.best_trial, got.trial_cuts, got.trial_balanced) == \
            (ref.cut, ref.imbalance, ref.balanced, ref.levels,
             ref.best_trial, ref.trial_cuts, ref.trial_balanced)
        assert got.level_stats == [
            {kk: (bool(v) if kk == "active" else v) for kk, v in st.items()}
            for st in ref.level_stats]


def test_fleet_overpadded_member():
    """A member padded beyond its bucket's capacity gets parts and
    trial_parts back at its own padding, ghost part k beyond n, equal to
    its standalone run."""
    k = 4
    cfg = pa.PartitionConfig(k=k, backend="dense", trials=2, **tp.FLEET_CONFIG)
    graphs = _graphs()
    fres = pa.partition_fleet([graphs[0], graphs[3]], cfg, device="cpu")
    res, solo = fres.results[1], pa.partition(graphs[3], cfg, device="cpu")
    assert res.parts.shape == (tp.FLEET_OVERPAD,)
    assert res.trial_parts.shape == (2, tp.FLEET_OVERPAD)
    assert fres.buckets[1].capacity[0] < tp.FLEET_OVERPAD
    assert torch.equal(res.parts, solo.parts)
    assert torch.equal(res.trial_parts, solo.trial_parts)
    assert (res.trial_parts[:, 64:] == k).all()  # ghost part beyond n
    assert tp.member_summary(res) == tp.member_summary(solo)


def test_fleet_composes_with_trials():
    """B graphs x T trials: per-trial cuts, the selected best and the whole
    trial batch equal the port's standalone trials run, per member, on
    every backend (T = 3 with explicit seeds, so lanes != trials)."""
    for backend in cn.BACKENDS:
        fres, cfg = _fleet(f"fleet_{backend}_k8_t2", trials=3,
                           trial_seeds=(5, 0, 9))
        for g, res in zip(_graphs(), fres.results):
            solo = pa.partition(g, cfg, device="cpu")
            assert tp.member_summary(res) == tp.member_summary(solo), backend
            assert torch.equal(res.trial_parts, solo.trial_parts)
            assert res.imbalance == solo.imbalance


def test_stacked_buckets_with_filler_lanes():
    """partition_fleet_stacked on a fixed ladder with lanes=3: results keyed
    by tag, filler lanes dropped, each equal to partition_fleet's."""
    name = "fleet_ell_k8_t2"
    fres, cfg = _fleet(name)
    schedule = pa.co.shape_schedule(1024, 4096)
    asm = gr.BucketAssembler(schedule, lanes=3)
    for i, g in enumerate(_graphs()):
        asm.add(f"job{i}", g)
    buckets = asm.flush()
    assert any(None in b.tags for b in buckets)
    sres = pa.partition_fleet_stacked(buckets, cfg, schedule, device="cpu")
    assert sorted(sres.results) == [f"job{i}" for i in range(4)]
    for i, res in enumerate(fres.results):
        assert tp.member_summary(sres.results[f"job{i}"]) == \
            tp.member_summary(res)


def test_sorted_fleet_chunks_segment_ids(monkeypatch):
    """Where lanes x trials x segments would pass the int32 ids of one
    segment_reduce launch, the sorted backend launches per chunk of rows
    and gives the same result."""
    name = "fleet_sorted_k8_t2"
    want, _ = _fleet(name)
    monkeypatch.setattr(cn, "MAX_IDS", 3 * 600)  # about three rows a launch
    got, _ = _fleet(name)
    for a, b in zip(got.results, want.results):
        assert tp.member_summary(a) == tp.member_summary(b)


def test_fleet_rejects_empty_and_runs_on_the_card_by_default(monkeypatch):
    with pytest.raises(ValueError):
        pa.partition_fleet([], pa.PartitionConfig(), device="cpu")
    with pytest.raises(ValueError):
        pa.partition_fleet_stacked([], pa.PartitionConfig(), ((64, 64),),
                                   device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pa.partition_fleet([gen.grid2d(4, 4)], pa.PartitionConfig(k=2))
