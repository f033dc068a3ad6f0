"""The port's tracing (``repro_torch.trace``) on the CPU.

With no profiler running a span is one shared no-op and ``partition()``
still matches the committed golden summaries.  Under ``torch.profiler`` the
spans nest (``jet.partition`` over ``jet.level`` over ``jet.iter`` over
its steps), there is one ``jet.iter`` a loop iteration and one ``read.*``
span a counted read, and the answer does not change.  The call's record
splits the refinement loop into host issue and device wait, times the
jet_gain wrapper, and the fleet's ``total_s`` sums its phases by name.
Calls on two threads at once keep a record each.  ``_build.load`` adds its
seconds to the compile cache's stats.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.core.partition import (FLEET_PHASES,  # noqa: E402
                                        PartitionConfig, partition,
                                        partition_fleet)
from repro_torch.data import graphs as gen  # noqa: E402

CASE = "grid16_ell_k8"   # a golden case on the ell backend, T = 2
RECORD = ("host_reads", "refine_wait_s", "refine_issue_s", "jet_gain_host_s")


def _run(name=CASE):
    return partition(tp.make_graph(gen, tp.parse(name)[0]),
                     PartitionConfig(**tp.config_kwargs(name)),
                     device="cpu")


def test_off_path_is_one_shared_noop_and_changes_nothing():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("jet.a") is trace.span("jet.b") is trace._NO_SPAN
    with trace.span("jet.a") as inside:
        assert inside is None
    res = _run()
    assert tp.summary(res) == tp.load_golden()[CASE]
    assert set(RECORD) <= set(res.times)
    assert res.times["total_s"] == (res.times["coarsen_s"]
                                    + res.times["initpart_s"]
                                    + res.times["uncoarsen_s"])
    assert trace.current() is trace._IDLE


def _spans(prof):
    """(start, end, name) of the port's spans, by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(("jet.", "read.")))


def _inside(inner, outers):
    return any(s <= inner[0] and inner[1] <= t for s, t, _ in outers)


def test_profiled_spans_nest_count_reads_and_change_nothing():
    from torch.profiler import ProfilerActivity, profile

    plain = _run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _run()
    assert tp.summary(res) == tp.summary(plain)
    assert torch.equal(res.parts, plain.parts)
    assert torch.equal(res.trial_parts, plain.trial_parts)
    spans = _spans(prof)
    by = {}
    for sp in spans:
        by.setdefault(sp[2], []).append(sp)
    assert len(by["jet.partition"]) == 1
    assert len(by["jet.level"]) == len(res.level_stats) == res.levels
    # the loop runs while any trial is active: its iterations are the most
    # a trial ran at the level
    assert len(by["jet.iter"]) == sum(max(st["iterations"])
                                      for st in res.level_stats)
    reads = [sp for sp in spans if sp[2].startswith("read.")]
    assert len(reads) == res.times["host_reads"] > len(by["jet.iter"])
    assert len(by["read.refine.iter"]) == len(by["jet.iter"]) + res.levels
    for name, outer in (("jet.level", "jet.partition"),
                        ("jet.iter", "jet.level"),
                        ("jet.queries", "jet.iter"), ("jet.lp", "jet.iter"),
                        ("jet.apply", "jet.iter"), ("jet.best", "jet.iter"),
                        ("jet.lp.afterburner", "jet.lp"),
                        ("jet.coarsen.level", "jet.coarsen"),
                        ("jet.coarsen", "jet.partition"),
                        ("read.refine.iter", "jet.level"),
                        ("read.coarsen.stats", "jet.coarsen")):
        assert by[name] and all(_inside(sp, by[outer]) for sp in by[name]), \
            (name, outer)
    assert len(by["jet.lp"]) + len(by.get("jet.rebalance.weak", [])) + \
        len(by.get("jet.rebalance.strong", [])) >= len(by["jet.iter"])


@pytest.mark.parametrize("backend", ["ell", "dense"])
def test_refine_issue_and_wait_and_jet_gain_host_time(backend):
    res = _run(f"grid16_{backend}_k8")
    t = res.times
    assert t["refine_issue_s"] >= 0 and t["refine_wait_s"] >= 0
    assert t["refine_issue_s"] + t["refine_wait_s"] <= t["uncoarsen_s"]
    assert isinstance(t["host_reads"], int) and t["host_reads"] > 0
    if backend == "ell":
        assert t["jet_gain_host_s"] > 0
    else:
        assert t["jet_gain_host_s"] == 0


def test_calls_on_two_threads_keep_their_own_records():
    """Two threads each run calls while the other's are open: every
    result counts the reads of a call alone, and no record stays current
    after the calls, on either thread."""
    import threading

    _run()   # the once-a-process reads (rebalancing's table upload)
    solo = _run().times["host_reads"]
    start = threading.Barrier(2)
    found, errors = [], []

    def worker():
        try:
            start.wait()
            for _ in range(2):
                found.append(_run().times["host_reads"])
            assert trace.current() is trace._IDLE
        except BaseException as e:   # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert found == [solo] * 4
    assert trace.current() is trace._IDLE


def test_load_seconds_grow_across_a_load(monkeypatch, tmp_path):
    """A first load adds its seconds beside the hit it counts; a second
    load of the same library adds nothing."""
    from pathlib import Path

    from repro_torch.kernels import _build

    lib = next((Path(torch.__file__).parent / "lib").glob("libc10.*"))
    monkeypatch.setattr(_build, "_CACHE_STATS", _build.CompileCacheStats())
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_library", lambda name: lib)
    stats = _build.cache_stats()
    assert stats.load_s == 0.0
    _build.load("jet_gain")
    first = stats.load_s
    assert first > 0 and stats.snapshot() == {"cache_hits": 1}
    _build.load("jet_gain")
    assert stats.load_s == first


def test_fleet_times_sum_phases_and_hold_the_record():
    from torch.profiler import ProfilerActivity, profile

    graphs = [gen.grid2d(13, 13), gen.grid2d(12, 12), gen.grid2d(8, 8)]
    cfg = PartitionConfig(k=4, trials=2, backend="ell",
                          **tp.FLEET_CONFIG)
    partition_fleet(graphs, cfg, device="cpu")   # the once-a-process reads
    plain = partition_fleet(graphs, cfg, device="cpu")
    t = plain.times
    assert t["total_s"] == sum(t[name] for name in FLEET_PHASES)
    assert set(RECORD) <= set(t) and t["jet_gain_host_s"] > 0
    assert all(r.times["host_reads"] == t["host_reads"]
               and r.times["shared_across_fleet"] for r in plain.results)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = partition_fleet(graphs, cfg, device="cpu")
    spans = _spans(prof)
    assert sum(sp[2] == "jet.fleet" for sp in spans) == 1
    # the bucketing's read, before partition_fleet_stacked, counts too
    assert sum(sp[2].startswith("read.") for sp in spans) == \
        res.times["host_reads"] == t["host_reads"]
    assert any(sp[2] == "read.fleet.sizes" for sp in spans)
    assert [tp.member_summary(r) for r in res.results] == \
        [tp.member_summary(r) for r in plain.results]
