"""The port's partition server and serve CLI on the CPU, against the reference.

Mirrors ``tests/test_serve.py``: coalescing changes the schedule, never the
values.  Every response equals the reference's standalone ``partition()``
(live for dense, the golden file for every backend); the port's dispatch
log (buckets, lanes, occupancy, member paddings, levels and rungs) and its
shape signatures equal the reference server's; warmup covers a replay
(no new signature); admission rejects oversized graphs with the queue
intact; a failed dispatch reaches its callers as ``RuntimeError``; and the
CLI's request stream equals the reference's for the same spec.
"""
import asyncio
import json
from dataclasses import replace

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402

from repro_torch.core import graph as gr  # noqa: E402
from repro_torch.core import partition as pa  # noqa: E402
from repro_torch.data import graphs as gen  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import partition_serve as ps  # noqa: E402
from repro_torch.launch import serve_cli  # noqa: E402


def _server(name="serve_dense"):
    return ps.PartitionServer(tp.serve_config(ps, pa, name), device="cpu")


def _log(server) -> list:
    return json.loads(json.dumps(list(server.dispatch_log)))


def test_serve_matches_live_reference():
    """Dense burst: each response equals the reference's standalone run
    (live), the dispatch log and signatures equal the live reference
    server's, and the golden file's dense case is current."""
    from repro.launch import partition_serve as jps

    name = "serve_dense"
    server = _server(name)
    got = tp.run_burst(server, tp.serve_burst(gen))
    want = tp.jax_serve_case(name)
    assert [tp.member_summary(r) for r in got] == want["members"]
    assert _log(server) == want["dispatch_log"]
    assert ps.serve_signatures(server.dispatch_log) == \
        jps.serve_signatures(want["dispatch_log"])
    # the two near-sized grids shared a two-lane bucket
    assert server.stats["occupancy_hist"].get(2, 0) >= 1
    assert all(b["lanes"] == 2 for d in server.dispatch_log
               for b in d["buckets"])
    assert tp.load_golden_serve()[name] == want


@pytest.mark.parametrize("backend", ["dense", "sorted", "ell"])
def test_serve_matches_golden(backend):
    """Every backend: responses equal the reference's standalone runs
    (parts, trial parts, cuts, balance, level stats) and the dispatch log
    equals the reference server's, from the golden file."""
    name = f"serve_{backend}"
    server = _server(name)
    burst = tp.serve_burst(gen)
    got = tp.run_burst(server, burst)
    golden = tp.load_golden_serve()[name]
    assert [tp.member_summary(r) for r in got] == golden["members"]
    assert _log(server) == golden["dispatch_log"]
    for (g, _), res in zip(burst, got):
        assert res.parts.shape == (g.n_max,)
        assert res.parts.device.type == "cpu"


def test_warmup_covers_replay():
    """After warmup over the burst's shapes and k in {2, 3}, replaying the
    burst runs no new signature."""
    server = _server()
    burst = tp.serve_burst(gen)
    shapes = [g for g, _ in burst]
    with pytest.raises(ValueError, match="compositions"):
        server.warmup(shapes, ks=(2,), compositions="all")
    before = set(pa._FLEET_SIGNATURES)
    rep = server.warmup(shapes, ks=(2, 3))
    warm = ps.serve_signatures(server.warmup_log)
    assert warm and warm <= pa._FLEET_SIGNATURES
    assert rep["new_executables"] == len(warm - before)
    # subsets: the (64, 128) rung holds 6x6 and 6x5, so three
    # compositions; the (64, 64) rung one; for each k
    assert len(server.warmup_log) == 2 * (3 + 1)
    sigs0 = pa.fleet_signature_count()
    tp.run_burst(server, burst)
    assert pa.fleet_signature_count() == sigs0
    assert ps.serve_signatures(server.dispatch_log) <= warm
    assert server.metrics()["uncoarsen_executables"] == sigs0


def test_oversized_request_rejected_queue_intact():
    """A graph above the ladder's top is rejected at admission and the
    server keeps serving; a graph padded above the top but small enough
    is admitted (one host read) and comes back at its own padding."""
    server = _server()
    n, edges, ew, vw = gr.graph_to_host(gen.grid2d(4, 4))
    overpadded = gr.build_csr_host(n, edges, ew, vw, n_max=1024, m_max=1024)

    async def run():
        async with server:
            with pytest.raises(ValueError, match="ladder"):
                await server.submit(gen.grid2d(30, 30), k=2)
            return await asyncio.gather(server.submit(gen.grid2d(4, 4), k=2),
                                        server.submit(overpadded, k=2))

    small, padded = asyncio.run(run())
    cfg = server.cfg.partition
    solo = pa.partition(gen.grid2d(4, 4), cfg, device="cpu")
    assert tp.member_summary(small) == tp.member_summary(solo)
    solo = pa.partition(overpadded, cfg, device="cpu")
    assert padded.parts.shape == (1024,)
    assert torch.equal(padded.parts, solo.parts)
    assert server.stats["rejected"] == 1
    assert server.stats["responses"] == 2


def test_submit_requires_a_started_server_and_a_card(monkeypatch):
    server = _server()

    async def run():
        with pytest.raises(RuntimeError, match="not started"):
            await server.submit(gen.grid2d(4, 4), k=2)

    asyncio.run(run())
    with pytest.raises(ValueError, match="lanes"):
        ps.PartitionServer(replace(server.cfg, lanes=0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.PartitionServer(server.cfg)


def test_dispatch_failure_reaches_every_caller():
    """A dispatch that raises (sorted keys that would wrap at this k) fails
    each of its requests with RuntimeError; the server keeps serving."""
    server = _server("serve_sorted")
    huge_k = 2**26  # 64 * (k + 1) > 2^32 - 1 on the (64, 64) rung

    async def run():
        async with server:
            failed = await asyncio.gather(
                server.submit(gen.grid2d(4, 4), k=huge_k),
                server.submit(gen.grid2d(3, 3), k=huge_k),
                return_exceptions=True)
            return failed, await server.submit(gen.grid2d(4, 4), k=2)

    failed, res = asyncio.run(run())
    for e in failed:
        assert isinstance(e, RuntimeError)
        assert "dispatch failed" in str(e) and "wrap" in str(e)
    solo = pa.partition(gen.grid2d(4, 4), server.cfg.partition, device="cpu")
    assert tp.member_summary(res) == tp.member_summary(solo)
    assert server.stats["dispatches"] == 1
    assert server.stats["responses"] == 1


def test_requests_racing_stop_fail_not_hang():
    """A request enqueued behind stop()'s sentinel fails, and stop()
    returns."""
    server = _server()

    async def run():
        await server.start()
        stop = asyncio.create_task(server.stop())
        await asyncio.sleep(0)  # stop() has queued its sentinel
        with pytest.raises(RuntimeError, match="stopped before dispatch"):
            await asyncio.wait_for(server.submit(gen.grid2d(4, 4), k=2), 30)
        await asyncio.wait_for(stop, 30)

    asyncio.run(run())
    assert server._task is None and server._pool is None


def test_build_workload_matches_reference():
    """The same spec gives the reference's stream: arrival times, family
    labels, k, trials and graph arrays (families with pinned seeds)."""
    from repro.launch import serve_cli as jcli

    spec = {"families": [{"graph": "geo", "size": 8, "seed": 3, "weight": 2},
                         {"graph": "smallworld", "size": 7, "seed": 1},
                         {"graph": "grid", "size": 6},
                         {"graph": "cube", "size": 20, "weight": 0.5}],
            "ks": [2, 4, 8], "count": 20, "rate_rps": 300.0, "trials": 2,
            "seed": 5}
    got, want = serve_cli.build_workload(spec), jcli.build_workload(spec)
    assert len(got) == len(want) == 20
    for a, b in zip(got, want):
        assert (a["t"], a["family"], a["k"], a["trials"]) == \
            (b["t"], b["family"], b["k"], b["trials"])
        for x, y in zip(a["graph"], b["graph"]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    first = {}
    for r in got:
        first.setdefault(r["family"], r["graph"])
    assert len(first) == 4
    assert serve_cli.workload_shapes(got) == list(first.values())


def test_cli_verify(tmp_path):
    out = tmp_path / "serve.json"
    rc = serve_cli.main(["--device", "cpu", "--families", "grid:8", "grid:7",
                         "grid:4", "--ks", "2,3", "--count", "8", "--rate",
                         "2000", "--window-ms", "50", "--coarse-target", "32",
                         "--verify", "--json", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["bit_identical"] is True
    assert report["replay_covered_by_warmup"] is True
    assert report["post_warmup_new_executables"] == 0
    assert report["device"] == "cpu"
    assert report["server"]["responses"] == report["requests"] == 8
    assert all(b["lanes"] == 2 for d in report["dispatch_buckets"]
               for b in d)


def test_enable_compile_cache_moves_the_library_dir(tmp_path, monkeypatch):
    """The cache directory takes the kernel libraries; on the CPU nothing
    is built or loaded, so the counters stay at zero."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    before = _build.cache_stats().snapshot()
    stats = _build.enable_compile_cache(tmp_path)
    assert stats is _build.cache_stats() is ps.cache_stats()
    assert _build._library("jet_gain").parent == tmp_path
    cfg = replace(tp.serve_config(ps, pa, "serve_ell"),
                  compile_cache=str(tmp_path / "lib"))
    server = ps.PartitionServer(cfg, device="cpu")
    assert _build._library("segment_reduce").parent == tmp_path / "lib"
    tp.run_burst(server, tp.serve_burst(gen))
    delta = ps.CompileCacheStats.delta(before, server.metrics()[
        "compile_cache"])
    assert delta.get("cache_misses", 0) == delta.get("cache_hits", 0) == 0
    assert not any(tmp_path.iterdir())
