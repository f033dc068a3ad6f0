"""Every cell's traffic runs at a small size on the CPU, through the
kernels' plain versions, and gives a valid result line, traced or not.

    python -m pytest -q portbench/check_cells.py
"""
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402

CELLS = [c["name"] for c in json.loads(
    (tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    spec = tiny.spec(cell)
    out = json.loads(json.dumps(tiny.bench.run(spec, 2**31 + 7, 0.5, False,
                                               device="cpu")))
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == out["calls"] * len(spec.traffic["graphs"])
    assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert all(m["value"] >= 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(spec.limits)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(cell):
    spec = tiny.spec(cell)
    out = json.loads(json.dumps(tiny.bench.run(spec, 3, 0, True,
                                               device="cpu")))
    assert out["correct"] is True and out["calls"] == 1
    names = {m["name"] for m in spec.per_layer}
    assert set(out["metrics"]) <= names
    # the spans and counters a host run reads; device numbers stay out
    assert {n for n in names if n.startswith(("coarsen_s", "uncoarsen_s"))
            } <= set(out["metrics"])
    assert not any(n.startswith(("jet_gain", "device_idle"))
                   for n in out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    spec = tiny.spec(cell)
    a, b = (tiny.bench.make_graphs(spec, "cpu", shift=2**31 + 99)
            for _ in range(2))
    assert all(x.n == y.n and bool((x.lo == y.lo).all())
               and bool((x.w == y.w).all()) for x, y in zip(a, b))


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_the_same_work(cell):
    """Run seeds only rotate the pool of partitioner seeds."""
    spec = tiny.spec(cell)
    pool = spec.traffic["call_seeds"]
    for seed in (0, 7, 2**31 + 5):
        got = [tiny.bench.call_seed(spec, seed, i) for i in range(len(pool))]
        assert sorted(got) == sorted(pool)
