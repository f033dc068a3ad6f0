"""The comparison that decides ``correct`` fails the control and every
fault a cell can have (``plants.py``), and passes the program; at a small
size on the CPU, with the look for a card skipped.

    python -m pytest -q portbench/check_faults.py
"""
import contextlib
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import plants  # noqa: E402
import tiny  # noqa: E402

CELLS = [c["name"] for c in json.loads(
    (tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]
PLANTS = {"control": plants.control, **plants.FAULTS}


def _run(cell, plant=None, seed=2**31 + 11):
    stack = contextlib.ExitStack()

    def factory(spec, graphs, device):
        system = tiny.bench.System(spec, graphs, device)
        if plant is not None:
            stack.enter_context(plant(system))
        return system

    with stack:
        return tiny.bench.run(tiny.spec(cell), seed, 0.1, False,
                              device="cpu", system_factory=factory)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("plant", sorted(PLANTS))
@pytest.mark.parametrize("cell", CELLS)
def test_plant_is_not_correct(cell, plant):
    out = _run(cell, PLANTS[plant])
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_readings_tool(cell):
    """``readings.py`` reads the program as correct and the control not."""
    import readings

    spec = tiny.spec(cell)
    cache = {}
    sound = readings.read_seed(spec, 2**31 + 3, "cpu", None, cache)
    control = readings.read_seed(spec, 2**31 + 4, "cpu", plants.control,
                                 cache)
    assert sound["correct"] and not control["correct"]
    assert control["balance_excess_pct"] > 0 >= sound["balance_excess_pct"]
