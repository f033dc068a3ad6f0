"""On the card: every cell runs through ``run.py`` as the benchmark runs
it, briefly, and prints a correct result line.  Skips without a card.

    python -m pytest -q -m gpu portbench/check_card.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELLS = [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 21), "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert line["device"]["busy_s"] > 0
