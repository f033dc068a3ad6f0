"""The manifest resolves to its files by name, keeps to the benchmark's
rules of its format, and a new cell needs new files and entries only.

    python -m pytest -q portbench/check_manifest.py
"""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent
ROOT = PB.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in m[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in (
            "lower", "higher")
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    assert all(0 < e["bound"] <= 0.25 for e in m["end_to_end"])


@pytest.mark.parametrize("cell", [c["name"] for c in manifest()["workloads"]])
def test_cell_resolves(cell):
    m = manifest()
    c = next(c for c in m["workloads"] if c["name"] == cell)
    conf = next(x for x in m["configs"] if x["name"] == c["config"])
    assert (ROOT / conf["file"]).is_file()
    assert (PB / "traffic" / f"{c['traffic']}.json").is_file()
    assert (PB / "limits" / f"{cell}.json").is_file()
    reported = {e["name"] for e in m["end_to_end"]
                if cell in e.get("workloads", [cell])}
    assert "setup_s" in reported and len(reported) >= 2
    layer = [p for p in m["per_layer"] if cell in p.get("workloads", [])]
    assert layer and all(p["moves"] in reported for p in layer)
    for p in layer:
        assert (PB / "metrics" / f"{p['name']}.py").is_file()


def test_config_reduced_keys_exist():
    for conf in manifest()["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["reduced"] == conf["reduced"]
        assert all(k in data for k in conf["reduced"])


def test_text_fields_are_one_short_line():
    m = manifest()
    texts = [x["why"] for key in ("configs", "workloads") for x in m[key]]
    texts += [p["layer"] for p in m["per_layer"]]
    texts += [c["source"] for c in m["configs"]] + m["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


def test_new_cell_by_new_files_only(tmp_path):
    """A copy of the benchmark with one more cell, a fleet of two grids (a
    new traffic file, a limits file and new manifest entries, no file
    edited), runs that cell."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    m = manifest()
    m["workloads"].append({"name": "mesh.pair", "config": "lowdeg-k64",
                           "traffic": "pair", "chips": 1,
                           "why": "two small grids a fleet call"})
    m["end_to_end"].append({"name": "graphs_per_s", "unit": "graphs/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["mesh.pair"]})
    m["per_layer"].append({"name": "host_reads.fleet", "unit": "reads/graph",
                           "better": "lower", "source": "program_counter",
                           "layer": "fleet", "moves": "graphs_per_s",
                           "workloads": ["mesh.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp_path / "portbench" / "traffic" / "pair.json").write_text(
        json.dumps({"mode": "fleet", "call_seeds": [5, 6], "warm_seed": 1,
                    "graphs": [
            {"gen": "grid2d", "args": {"rows": 30, "cols": 30}},
            {"gen": "grid2d", "args": {"rows": 31, "cols": 33}}]}))
    shutil.copy(PB / "limits" / "mesh.fleet.json",
                tmp_path / "portbench" / "limits" / "mesh.pair.json")
    code = (
        "import json, sys; sys.path[:0] = [sys.argv[1] + '/portbench', "
        "sys.argv[2]]; import bench; from pathlib import Path; "
        "s = bench.Spec(Path(sys.argv[1]), 'mesh.pair'); "
        "s.partitioner['k'] = 8; "
        "print(json.dumps(bench.run(s, 11, 0.1, False, device='cpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          str(ROOT / "src")], capture_output=True,
                         text=True, timeout=600, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] == 2 * line["calls"]
    assert line["calls"] % 2 == 0
    assert set(line["metrics"]) == {"graphs_per_s", "cut_pct", "peak_gib",
                                    "setup_s"}
