"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port; a run refuses to report when they
are loaded, and without a card.

    python -m pytest -q portbench/check_imports.py
"""
import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE = ("reference.py", "graphgen.py", "costs.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(PB).as_posix()
                                        for p in PB.rglob("*.py")))
def test_no_jax_anywhere(path):
    assert not top_level_imports(PB / path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_port(name):
    assert "repro_torch" not in top_level_imports(PB / name)
    assert top_level_imports(PB / name) <= {"__future__", "math", "typing",
                                           "torch"}


def test_a_loaded_jax_refuses_the_result(monkeypatch):
    import tiny

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(tiny.bench.CellError, match="jax"):
        tiny.bench.run(tiny.spec("mesh.single"), 1, 0.1, False,
                       device="cpu")


def _run(root: Path):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mesh.single",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
