"""The port's examples (``examples/torch_*.py``) run on the CPU at a small
size, one case each, and take the card by default: with no ``--device`` and
no card they raise the port's "no CUDA device" error."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
CASES = {
    "torch_quickstart": ["--size", "32", "--k", "4"],
    "torch_partition_gnn_training": [],
    "torch_serve_lm": [],
    "torch_lm_train": ["--steps", "3"],
}


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_cpu(name, capsys, tmp_path):
    mod = _load(name)
    src = (EXAMPLES / f"{name}.py").read_text()
    assert "import jax" not in src and "from repro." not in src
    argv = CASES[name] + (["--ckpt-dir", str(tmp_path)]
                          if name == "torch_lm_train" else [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv)
    out = mod.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    if name == "torch_quickstart":
        assert "balanced=True" in text
    elif name == "torch_partition_gnn_training":
        assert "per-layer comm" in text and out > 0.9, text
    elif name == "torch_serve_lm":
        assert out == 0 and "generated ids[0]" in text
    else:
        assert out == 0 and "[train] finished at step 3" in text
