"""The golden file's serve cases are current: each equals a live run of the
reference (its standalone runs of the burst and its server's dispatch log).
The dense case is checked live in ``tests/test_torch_serve.py``."""
import pytest
from jax_programs import release_jax_programs  # noqa: F401

pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402


@pytest.mark.parametrize("backend", ["sorted", "ell"])
def test_serve_golden_is_current(backend):
    name = f"serve_{backend}"
    assert tp.load_golden_serve()[name] == tp.jax_serve_case(name)
