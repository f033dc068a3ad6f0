"""The port's refine_only() and CLI against the JAX reference.

The CLI's JSON report must equal the reference CLI's apart from ``times``,
and both must agree on the exit code, including the nonzero exit of an
unbalanced result.
"""
import contextlib
import io
import json

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

from repro.core import partition as jpa  # noqa: E402
from repro.data import graphs as jgen  # noqa: E402
from repro.launch import partition_cli as jcli  # noqa: E402
from repro_torch.core import partition as pa  # noqa: E402
from repro_torch.data import graphs as gen  # noqa: E402
from repro_torch.launch import partition_cli as cli  # noqa: E402


@pytest.mark.parametrize("backend", ["dense", "sorted", "ell"])
def test_refine_only_matches_reference(backend):
    rng = np.random.default_rng(4)
    parts0 = rng.integers(0, 4, 16 * 16).astype(np.int32)
    cfg = dict(k=4, backend=backend)
    got = pa.refine_only(gen.grid2d(16, 16), parts0, pa.PartitionConfig(**cfg),
                         device="cpu")
    want = jpa.refine_only(jgen.grid2d(16, 16), parts0,
                           jpa.PartitionConfig(**cfg))
    np.testing.assert_array_equal(got.parts.numpy(), np.asarray(want.parts))
    for key in ("cut", "imbalance", "balanced", "levels", "level_stats"):
        assert getattr(got, key) == getattr(want, key), key


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    report = json.loads(out.getvalue())
    report.pop("times")
    return rc, report


@pytest.mark.parametrize("argv", [
    ["--graph", "grid", "--size", "16", "--k", "4", "--trials", "2",
     "--coarse-target", "64", "--backend", "ell"],
    ["--graph", "rmat", "--size", "64", "--k", "8", "--coarse-target", "64",
     "--backend", "sorted", "--coarsen-mode", "host"],
    # k=3 cannot balance 256 unit vertices at lam=0: both exit 1
    ["--graph", "grid", "--size", "16", "--k", "3", "--imbalance", "0.0",
     "--coarse-target", "64"],
])
def test_cli_report_matches_reference(argv):
    got = _run(cli.main, argv + ["--device", "cpu"])
    assert got == _run(jcli.main, argv)
