"""The port's CLI in fleet mode (``--fleet name[:size[:seed]] ...``) against
the reference CLI: the same report apart from times, the same exit codes
(1 when a member is unbalanced, 2 on duplicate members), and the same
refusals of bad specs and of single-graph flags.
"""
import contextlib
import io
import json

import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

from repro.launch import partition_cli as jcli  # noqa: E402
from repro_torch.launch import partition_cli as cli  # noqa: E402


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    report = json.loads(out.getvalue()) if out.getvalue() else None
    if report:
        report.pop("times")
        for entry in report["fleet"]:
            entry.pop("times")
    return rc, report, err.getvalue()


@pytest.mark.parametrize("argv", [
    ["--fleet", "grid:8", "grid:7", "smallworld:9:3", "--k", "2",
     "--coarse-target", "16", "--allow-unbalanced"],
    # k=3 cannot balance 256 unit vertices at lam=0: both exit 1
    ["--fleet", "grid:16", "grid:15", "--k", "3", "--imbalance", "0.0",
     "--coarse-target", "64", "--trials", "2"],
])
def test_cli_fleet_report_matches_reference(argv):
    rc, report, err = _run(cli.main, argv + ["--device", "cpu"])
    want = _run(jcli.main, argv)
    assert (rc, report) == want[:2]
    assert len(report["fleet"]) == len(argv[1:argv.index("--k")])
    if rc == 1:
        assert "unbalanced" in err


@pytest.mark.parametrize("spec", ["nope:8", "grid:x", "grid:8:1:2",
                                  "edgelist:4"])
def test_cli_fleet_refuses_bad_specs(spec):
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit, match="bad --fleet spec"):
            main(["--fleet", "grid:8", spec, "--device", "cpu"]
                 if main is cli.main else ["--fleet", "grid:8", spec])


def test_cli_fleet_refuses_duplicates_and_single_graph_flags():
    argv = ["--fleet", "grid:8", "grid:8:0", "grid:8:1", "--k", "2"]
    rc, report, err = _run(cli.main, argv + ["--device", "cpu"])
    assert rc == 2 and report is None and "grid:8:0" in err
    assert _run(jcli.main, argv)[0] == 2
    with pytest.raises(SystemExit, match="single-graph options"):
        cli.main(["--fleet", "grid:8", "--out", "x.npy", "--device", "cpu"])
