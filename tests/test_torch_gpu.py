"""The port on a CUDA card: the jet_gain kernel against its plain version,
and partition() against the CPU run and the committed golden results.

These tests import no JAX, so they run on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card they skip.  Every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.jet_gain import ops  # noqa: E402
from repro_torch.kernels.jet_gain.ref import jet_gain_ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("t", [None, 4])
@pytest.mark.parametrize("k", [2, 64, 1000])
@pytest.mark.parametrize("d", [4, 6, 37, 300])
def test_kernel_matches_plain(cuda, d, k, t):
    ins = [torch.from_numpy(a) for a in tp.panel(2000, d, k, t, seed=d * k)]
    want = jet_gain_ref(*ins, k)
    before = kernels.launch_counts["jet_gain"]
    got = ops.jet_gain_from_parts(*(x.to(cuda) for x in ins), k)
    torch.cuda.synchronize()
    assert kernels.launch_counts["jet_gain"] == before + 1
    for g_, w in zip(got, want):
        assert torch.equal(g_.cpu(), w)


def test_argmax_argmin_take_first_index(cuda):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (500, 40)))
    for fn in (torch.argmax, torch.argmin):
        want = fn(x, dim=1)
        assert torch.equal(fn(x.to(cuda), dim=1).cpu(), want)
        first = [(row == row.max() if fn is torch.argmax else row == row.min())
                 .nonzero()[0, 0] for row in x]
        assert torch.equal(want, torch.stack(first))


@pytest.mark.parametrize("graph", list(tp.GRAPHS))
def test_partition_on_card_matches_golden_and_cpu(cuda, graph):
    golden = tp.load_golden()
    for name in tp.case_names(graph):
        got = tp.summary(tp.torch_result(name, "cuda"))
        assert got == golden[name], name
        assert got == tp.summary(tp.torch_result(name)), name
