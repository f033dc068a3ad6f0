"""The port on a CUDA card: the jet_gain and segment_reduce kernels against
their plain versions, and partition() against the CPU run, the committed
golden results and, for the sorted backend, the dense backend.

These tests import no JAX, so they run on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card they skip.  Every comparison is exact, except segment_reduce
on float32: its sums run in another order than the plain version's, so
each output may differ by 1e-5 + 1e-5 * (the sum of |x| over its segment),
and two launches must agree bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.jet_gain import ops  # noqa: E402
from repro_torch.kernels.jet_gain.ref import jet_gain_ref  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref  # noqa: E402,E501

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


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("kind", tp.SEGMENT_KINDS)
@pytest.mark.parametrize("m,f", [(1, 1), (255, 1), (257, 3), (4099, 1),
                                 (100_000, 1), (3000, 128)])
def test_segment_reduce_matches_plain(cuda, m, f, kind, dtype):
    data, seg, s = tp.segment_case(m, f, kind, dtype, seed=m + f, device=cuda)
    want = segment_sum_sorted_ref(data, seg, s)
    before = kernels.launch_counts["segment_reduce"]
    got = sr.segment_sum_sorted(data, seg, s)
    again = sr.segment_sum_sorted(data, seg, s)
    torch.cuda.synchronize()
    assert kernels.launch_counts["segment_reduce"] == before + 2
    assert torch.equal(got, again)
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        bound = 1e-5 + 1e-5 * segment_sum_sorted_ref(data.abs(), seg, s)
        assert bool(((got - want).abs() <= bound).all())


def test_argmax_argmin_take_first_index(cuda):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (500, 40)))
    for fn in (torch.argmax, torch.argmin):
        want = fn(x, dim=1)
        assert torch.equal(fn(x.to(cuda), dim=1).cpu(), want)
        first = [(row == row.max() if fn is torch.argmax else row == row.min())
                 .nonzero()[0, 0] for row in x]
        assert torch.equal(want, torch.stack(first))


@pytest.mark.parametrize("graph", [*tp.GRAPHS, "host"])
def test_partition_on_card_matches_golden_and_cpu(cuda, graph):
    golden = tp.load_golden()
    names = tp.HOST_CASES if graph == "host" else tp.case_names(graph)
    for name in names:
        got = tp.summary(tp.torch_result(name, "cuda"))
        assert got == golden[name], name
        assert got == tp.summary(tp.torch_result(name)), name


def test_sorted_equals_dense_on_card(cuda):
    from repro_torch.core.partition import PartitionConfig, partition
    from repro_torch.data import graphs as gen

    g = gen.rmat(12)
    res = {}
    for backend in ("dense", "sorted"):
        kernels.reset_launch_counts()
        res[backend] = partition(g, PartitionConfig(k=16, trials=2,
                                                    backend=backend))
        launched = kernels.launch_counts["segment_reduce"]
        assert (launched > 0) == (backend == "sorted"), launched
    assert tp.summary(res["sorted"]) == tp.summary(res["dense"])
