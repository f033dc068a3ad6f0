"""The benchmark's torch generators against the port's numpy ones, and the
Kronecker generator against Graph500's edge count.

    python -m pytest -q portbench/check_generators.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PB = Path(__file__).resolve().parent
sys.path[:0] = [str(PB), str(PB.parent / "src")]

import graphgen  # noqa: E402
import reference  # noqa: E402


def _arrays(g):
    return [np.asarray(a.cpu().numpy(), dtype=np.int64)
            for a in (g.xadj, g.adjncy, g.adjwgt, g.esrc)]


@pytest.mark.parametrize("gen,args", [
    ("grid2d", (7, 9)), ("grid2d", (241, 241)), ("grid3d", (5, 6, 7)),
    ("grid3d", (33, 33, 33))])
def test_lattices_equal_the_ports(gen, args):
    from repro_torch.data import graphs

    want = _arrays(getattr(graphs, gen)(*args))
    el = getattr(graphgen, gen)(*args, device="cpu")
    got = [np.asarray(a.numpy(), dtype=np.int64)
           for a in graphgen.to_csr(el)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("scale,ef", [(8, 16), (10, 16), (12, 8)])
def test_kronecker_edge_count(scale, ef):
    u, v = graphgen.kronecker_edges(scale, ef, 0.57, 0.19, 0.19,
                                    device="cpu", seed=3)
    assert u.numel() == v.numel() == ef << scale
    assert int(u.max()) < 1 << scale and int(u.min()) >= 0
    el = graphgen.kronecker(scale, ef, device="cpu", seed=3)
    assert bool((el.lo < el.hi).all()) and int(el.w.sum()) <= ef << scale
    deg = torch.bincount(torch.cat([el.lo, el.hi]), minlength=el.n)
    assert bool((deg > 0).all())          # isolated vertices dropped


def test_kronecker_repeats_from_its_seed():
    a = graphgen.kronecker(10, 16, device="cpu", seed=2**31 + 5)
    b = graphgen.kronecker(10, 16, device="cpu", seed=2**31 + 5)
    c = graphgen.kronecker(10, 16, device="cpu", seed=2**31 + 6)
    assert torch.equal(a.lo, b.lo) and torch.equal(a.w, b.w)
    assert not (a.lo.numel() == c.lo.numel() and torch.equal(a.lo, c.lo))


def test_random_classes_are_simple_graphs():
    for el in (graphgen.small_world(3000, device="cpu", seed=1),
               graphgen.random_geometric(2048, device="cpu", seed=1)):
        assert bool((el.lo < el.hi).all())
        key = el.lo * el.n + el.hi
        assert torch.equal(key, torch.unique(key))


def test_geometric_edges_are_short():
    el = graphgen.random_geometric(1024, device="cpu", seed=4)
    d = ((el.coords[el.lo] - el.coords[el.hi]) ** 2).sum(1)
    assert bool((d < (1.8 / 32) ** 2).all())


@pytest.mark.parametrize("k", [8, 64])
def test_bisection_of_a_cube(k):
    el = graphgen.grid3d(16, 16, 16, device="cpu")
    parts = reference.bisection(el.coords, el.n, k)
    assert torch.equal(torch.bincount(parts), torch.full((k,), el.n // k))
    side = {8: 8, 64: 4}[k]
    planes = 3 * (16 // side - 1) * 16 * 16
    assert reference.cut(el.lo, el.hi, el.w, parts) == planes
