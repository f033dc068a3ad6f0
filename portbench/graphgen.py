"""Graph generators of the benchmark, built on the device from a seed.

Frozen copies of the port's generators (``repro_torch/data/graphs.py``:
``grid2d``, ``grid3d``, ``small_world``, ``random_geometric``) and the
Graph500 Kronecker generator, rewritten in torch so that a graph of tens of
millions of edges is made on the card in a few large calls instead of a
host loop.  The lattices give the port's arrays exactly; the random
classes draw from a ``torch.Generator`` on the device, so the same seed on
the same card gives the same graph, but not the numpy generator's.

Every generator returns an :class:`EdgeList`: the undirected edges
(``lo < hi``) with their weights (parallel edges summed, self loops
dropped, as the port's ``build_csr_host`` does), the vertex count and the
vertices' coordinates where the class has a geometry.  The plain reference
judges a partition against this list; :func:`to_csr` makes the CSR arrays
that are handed to the partitioner.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class EdgeList(NamedTuple):
    n: int
    lo: torch.Tensor        # int64 (E,), lo < hi, sorted by (lo, hi)
    hi: torch.Tensor        # int64 (E,)
    w: torch.Tensor         # int64 (E,) summed multiplicity
    coords: torch.Tensor | None  # float64 (n, d), or None: no geometry


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    return gen


def undirected(n: int, u: torch.Tensor, v: torch.Tensor,
               coords=None) -> EdgeList:
    """Drop self loops, merge parallel edges (weight = multiplicity)."""
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    key, w = torch.unique(lo * n + hi, return_counts=True)
    return EdgeList(n, key // n, key % n, w, coords)


def to_csr(el: EdgeList):
    """(xadj, adjncy, adjwgt, esrc) as int32, both directions of every edge,
    sorted by (source, destination)."""
    n = el.n
    src = torch.cat([el.lo, el.hi])
    dst = torch.cat([el.hi, el.lo])
    w = torch.cat([el.w, el.w])
    order = torch.argsort(src * n + dst)
    src, dst, w = src[order], dst[order], w[order]
    xadj = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    xadj[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return xadj.int(), dst.int(), w.int(), src.int()


def _lattice(shape, device) -> EdgeList:
    idx = torch.arange(math.prod(shape), device=device).view(*shape)
    u, v = [], []
    for axis in range(len(shape)):
        a = idx.narrow(axis, 0, shape[axis] - 1)
        b = idx.narrow(axis, 1, shape[axis] - 1)
        u.append(a.reshape(-1))
        v.append(b.reshape(-1))
    grids = torch.meshgrid(*[torch.arange(s, device=device,
                                          dtype=torch.float64)
                             for s in shape], indexing="ij")
    coords = torch.stack([g.reshape(-1) for g in grids], 1)
    return undirected(idx.numel(), torch.cat(u), torch.cat(v), coords)


def grid2d(rows: int, cols: int, *, device, seed: int = 0) -> EdgeList:
    """The paper's `grid` class: a 2D lattice."""
    del seed
    return _lattice((rows, cols), device)


def grid3d(nx: int, ny: int, nz: int, *, device, seed: int = 0) -> EdgeList:
    """The paper's `cube` class: a 3D lattice."""
    del seed
    return _lattice((nx, ny, nz), device)


def small_world(n: int, k_ring: int = 4, beta: float = 0.1, *, device,
                seed: int = 0) -> EdgeList:
    """Watts-Strogatz ring, each of the ``k_ring / 2`` forward links rewired
    to a uniform vertex with probability ``beta``.  The coordinate is the
    position on the ring."""
    gen = _generator(device, seed)
    base = torch.arange(n, device=device)
    u, v = [], []
    for off in range(1, k_ring // 2 + 1):
        rewire = torch.rand(n, generator=gen, device=device) < beta
        far = torch.randint(0, n, (n,), generator=gen, device=device)
        u.append(base)
        v.append(torch.where(rewire, far, (base + off) % n))
    coords = base.to(torch.float64).view(n, 1)
    return undirected(n, torch.cat(u), torch.cat(v), coords)


def random_geometric(n: int, radius: float | None = None, *, device,
                     seed: int = 0) -> EdgeList:
    """Random geometric graph in the unit square (finite-element-like):
    points closer than ``radius`` (default 1.8 / sqrt(n)) are joined."""
    gen = _generator(device, seed)
    pts = torch.rand(n, 2, generator=gen, device=device, dtype=torch.float64)
    r = 1.8 / math.sqrt(n) if radius is None else float(radius)
    ncell = int(math.ceil(1.0 / r)) + 1
    gxy = torch.floor(pts / r).long()
    cid = gxy[:, 0] * ncell + gxy[:, 1]
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=ncell * ncell)
    starts = torch.cumsum(counts, 0) - counts
    us, vs = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx, cy = gxy[:, 0] + dx, gxy[:, 1] + dy
            ok = (cx >= 0) & (cx < ncell) & (cy >= 0) & (cy < ncell)
            c = torch.where(ok, cx * ncell + cy, 0)
            cnt = torch.where(ok, counts[c], 0)
            i = torch.repeat_interleave(torch.arange(n, device=device), cnt)
            first = torch.repeat_interleave(starts[c], cnt)
            within = torch.arange(i.numel(), device=device) - \
                torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
            j = order[first + within]
            near = (j > i) & (((pts[i] - pts[j]) ** 2).sum(1) < r * r)
            us.append(i[near])
            vs.append(j[near])
    return undirected(n, torch.cat(us), torch.cat(vs), pts)


def kronecker(scale: int, edge_factor: int = 16, a: float = 0.57,
              b: float = 0.19, c: float = 0.19, *, device,
              seed: int = 0) -> EdgeList:
    """Graph500's Kronecker generator: ``edge_factor << scale`` edges, each
    placed bit by bit in a quadrant drawn with probabilities A, B, C, D,
    then the vertex labels permuted at random.  As the port's ``rmat``
    does, vertices that no edge touches are dropped and the rest numbered
    densely in label order.  No geometry."""
    raw_u, raw_v = kronecker_edges(scale, edge_factor, a, b, c,
                                   device=device, seed=seed)
    keep = raw_u != raw_v
    raw_u, raw_v = raw_u[keep], raw_v[keep]
    used, inv = torch.unique(torch.cat([raw_u, raw_v]), return_inverse=True)
    ne = raw_u.numel()
    return undirected(used.numel(), inv[:ne], inv[ne:], None)


def kronecker_edges(scale: int, edge_factor: int, a: float, b: float,
                    c: float, *, device, seed: int):
    """The raw Graph500 edge list, self loops and repeats included:
    ``edge_factor * 2**scale`` (u, v) pairs over ``2**scale`` labels."""
    gen = _generator(device, seed)
    n = 1 << scale
    ne = edge_factor * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(ne, dtype=torch.int64, device=device)
    v = torch.zeros(ne, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(ne, generator=gen, device=device) > ab
        jj = torch.rand(ne, generator=gen, device=device) > \
            torch.where(ii, c_norm, a_norm)
        u |= ii.long() << bit
        v |= jj.long() << bit
    perm = torch.randperm(n, generator=gen, device=device)
    return perm[u], perm[v]


GENERATORS = {
    "grid2d": grid2d,
    "grid3d": grid3d,
    "small_world": small_world,
    "random_geometric": random_geometric,
    "kronecker": kronecker,
}
