"""Synthetic graph generators mirroring the paper's test-set classes.

Copies of ``repro.data.graphs``: the same numpy code, so the same arguments
and seed give the same arrays.  2D/3D lattices (the paper's `grid`/`cube`),
RMAT power-law graphs (social/web-like), Watts-Strogatz small-world rings,
and random geometric graphs (finite-element-like), plus the reference's
five-graph ``SUITE``.  Graphs are built on the CPU; move them with
:meth:`Graph.to`.  One generator is the port's own:
:func:`planted_partition`, a labelled community graph drawn in O(m) at
sizes where the reference's dense ``community_graph`` cannot go (a
Reddit-sized graph for GraphSAGE's neighbor sampler).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from repro_torch.core.graph import Graph, build_csr_host


def grid2d(rows: int, cols: int, **kw) -> Graph:
    """The paper's `grid` class: 2D lattice, diameter O(sqrt(n))."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    e = [np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
         np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)]
    return build_csr_host(rows * cols, np.concatenate(e), **kw)


def grid3d(nx: int, ny: int, nz: int, **kw) -> Graph:
    """The paper's `cube` class: 3D lattice, diameter O(n^(1/3))."""
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    e = [np.stack([idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()], 1),
         np.stack([idx[:, :-1, :].ravel(), idx[:, 1:, :].ravel()], 1),
         np.stack([idx[:-1, :, :].ravel(), idx[1:, :, :].ravel()], 1)]
    return build_csr_host(nx * ny * nz, np.concatenate(e), **kw)


def rmat(scale: int, edge_factor: int = 8, a=0.57, b=0.19, c=0.19, seed: int = 0,
         **kw) -> Graph:
    """RMAT power-law generator (Graph500 parameters) — social/web-like."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    ne = n * edge_factor
    src = np.zeros(ne, dtype=np.int64)
    dst = np.zeros(ne, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(ne)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(ne)
        thresh = np.where(src_bit == 0, a / (a + b), c / (1.0 - a - b))
        dst_bit = (r2 >= thresh).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    edges = np.stack([src, dst], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    # drop isolated vertices by compacting ids
    used = np.unique(edges)
    remap = -np.ones(n, dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    edges = remap[edges]
    return build_csr_host(used.shape[0], edges, **kw)


def small_world(n: int, k_ring: int = 4, beta: float = 0.1, seed: int = 0,
                **kw) -> Graph:
    """Watts-Strogatz ring with rewiring — small diameter, regular-ish."""
    rng = np.random.default_rng(seed)
    base = np.arange(n)
    e = []
    for off in range(1, k_ring // 2 + 1):
        dst = (base + off) % n
        rewire = rng.random(n) < beta
        dst = np.where(rewire, rng.integers(0, n, n), dst)
        e.append(np.stack([base, dst], 1))
    edges = np.concatenate(e)
    edges = edges[edges[:, 0] != edges[:, 1]]
    return build_csr_host(n, edges, **kw)


def random_geometric(n: int, radius: float | None = None, seed: int = 0,
                     **kw) -> Graph:
    """Random geometric graph in the unit square — FEM-mesh-like."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    if radius is None:
        radius = 1.8 / np.sqrt(n)
    cell = radius
    gx = (pts[:, 0] // cell).astype(np.int64)
    gy = (pts[:, 1] // cell).astype(np.int64)
    ncell = int(np.ceil(1.0 / cell)) + 1
    cell_id = gx * ncell + gy
    order = np.argsort(cell_id, kind="stable")
    buckets = defaultdict(list)
    for i in order:
        buckets[cell_id[i]].append(i)
    edges = []
    for i in range(n):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cid = (gx[i] + dx) * ncell + (gy[i] + dy)
                for j in buckets.get(cid, ()):
                    if j > i and np.sum((pts[i] - pts[j]) ** 2) < radius**2:
                        edges.append((i, j))
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    return build_csr_host(n, edges, **kw)


def planted_partition(n: int, n_blocks: int, avg_degree: int,
                      p_in: float = 0.8, seed: int = 0):
    """Labelled community graph in O(m) memory: each vertex draws
    ``avg_degree // 2`` partners, a share ``p_in`` of them uniform inside its
    own block and the rest uniform over all vertices; self loops and repeated
    pairs are dropped.  So every vertex has degree >= about avg_degree / 2,
    and the mean is about ``avg_degree``.  Returns (edges (m, 2) int64, both
    directions, as ``data/synthetic.py:community_graph``; labels (n,) int32,
    the block of each vertex)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_blocks, n)
    members = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=n_blocks)
    starts = np.cumsum(sizes) - sizes
    src = np.repeat(np.arange(n, dtype=np.int64), avg_degree // 2)
    lab = labels[src]
    inside = members[starts[lab] + (rng.random(src.size)
                                    * sizes[lab]).astype(np.int64)]
    anywhere = rng.integers(0, n, src.size)
    dst = np.where(rng.random(src.size) < p_in, inside, anywhere)
    keep = src != dst
    lo, hi = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
    pairs = np.unique(lo * n + hi)
    lo, hi = pairs // n, pairs % n
    edges = np.concatenate([np.stack([lo, hi], 1), np.stack([hi, lo], 1)])
    return edges.astype(np.int64), labels.astype(np.int32)


def star(n: int, **kw) -> Graph:
    edges = np.stack([np.zeros(n - 1, dtype=np.int64), np.arange(1, n)], 1)
    return build_csr_host(n, edges, **kw)


def complete(n: int, **kw) -> Graph:
    i, j = np.triu_indices(n, 1)
    return build_csr_host(n, np.stack([i, j], 1), **kw)


SUITE = {
    # name: (factory, kwargs, paper class) — the reference's suite
    "grid_64x32": (grid2d, dict(rows=64, cols=32), "artificial mesh (2D)"),
    "cube_12": (grid3d, dict(nx=12, ny=12, nz=12), "artificial mesh (3D)"),
    "rmat_12": (rmat, dict(scale=12, edge_factor=8), "social/web"),
    "smallworld_4k": (small_world, dict(n=4096, k_ring=6), "complex network"),
    "geo_4k": (random_geometric, dict(n=4096), "finite element"),
}


def suite_graph(name: str) -> Graph:
    fac, kw, _ = SUITE[name]
    return fac(**kw)
