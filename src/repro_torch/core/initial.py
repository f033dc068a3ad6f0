"""Initial partitioning of the coarsest graph.

Counterpart of ``repro.core.initial``, trial-batched over a (T,) vector of
int32 seeds; row t of a batch equals the T=1 call with ``seeds[t]``.  On a
stacked fleet bucket the batch is (B, T, n_max), and lane b's rows equal
its standalone batch (all hashing is on lane-local vertex ids).

* ``random``  — hash-based balanced random assignment (PuLP-style start).
* ``voronoi`` — multi-source BFS region growing from k spread-out seeds.

All hashing is 32-bit arithmetic done in int64 (``core/u32.py``).
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.core import connectivity as cn
from repro_torch.core.graph import Graph, trial_axis
from repro_torch.core.u32 import MASK, mul32, u32

_KNUTH = 2654435761
# Padding sort key: strictly above every real vertex key (real keys are
# hashes >> 1, so <= 0x7FFFFFFF) — a real vertex can never tie with padding.
_PAD_KEY = 0xFFFFFFFF

METHODS = ("random", "voronoi")


def _hash_keys(g: Graph, seeds: torch.Tensor, mult: int, add: int):
    """(..., T, N) sort keys ``((vid ^ (s*mult + add)) * KNUTH) >> 1``, pads
    last."""
    vid = torch.arange(g.n_max, device=g.device)
    salt = (mul32(u32(seeds.to(g.device)), mult) + add) & MASK
    h = mul32(vid ^ salt[:, None], _KNUTH)
    return torch.where(g.vertex_mask().unsqueeze(-2), h >> 1, _PAD_KEY)


def random_partition(g: Graph, k: int, seeds: torch.Tensor) -> torch.Tensor:
    """Balanced random assignment: sort vertices by hash, deal round-robin."""
    order = torch.argsort(_hash_keys(g, seeds, 7919, 13), dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(g.n_max, device=g.device).expand_as(order))
    return torch.where(g.vertex_mask().unsqueeze(-2), (rank % k).int(), k)


def spread_seeds(g: Graph, k: int, seeds: torch.Tensor) -> torch.Tensor:
    """(..., T, k) spread-out seed vertices from a seeded hash, mask-aware.

    Padding keys sort after every real key, so a padded vertex is picked
    only when ``k`` exceeds the number of real vertices; such a shortfall is
    replaced round-robin over real vertex ids.
    """
    h = _hash_keys(g, seeds, 104729, 7)
    cand = torch.argsort(h, dim=-1, stable=True)[..., : min(k, g.n_max)]
    if k > g.n_max:
        # the missing candidates are forced onto the round-robin fallback
        cand = torch.cat([cand, torch.full((*cand.shape[:-1], k - g.n_max),
                                           g.n_max, device=g.device)], -1)
    n = g.n[..., None, None]
    fallback = torch.arange(k, device=g.device) % torch.clamp(n, min=1)
    return torch.where(cand < n, cand, fallback).int()


def _voronoi_grow(g: Graph, seeds: torch.Tensor, k: int) -> torch.Tensor:
    """Multi-source BFS: unassigned vertices adopt the strongest adjacent part.

    The reference's while-loop under vmap: runs while any (lane, trial) row
    changed, freezing the rows that have stopped; one host read per
    iteration for the whole batch.
    """
    rows = seeds.shape[:-1]
    vmask = trial_axis(g.vertex_mask(), seeds.dim())
    ids = torch.arange(k, dtype=torch.int32, device=g.device).expand(
        seeds.shape)
    # scatter-min: the smallest part id claiming a vertex wins
    parts = torch.full((*rows, g.n_max), k, dtype=torch.int32,
                       device=g.device)
    parts.scatter_reduce_(-1, seeds.long(), ids, "amin")
    parts = torch.where(vmask, parts, k)
    changed = torch.ones(rows, dtype=torch.bool, device=g.device)
    it = torch.zeros(rows, dtype=torch.int32, device=g.device)
    while True:
        active = changed & (it < g.n_max)
        if not trace.read("initial.grow", active.any().item):
            break
        unassigned = (parts == k) & vmask
        masked = cn.conn_matrix(g, parts, k + 1)[..., :k]
        best = torch.argmax(masked, dim=-1).int()
        has = masked.amax(dim=-1) > 0
        newp = torch.where(unassigned & has, best, parts)
        changed = torch.where(active, (newp != parts).any(-1), changed)
        parts = torch.where(active[..., None], newp, parts)
        it = it + active.int()
    # disconnected leftovers: deal round-robin
    vid = torch.arange(g.n_max, dtype=torch.int32, device=g.device)
    return torch.where((parts == k) & vmask, vid % k, parts)


def voronoi_partition(g: Graph, k: int, seeds: torch.Tensor) -> torch.Tensor:
    """Graph-growing from k hash-spread seeds."""
    return _voronoi_grow(g, spread_seeds(g, k, seeds), k)


def initial_partition(g: Graph, k: int, seed=0,
                      method: str = "voronoi") -> torch.Tensor:
    """(n_max,) int32 seeded initial partition (``(B, n_max)`` on a stacked
    bucket): the row of :func:`initial_partition_batch` for ``seed``."""
    return initial_partition_batch(g, k, [int(seed)], method)[..., 0, :]


def initial_partition_batch(g: Graph, k: int, seeds,
                            method: str = "voronoi") -> torch.Tensor:
    """(T, n_max) int32 batch of seeded initial partitions; (B, T, n_max)
    on a stacked fleet bucket (the reference's ``initial_partition_fleet``)."""
    if method not in METHODS:
        raise ValueError(f"unknown initial partition method {method!r}")
    seeds = torch.as_tensor(seeds, dtype=torch.int32)
    if seeds.dim() != 1:
        raise ValueError(f"seeds must be 1-D (one per trial), got "
                         f"{tuple(seeds.shape)}")
    fn = random_partition if method == "random" else voronoi_partition
    return fn(g, k, trace.read("initial.seeds", lambda: seeds.to(g.device)))
