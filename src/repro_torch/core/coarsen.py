"""Coarsening: heavy-edge matching, two-hop matching and contraction (paper §3.1).

Counterpart of ``repro.core.coarsen``, with its two modes:

* **device** (default): each level is :func:`coarsen_level` (HEM rounds,
  the two-hop trigger, ``coarse_map``, ``contract_edges`` and the coarse
  CSR build), re-bucketed along a geometric :func:`shape_schedule` of
  capacities.  The host reads three ints per level (termination and
  capacity) plus the two-hop trigger.
* **host**: :func:`coarsen_once` repacks each coarse graph into tight
  arrays with numpy on the host, as the reference's legacy mode does, and
  moves it back to the caller's device.  Same hierarchy content.

Hashes are 32-bit arithmetic done in int64 (``core/u32.py``); the int32
wraparound of the seed mixing and of the twin hash is reproduced exactly.
Every gather index is in range by construction or clamped as the reference
clamps it, and every scatter index is in range or a permutation.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import Graph, csr_from_edge_runs, from_numpy_arrays
from repro_torch.core.u32 import i32, mul32, u32

_KNUTH = 2654435761
_INT_MIN = -2147483648
_INF = 2147483647


def _wrap(x: int) -> int:
    """A Python int wrapped to int32, as the reference's traced seed mixing."""
    return ((x + 2**31) % 2**32) - 2**31


def _bij_hash(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Invertible-ish 32-bit mix used only for random tie-breaking (uint32 in int64)."""
    h = mul32(u32(x) ^ (seed & 0xFFFFFFFF), _KNUTH)
    return h ^ (h >> 16)


def _seg(values: torch.Tensor, index: torch.Tensor, n: int, reduce: str,
         init: int) -> torch.Tensor:
    """Segment max/min with the reference's identity for empty segments."""
    out = torch.full((n,), init, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, index.long(), values, reduce)


def _seg_pick_dst(elig, value, dst, esrc, n_max, seed):
    """Per-source argmax over eligible edges: max value, random tie-break.

    Returns (cand (N,), has (N,)) — chosen dst per vertex or -1.
    """
    v1 = torch.where(elig, value, -1)
    best_v = _seg(v1, esrc, n_max, "amax", _INT_MIN)[esrc]
    tie1 = elig & (value == best_v) & (best_v > -1)
    h = (_bij_hash(dst, seed) >> 1).int()  # non-negative
    best_h = _seg(torch.where(tie1, h, -1), esrc, n_max, "amax", _INT_MIN)
    tie2 = tie1 & (h == best_h[esrc])
    cand = _seg(torch.where(tie2, dst, -1), esrc, n_max, "amax", _INT_MIN)
    return cand, cand >= 0


def heavy_edge_matching(g: Graph, rounds: int = 8, seed: int = 0) -> torch.Tensor:
    """Parallel handshake HEM. Returns match (N,): mate id, or -1 unmatched.

    Padding vertices are matched to themselves (excluded from everything).
    """
    n_max = g.n_max
    vid = torch.arange(n_max, dtype=torch.int32, device=g.device)
    match = torch.where(g.vertex_mask(), -1, vid)
    em = g.edge_mask()
    for r in range(rounds):
        unmatched = match < 0
        elig = em & unmatched[g.esrc] & unmatched[g.adjncy]
        cand, has = _seg_pick_dst(elig, g.adjwgt, g.adjncy, g.esrc, n_max,
                                  _wrap(seed * 1000003 + r))
        cand = torch.where(has & unmatched, cand, -1)
        # mutual handshake
        cand_of_cand = torch.where(cand >= 0, cand[cand.clamp(0, n_max - 1)], -2)
        match = torch.where((cand >= 0) & (cand_of_cand == vid), cand, match)
    return match


def _pair_by_key(key: torch.Tensor, elig: torch.Tensor, match: torch.Tensor,
                 seed: int = 0) -> torch.Tensor:
    """Pair eligible vertices sharing a key: sort by key, pair ranks (0,1),(2,3)...

    within each equal-key group (odd groups leave one vertex unpaired).
    Within a group, vertices are ordered by a seeded hash of their id.
    """
    n_max = key.shape[0]
    dev = key.device
    skey = torch.where(elig, key, _INF)
    vid = torch.arange(n_max, dtype=torch.int32, device=dev)
    h = (_bij_hash(vid, seed) >> 1).int()
    o1 = torch.argsort(h, stable=True)
    order = o1[torch.argsort(skey[o1], stable=True)]
    sk = skey[order]
    first = torch.ones(n_max, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    group_id = torch.cumsum(first.int(), 0) - 1
    group_start = torch.zeros(n_max, dtype=torch.int32, device=dev)
    group_start.scatter_reduce_(0, group_id, torch.where(first, vid, 0), "amax")
    rank = vid - group_start[group_id]
    valid = sk < _INF
    next_same = torch.zeros(n_max, dtype=torch.bool, device=dev)
    next_same[:-1] = sk[1:] == sk[:-1]
    is_lead = valid & (rank % 2 == 0) & next_same
    partner_pos = torch.where(is_lead, vid + 1, vid - 1)
    paired = is_lead | (valid & (rank % 2 == 1))
    partner = order[partner_pos.clamp(0, n_max - 1)].int()
    return match.scatter(0, order, torch.where(paired, partner, match[order]))


def twohop_matching(g: Graph, match: torch.Tensor, mm_max_degree: int = 64,
                    seed: int = 0) -> torch.Tensor:
    """Leaves, twins, relatives (paper §3.1) via sort-pairing."""
    n_max = g.n_max
    vmask = g.vertex_mask()
    deg = g.degrees()

    # --- leaves: unmatched degree-1 vertices grouped by their sole neighbor
    unmatched = (match < 0) & vmask
    sole = g.adjncy[g.xadj[:-1].clamp(0, g.m_max - 1)]
    elig = unmatched & (deg == 1)
    match = _pair_by_key(torch.where(elig, sole, 0), elig, match,
                         _wrap(seed * 4 + 1))

    # --- twins: unmatched vertices with identical neighborhoods (hash groups)
    unmatched = (match < 0) & vmask
    em = g.edge_mask()
    sums = []
    for salt in (11, 23):
        h = torch.where(em, _bij_hash(g.adjncy, _wrap(seed * 1000003 + salt)) >> 2,
                        0)
        sums.append(torch.zeros(n_max, dtype=torch.int64, device=g.device)
                    .index_add_(0, g.esrc.long(), h))
    # int32 wraparound of the reference: only the low 31 bits survive the mask
    nbhash = i32(((sums[0] * 31 + sums[1]) ^ (deg.long() * 0x61C88647))
                 & 0x7FFFFFFF)
    elig = unmatched & (deg >= 1)
    match = _pair_by_key(torch.where(elig, nbhash, 0), elig, match,
                         _wrap(seed * 4 + 2))

    # --- relatives: pair unmatched vertices within a matchmaker's neighborhood
    unmatched = (match < 0) & vmask
    is_mm = ~unmatched & vmask & (deg <= mm_max_degree)
    e_mm = em & is_mm[g.adjncy] & unmatched[g.esrc]
    mm_key = _seg(torch.where(e_mm, g.adjncy, _INF), g.esrc, n_max, "amin", _INF)
    elig = unmatched & (mm_key < _INF)
    return _pair_by_key(torch.where(elig, mm_key, 0), elig, match,
                        _wrap(seed * 4 + 3))


def coarse_map(g: Graph, match: torch.Tensor):
    """Map fine vertices to coarse ids. Returns (cmap (N,), nc 0-d).

    Singletons map alone; pairs map together; coarse ids ordered by leader
    id.  Padding vertices map to nc.. (ghost tail).
    """
    vid = torch.arange(g.n_max, dtype=torch.int32, device=g.device)
    vmask = g.vertex_mask()
    mate = torch.where(vmask & (match >= 0), match, vid)
    leader = torch.minimum(vid, mate)
    is_leader = (vid == leader) & vmask
    rank = torch.cumsum(is_leader.int(), 0).int() - 1
    nc = is_leader.sum(dtype=torch.int32)
    cmap = torch.where(vmask, rank[leader], nc + (vid - g.n))
    return cmap, nc


def contract_edges(g: Graph, cmap: torch.Tensor):
    """Alg 3.1 re-derived: sort coarse (cu, cv) keys, segment-sum duplicates.

    Returns padded run arrays sorted lexicographically by (cu, cv):
      (cu_run, cv_run, w_run, run_valid, n_runs, vwgt_c (N,))
    """
    m_max = g.m_max
    dev = g.device
    cu = cmap[g.esrc]
    cv = cmap[g.adjncy]
    keep = g.edge_mask() & (cu != cv)
    cu_s = torch.where(keep, cu, _INF)
    cv_s = torch.where(keep, cv, _INF)
    # lexicographic (cu, cv) via two stable argsorts
    o1 = torch.argsort(cv_s, stable=True)
    order = o1[torch.argsort(cu_s[o1], stable=True)]
    su, sv = cu_s[order], cv_s[order]
    sw = torch.where(keep, g.adjwgt, 0)[order]
    first = torch.ones(m_max, dtype=torch.bool, device=dev)
    first[1:] = (su[1:] != su[:-1]) | (sv[1:] != sv[:-1])
    run_id = (torch.cumsum(first.int(), 0) - 1).long()
    w_run = torch.zeros(m_max, dtype=torch.int32, device=dev).index_add_(
        0, run_id, sw)
    cu_run = _seg(su, run_id, m_max, "amin", _INF)
    cv_run = _seg(sv, run_id, m_max, "amin", _INF)
    run_valid = cu_run != _INF
    n_runs = run_valid.sum(dtype=torch.int32)
    vwgt_c = torch.zeros(g.n_max, dtype=torch.int32, device=dev).index_add_(
        0, cmap.long(), g.vwgt)
    return cu_run, cv_run, w_run, run_valid, n_runs, vwgt_c


class CoarsenLevel(NamedTuple):
    graph: Graph
    cmap: torch.Tensor | None  # fine vertex -> coarse vertex of the NEXT level
    stats: dict | None = None  # host ints: n, m, max_degree, n_max, m_max


def _round_up(x: int, mult: int = 8) -> int:
    return ((x + mult - 1) // mult) * mult


def coarsen_once(g: Graph, twohop_threshold: float = 0.25,
                 mm_max_degree: int = 64, seed: int = 0):
    """One coarsening level, legacy host-repack path.

    Returns (coarse graph with tight capacities, cmap).  The coarse graph
    is on ``g``'s device; the repack in between is host numpy.
    """
    match = heavy_edge_matching(g, seed=seed)
    n = int(g.n)
    unmatched = int(((match < 0) & g.vertex_mask()).sum())
    # float32 on purpose, as the reference: the same trigger as coarsen_level
    frac = np.float32(unmatched) / np.float32(max(n, 1))
    if frac > np.float32(twohop_threshold):
        match = twohop_matching(g, match, mm_max_degree, seed)
    cmap, nc_dev = coarse_map(g, match)
    cu_run, cv_run, w_run, _, n_runs_dev, vwgt_c = contract_edges(g, cmap)
    nc, n_runs = torch.stack([nc_dev, n_runs_dev]).tolist()
    cu = cu_run[:n_runs].cpu().numpy()
    cv = cv_run[:n_runs].cpu().numpy()
    w = w_run[:n_runs].cpu().numpy()
    vw = vwgt_c[:nc].cpu().numpy()
    n_max_c = _round_up(max(nc, 1))
    m_max_c = _round_up(max(n_runs, 1))
    xadj = np.zeros(n_max_c + 1, dtype=np.int64)
    np.add.at(xadj, cu + 1, 1)
    xadj = np.cumsum(xadj)
    xadj_p = np.full(n_max_c + 1, n_runs, dtype=np.int32)
    xadj_p[: nc + 1] = xadj[: nc + 1]
    adjncy_p = np.zeros(m_max_c, dtype=np.int32)
    adjncy_p[:n_runs] = cv
    adjwgt_p = np.zeros(m_max_c, dtype=np.int32)
    adjwgt_p[:n_runs] = w
    vwgt_p = np.zeros(n_max_c, dtype=np.int32)
    vwgt_p[:nc] = vw
    esrc_p = np.zeros(m_max_c, dtype=np.int32)
    esrc_p[:n_runs] = cu
    gc = from_numpy_arrays(xadj_p, adjncy_p, adjwgt_p, vwgt_p, esrc_p, nc,
                           n_runs, device=g.device)
    return gc, cmap


def coarsen_level(g: Graph, seed: int = 0, twohop_threshold: float = 0.25,
                  mm_max_degree: int = 64, hem_rounds: int = 8):
    """One whole coarsening level. Returns (coarse graph, cmap).

    The coarse graph comes back padded at the FINE graph's capacities; the
    driver re-buckets it with :meth:`Graph.with_capacity` after reading the
    level stats.  The two-hop trigger is one host read of a device float32.
    """
    match = heavy_edge_matching(g, rounds=hem_rounds, seed=seed)
    unmatched = ((match < 0) & g.vertex_mask()).sum(dtype=torch.int32)
    frac = unmatched.float() / torch.clamp(g.n, min=1).float()
    if bool(frac > twohop_threshold):
        match = twohop_matching(g, match, mm_max_degree, seed)
    cmap, nc = coarse_map(g, match)
    cu_run, cv_run, w_run, run_valid, n_runs, vwgt_c = contract_edges(g, cmap)
    gc = csr_from_edge_runs(cu_run, cv_run, w_run, run_valid, n_runs, vwgt_c,
                            nc, n_max=g.n_max, m_max=g.m_max)
    return gc, cmap


def _fetch_stats(g: Graph) -> dict:
    """(n, m, max_degree) in one transfer, plus the capacities."""
    n, m, max_deg = torch.stack(
        [g.n, g.m, g.degrees().max().int()]).tolist()
    return {"n": n, "m": m, "max_degree": max_deg,
            "n_max": g.n_max, "m_max": g.m_max}


def shape_schedule(n_max: int, m_max: int, ratio: float = 1.6,
                   safety: float = 1.25, stall_ratio: float = 0.95,
                   align: int = 64, floor: int = 64) -> tuple[tuple[int, int], ...]:
    """Geometric capacity ladder for the coarsening path.

    Each rung shrinks both capacities by ``min(safety / ratio, stall_ratio)``;
    rungs are aligned so distinct graphs share buckets.  Descending; rung 0
    is the input's exact capacity.
    """
    if ratio <= 0 or safety <= 0 or align <= 0:
        raise ValueError(
            f"ratio/safety/align must be positive, got {ratio}/{safety}/{align}"
        )
    f = min(safety / ratio, stall_ratio)
    if not 0.0 < f < 1.0:
        raise ValueError(
            f"per-rung shrink min(safety/ratio, stall_ratio)={f} must be in "
            f"(0, 1), got ratio={ratio} safety={safety} "
            f"stall_ratio={stall_ratio}"
        )
    rungs = [(max(n_max, 1), max(m_max, 1))]
    n, m = rungs[0]
    while n > floor or m > floor:
        n = max(int(n * f), 1)
        m = max(int(m * f), 1)
        rung = (_round_up(n, align), _round_up(m, align))
        # alignment can lift a tiny rung above its predecessor — skip it
        if rung[0] <= rungs[-1][0] and rung[1] <= rungs[-1][1] \
                and rung != rungs[-1]:
            rungs.append(rung)
    return tuple(rungs)


def select_capacity(schedule: tuple[tuple[int, int], ...], n: int,
                    m: int) -> tuple[int, int]:
    """Smallest fitting capacity, chosen per axis (rung 0 always fits)."""
    n_cap = min(nc for nc, _ in schedule if nc >= n)
    m_cap = min(mc for _, mc in schedule if mc >= m)
    return (n_cap, m_cap)


def multilevel_coarsen(
    g: Graph,
    coarse_target: int = 4096,
    max_levels: int = 40,
    stall_ratio: float = 0.95,
    seed: int = 0,
    mode: str = "device",
    schedule: tuple[tuple[int, int], ...] | None = None,
    twohop_threshold: float = 0.25,
    mm_max_degree: int = 64,
    bucket_ratio: float = 1.6,
    bucket_safety: float = 1.25,
    bucket_align: int = 64,
) -> list[CoarsenLevel]:
    """MLCoarsen (Alg 2.1 line 1): list of levels, finest first.

    ``levels[i].cmap`` maps level-i vertices into level-(i+1)'s graph; the
    last entry's cmap is None.  Every level carries host ``stats``.
    ``mode="device"`` re-buckets each level along ``schedule``;
    ``mode="host"`` repacks each level tightly with :func:`coarsen_once`.
    """
    if mode not in ("device", "host"):
        raise ValueError(f"unknown coarsen mode {mode!r}")
    cur = g
    stats = _fetch_stats(cur)
    if mode == "device":
        if schedule is None:
            schedule = shape_schedule(
                g.n_max, g.m_max, ratio=bucket_ratio, safety=bucket_safety,
                stall_ratio=stall_ratio, align=bucket_align,
            )
        if schedule[0][0] < stats["n"] or schedule[0][1] < stats["m"]:
            raise ValueError(
                f"schedule rung 0 {schedule[0]} cannot hold the input graph "
                f"(n={stats['n']}, m={stats['m']}) — with_capacity would "
                "silently truncate real vertices/edges"
            )
        if (cur.n_max, cur.m_max) != schedule[0]:
            cur = cur.with_capacity(*schedule[0])
            stats = {**stats, "n_max": schedule[0][0],
                     "m_max": schedule[0][1]}

    def step(fine: Graph, lvl: int):
        """One level and its stats; the per-level host reads live here."""
        if mode == "host":
            gc, cmap = coarsen_once(fine, twohop_threshold=twohop_threshold,
                                    mm_max_degree=mm_max_degree,
                                    seed=seed + lvl)
            return gc, cmap, _fetch_stats(gc)
        gc, cmap = coarsen_level(fine, seed=seed + lvl,
                                 twohop_threshold=twohop_threshold,
                                 mm_max_degree=mm_max_degree)
        st = _fetch_stats(gc)
        cap = select_capacity(schedule, st["n"], st["m"])
        if cap != (gc.n_max, gc.m_max):
            gc = gc.with_capacity(*cap)
            st = {**st, "n_max": cap[0], "m_max": cap[1]}
        return gc, cmap, st

    levels: list[CoarsenLevel] = []
    for lvl in range(max_levels):
        if stats["n"] <= coarse_target:
            break
        gc, cmap, stats_c = step(cur, lvl)
        if stats_c["n"] > stall_ratio * stats["n"]:  # stalled
            break
        levels.append(CoarsenLevel(graph=cur, cmap=cmap, stats=stats))
        cur, stats = gc, stats_c
    levels.append(CoarsenLevel(graph=cur, cmap=None, stats=stats))
    return levels


def project_partition(cmap: torch.Tensor, parts_coarse: torch.Tensor) -> torch.Tensor:
    """ProjectPartition (Alg 2.1 line 6): fine parts = coarse parts[cmap].

    ``parts_coarse`` may carry a leading trial axis.
    """
    nc_max = parts_coarse.shape[-1]
    return parts_coarse[..., cmap.clamp(0, nc_max - 1).long()]
