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

from repro_torch import trace
from repro_torch.core.graph import (Graph, csr_from_edge_runs,
                                    from_numpy_arrays, take)
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
    """Segment max/min along the last axis, with the reference's identity
    for empty segments."""
    out = torch.full((*values.shape[:-1], n), init, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(-1, index.long(), values, reduce)


def _seg_pick_dst(elig, value, dst, esrc, n_max, seed):
    """Per-source argmax over eligible edges: max value, random tie-break.

    Returns (cand (..., N), has (..., N)) — chosen dst per vertex or -1.
    """
    v1 = torch.where(elig, value, -1)
    best_v = take(_seg(v1, esrc, n_max, "amax", _INT_MIN), esrc)
    tie1 = elig & (value == best_v) & (best_v > -1)
    h = (_bij_hash(dst, seed) >> 1).int()  # non-negative
    best_h = _seg(torch.where(tie1, h, -1), esrc, n_max, "amax", _INT_MIN)
    tie2 = tie1 & (h == take(best_h, esrc))
    cand = _seg(torch.where(tie2, dst, -1), esrc, n_max, "amax", _INT_MIN)
    return cand, cand >= 0


def heavy_edge_matching(g: Graph, rounds: int = 8, seed: int = 0) -> torch.Tensor:
    """Parallel handshake HEM. Returns match (..., N): mate id, or -1 unmatched.

    Padding vertices are matched to themselves (excluded from everything).
    """
    n_max = g.n_max
    vid = torch.arange(n_max, dtype=torch.int32, device=g.device)
    match = torch.where(g.vertex_mask(), -1, vid)
    em = g.edge_mask()
    for r in range(rounds):
        with trace.span("jet.coarsen.hem.round"):
            unmatched = match < 0
            elig = em & take(unmatched, g.esrc) & take(unmatched, g.adjncy)
            cand, has = _seg_pick_dst(elig, g.adjwgt, g.adjncy, g.esrc,
                                      n_max, _wrap(seed * 1000003 + r))
            cand = torch.where(has & unmatched, cand, -1)
            # mutual handshake
            cand_of_cand = torch.where(
                cand >= 0, take(cand, cand.clamp(0, n_max - 1)), -2)
            match = torch.where((cand >= 0) & (cand_of_cand == vid), cand,
                                match)
    return match


def _pair_by_key(key: torch.Tensor, elig: torch.Tensor, match: torch.Tensor,
                 seed: int = 0) -> torch.Tensor:
    """Pair eligible vertices sharing a key: sort by key, pair ranks (0,1),(2,3)...

    within each equal-key group (odd groups leave one vertex unpaired).
    Within a group, vertices are ordered by a seeded hash of their id.
    Every sort, cumsum and scatter runs along the last axis, per lane.
    """
    n_max = key.shape[-1]
    dev = key.device
    skey = torch.where(elig, key, _INF)
    vid = torch.arange(n_max, dtype=torch.int32, device=dev)
    h = (_bij_hash(vid, seed) >> 1).int()
    o1 = torch.argsort(h, stable=True).expand_as(skey)
    order = o1.gather(-1, torch.argsort(skey.gather(-1, o1), dim=-1,
                                        stable=True))
    sk = skey.gather(-1, order)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[..., 1:] = sk[..., 1:] != sk[..., :-1]
    group_id = torch.cumsum(first.int(), -1) - 1
    group_start = torch.zeros_like(sk).scatter_reduce_(
        -1, group_id, torch.where(first, vid, 0), "amax")
    rank = vid - group_start.gather(-1, group_id)
    valid = sk < _INF
    next_same = torch.zeros_like(first)
    next_same[..., :-1] = sk[..., 1:] == sk[..., :-1]
    is_lead = valid & (rank % 2 == 0) & next_same
    partner_pos = torch.where(is_lead, vid + 1, vid - 1)
    paired = is_lead | (valid & (rank % 2 == 1))
    partner = order.gather(-1, partner_pos.clamp(0, n_max - 1).long()).int()
    return match.scatter(-1, order, torch.where(paired, partner,
                                                match.gather(-1, order)))


def twohop_matching(g: Graph, match: torch.Tensor, mm_max_degree: int = 64,
                    seed: int = 0) -> torch.Tensor:
    """Leaves, twins, relatives (paper §3.1) via sort-pairing."""
    n_max = g.n_max
    vmask = g.vertex_mask()
    deg = g.degrees()

    # --- leaves: unmatched degree-1 vertices grouped by their sole neighbor
    unmatched = (match < 0) & vmask
    sole = take(g.adjncy, g.xadj[..., :-1].clamp(0, g.m_max - 1))
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
        sums.append(torch.zeros(deg.shape, dtype=torch.int64, device=g.device)
                    .scatter_add_(-1, g.esrc.long(), h))
    # int32 wraparound of the reference: only the low 31 bits survive the mask
    nbhash = i32(((sums[0] * 31 + sums[1]) ^ (deg.long() * 0x61C88647))
                 & 0x7FFFFFFF)
    elig = unmatched & (deg >= 1)
    match = _pair_by_key(torch.where(elig, nbhash, 0), elig, match,
                         _wrap(seed * 4 + 2))

    # --- relatives: pair unmatched vertices within a matchmaker's neighborhood
    unmatched = (match < 0) & vmask
    is_mm = ~unmatched & vmask & (deg <= mm_max_degree)
    e_mm = em & take(is_mm, g.adjncy) & take(unmatched, g.esrc)
    mm_key = _seg(torch.where(e_mm, g.adjncy, _INF), g.esrc, n_max, "amin", _INF)
    elig = unmatched & (mm_key < _INF)
    return _pair_by_key(torch.where(elig, mm_key, 0), elig, match,
                        _wrap(seed * 4 + 3))


def coarse_map(g: Graph, match: torch.Tensor):
    """Map fine vertices to coarse ids. Returns (cmap (..., N), nc (...)).

    Singletons map alone; pairs map together; coarse ids ordered by leader
    id.  Padding vertices map to nc.. (ghost tail).
    """
    vid = torch.arange(g.n_max, dtype=torch.int32, device=g.device)
    vmask = g.vertex_mask()
    mate = torch.where(vmask & (match >= 0), match, vid)
    leader = torch.minimum(vid, mate)
    is_leader = (vid == leader) & vmask
    rank = torch.cumsum(is_leader.int(), -1).int() - 1
    nc = is_leader.sum(-1, dtype=torch.int32)
    cmap = torch.where(vmask, take(rank, leader),
                       nc.unsqueeze(-1) + (vid - g.n.unsqueeze(-1)))
    return cmap, nc


def contract_edges(g: Graph, cmap: torch.Tensor):
    """Alg 3.1 re-derived: sort coarse (cu, cv) keys, segment-sum duplicates.

    Returns padded run arrays sorted lexicographically by (cu, cv):
      (cu_run, cv_run, w_run, run_valid, n_runs, vwgt_c (..., N))
    """
    m_max = g.m_max
    cu = take(cmap, g.esrc)
    cv = take(cmap, g.adjncy)
    keep = g.edge_mask() & (cu != cv)
    cu_s = torch.where(keep, cu, _INF)
    cv_s = torch.where(keep, cv, _INF)
    # lexicographic (cu, cv) via two stable argsorts
    o1 = torch.argsort(cv_s, dim=-1, stable=True)
    order = o1.gather(-1, torch.argsort(cu_s.gather(-1, o1), dim=-1,
                                        stable=True))
    su, sv = cu_s.gather(-1, order), cv_s.gather(-1, order)
    sw = torch.where(keep, g.adjwgt, 0).gather(-1, order)
    first = torch.ones_like(su, dtype=torch.bool)
    first[..., 1:] = (su[..., 1:] != su[..., :-1]) | \
        (sv[..., 1:] != sv[..., :-1])
    run_id = (torch.cumsum(first.int(), -1) - 1).long()
    w_run = torch.zeros_like(sw).scatter_add_(-1, run_id, sw)
    cu_run = _seg(su, run_id, m_max, "amin", _INF)
    cv_run = _seg(sv, run_id, m_max, "amin", _INF)
    run_valid = cu_run != _INF
    n_runs = run_valid.sum(-1, dtype=torch.int32)
    vwgt_c = torch.zeros_like(g.vwgt).scatter_add_(-1, cmap.long(), g.vwgt)
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
    n = trace.read("coarsen.n", g.n.item)
    unmatched = trace.read("coarsen.unmatched",
                           ((match < 0) & g.vertex_mask()).sum().item)
    # float32 on purpose, as the reference: the same trigger as coarsen_level
    frac = np.float32(unmatched) / np.float32(max(n, 1))
    if frac > np.float32(twohop_threshold):
        match = twohop_matching(g, match, mm_max_degree, seed)
    cmap, nc_dev = coarse_map(g, match)
    cu_run, cv_run, w_run, _, n_runs_dev, vwgt_c = contract_edges(g, cmap)
    nc, n_runs = trace.read("coarsen.sizes",
                            torch.stack([nc_dev, n_runs_dev]).tolist)
    cu, cv, w, vw = (trace.read("coarsen.repack", x.cpu).numpy() for x in (
        cu_run[:n_runs], cv_run[:n_runs], w_run[:n_runs], vwgt_c[:nc]))
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
    level stats.  The two-hop trigger is one host read of a device bool per
    lane: the two-hop matching runs when any lane triggers, and each lane
    keeps its own match by select (``lax.cond`` under vmap).
    """
    match = heavy_edge_matching(g, rounds=hem_rounds, seed=seed)
    unmatched = ((match < 0) & g.vertex_mask()).sum(-1, dtype=torch.int32)
    frac = unmatched.float() / torch.clamp(g.n, min=1).float()
    trigger = frac > twohop_threshold
    if trace.read("coarsen.twohop", trigger.any().item):
        match = torch.where(trigger.unsqueeze(-1),
                            twohop_matching(g, match, mm_max_degree, seed),
                            match)
    cmap, nc = coarse_map(g, match)
    cu_run, cv_run, w_run, run_valid, n_runs, vwgt_c = contract_edges(g, cmap)
    gc = csr_from_edge_runs(cu_run, cv_run, w_run, run_valid, n_runs, vwgt_c,
                            nc, n_max=g.n_max, m_max=g.m_max)
    return gc, cmap


def _lane_stats(g: Graph) -> np.ndarray:
    """(..., 3) int64 (n, m, max_degree) per lane — one host read."""
    st = torch.stack([g.n, g.m, g.degrees().amax(-1).int()], -1)
    return trace.read("coarsen.stats", st.cpu).numpy().astype(np.int64)


def _fetch_stats(g: Graph) -> dict:
    """(n, m, max_degree) in one transfer, plus the capacities."""
    n, m, max_deg = (int(x) for x in _lane_stats(g))
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


# ---------------------------------------------------------------------------
# Fleet coarsening — batched levels over a shape bucket (DESIGN.md §10)
# ---------------------------------------------------------------------------


class FleetLevel(NamedTuple):
    """One level of a bucket's batched hierarchy.

    ``graph`` is a stacked ``(B, ...)`` :class:`Graph`; ``cmap`` is
    ``(B, n_max)`` into the next level (identity rows for frozen lanes;
    None at the coarsest level).  ``active[b]`` says lane ``b`` is still
    real at this level — its own hierarchy reaches this deep, so the
    uncoarsening loop refines it here; frozen lanes pass their partition
    through untouched.  ``stats`` holds per-lane host numbers (``n``/``m``/
    ``max_degree`` as (B,) arrays) plus the shared ``n_max``/``m_max``.
    """

    graph: Graph
    cmap: torch.Tensor | None
    active: np.ndarray
    stats: dict | None


def _freeze_rebucket_fleet(gc: Graph, cmap: torch.Tensor, fine: Graph,
                           success: torch.Tensor, *, n_max: int, m_max: int):
    """Select failed lanes back to their fine graph, then re-bucket.

    Lanes that terminated (reached ``coarse_target`` earlier, or stalled
    this level) keep their fine graph frozen with an identity cmap — the
    batched analogue of the standalone loop's ``break``.  All lanes are
    then re-bucketed to the shared next capacity, selected to fit the batch
    max per axis, so frozen lanes always fit.
    """
    def pick(a, b):
        return torch.where(success.view(-1, *[1] * (a.dim() - 1)), a, b)

    g = Graph(*(pick(a, b) for a, b in zip(gc, fine)))
    ident = torch.arange(cmap.shape[-1], dtype=torch.int32,
                         device=cmap.device)
    return g.with_capacity(n_max, m_max), pick(cmap, ident)


def multilevel_coarsen_fleet(
    gb: Graph,
    schedule: tuple[tuple[int, int], ...],
    coarse_target: int = 4096,
    max_levels: int = 40,
    stall_ratio: float = 0.95,
    seed: int = 0,
    twohop_threshold: float = 0.25,
    mm_max_degree: int = 64,
) -> list[FleetLevel]:
    """Batched MLCoarsen over one shape bucket: list of levels, finest first.

    The whole bucket advances in lockstep — batch level ``i`` is every
    lane's own level ``i``, coarsened with seed ``seed + i`` — but each lane
    terminates on its own schedule (``coarse_target`` / ``stall_ratio`` /
    ``max_levels``), mirroring the standalone loop's ``break``s by
    select: a terminated lane's graph rides along frozen (identity cmap)
    and its ``active`` flag goes false for all deeper levels.  Host reads
    per level: the (B,) two-hop trigger and one (B, 3) stats fetch.
    """
    B = gb.vwgt.shape[0]
    n_max, m_max = gb.n_max, gb.m_max
    st0 = _lane_stats(gb)
    n, m, md = (st0[:, j] for j in range(3))
    if schedule[0][0] < n_max or schedule[0][1] < m_max:
        raise ValueError(
            f"schedule rung 0 {schedule[0]} is below the bucket capacity "
            f"({n_max}, {m_max}) — bucket with bucket_graphs first"
        )
    dead = np.zeros(B, bool)
    depth = np.zeros(B, np.int64)
    raw: list[tuple] = []
    for lvl in range(max_levels):
        active = ~dead & (n > coarse_target)
        if not active.any():
            break
        with trace.span("jet.coarsen.level"):
            gc, cmap = coarsen_level(gb, seed + lvl, twohop_threshold,
                                     mm_max_degree)
            stc = _lane_stats(gc)
        stalled = stc[:, 0] > stall_ratio * n
        success = active & ~stalled
        dead |= active & stalled
        if not success.any():
            break
        new_n = np.where(success, stc[:, 0], n)
        new_m = np.where(success, stc[:, 1], m)
        new_md = np.where(success, stc[:, 2], md)
        cap = select_capacity(schedule, int(new_n.max()), int(new_m.max()))
        success_dev = trace.read(
            "fleet.success", lambda: torch.from_numpy(success).to(gb.device))
        gb2, cmap = _freeze_rebucket_fleet(gc, cmap, gb, success_dev,
                                           n_max=cap[0], m_max=cap[1])
        raw.append((gb, cmap, {"n": n, "m": m, "max_degree": md,
                               "n_max": n_max, "m_max": m_max}))
        depth += success
        gb, n, m, md = gb2, new_n, new_m, new_md
        n_max, m_max = cap
    raw.append((gb, None, {"n": n, "m": m, "max_degree": md,
                           "n_max": n_max, "m_max": m_max}))
    return [FleetLevel(graph=g, cmap=c, active=depth >= i, stats=st)
            for i, (g, c, st) in enumerate(raw)]


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
        with trace.span("jet.coarsen.level"):
            gc, cmap, stats_c = step(cur, lvl)
        if stats_c["n"] > stall_ratio * stats["n"]:  # stalled
            break
        levels.append(CoarsenLevel(graph=cur, cmap=cmap, stats=stats))
        cur, stats = gc, stats_c
    levels.append(CoarsenLevel(graph=cur, cmap=None, stats=stats))
    return levels


def project_partition(cmap: torch.Tensor, parts_coarse: torch.Tensor) -> torch.Tensor:
    """ProjectPartition (Alg 2.1 line 6): fine parts = coarse parts[cmap].

    ``cmap`` is ``(*lanes, N)``; ``parts_coarse`` is ``(*lanes, [T,] nc)``.
    """
    nc_max = parts_coarse.shape[-1]
    return take(parts_coarse, cmap.clamp(0, nc_max - 1))
