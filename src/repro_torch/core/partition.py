"""The Jet partitioner — multilevel driver (Alg 2.1) with batched trials.

Counterpart of ``repro.core.partition``: coarsen -> initial partition
(coarsest) -> [project -> Jet refine] per level, with T seed trials batched
along a leading axis over ONE shared hierarchy and the best trial (balanced
first, then lowest cut) selected on the device.

The fleet (DESIGN.md §10): :func:`partition_fleet` groups many graphs into
shape buckets and runs each bucket's V-cycle once for all its lanes, every
state (B, T, ...), so each kernel launches once per batched step for the
whole bucket; every member's result equals its standalone ``partition()``
bit for bit.

Every entry point runs on the card by default: ``device=None`` means
``cuda``, and raises when there is none.  Pass ``device="cpu"`` to run the
plain versions of the kernels on the CPU.

The port compiles nothing per shape, so the reference's count of compiled
fleet executables (``uncoarsen_level_fleet._cache_size()``) becomes a
registry of the shape signatures the fleet has run:
:func:`fleet_signature_count`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import coarsen as co
from repro_torch.core import connectivity as cn
from repro_torch.core import graph as gr
from repro_torch.core import initial, metrics, refine
from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device, synchronize


@dataclass
class PartitionConfig:
    k: int = 8
    lam: float = 0.03                 # balance slack (paper: 1-10%)
    phi: float = 0.999                # quality/runtime tolerance (paper §4)
    c_finest: float = 0.25            # Eq 4.3 ratio, finest level
    c_coarse: float = 0.75            # Eq 4.3 ratio, other levels
    coarse_target: int = 4096         # paper coarsens to 4-8k vertices
    max_levels: int = 40              # coarsening depth cap
    stall_ratio: float = 0.95         # terminate when a level shrinks less
    coarsen_mode: str = "device"      # device|host (legacy numpy repack)
    bucket_ratio: float = 1.6         # shape-schedule geometric shrink
    bucket_safety: float = 1.25       # headroom multiplier on the shrink
    bucket_align: int = 64            # capacity rung alignment
    patience: int = 12                # iterations without a new best
    max_iter: int = 300
    b_max: int = 2                    # weak rebalances before strong
    backend: str = "dense"            # connectivity backend: dense|sorted|ell
    rebuild_every: int = 0            # full ConnState rebuild period (0=never,
                                      # 1=paper's always-rebuild fallback)
    init_method: str = "voronoi"      # random|voronoi
    variant: str = "full"             # Jetlp variant (Table 3 ablations)
    seed: int = 0
    trials: int = 1                   # best-of-N trials over one hierarchy
    trial_seeds: tuple | None = None  # per-trial init seeds; default
                                      # (seed, seed+1, ..., seed+trials-1)


@dataclass
class PartitionResult:
    parts: torch.Tensor
    cut: int
    imbalance: float
    balanced: bool
    levels: int
    times: dict = field(default_factory=dict)
    level_stats: list = field(default_factory=list)
    config: Any = None
    trials: int = 1
    best_trial: int = 0               # index into the trial batch
    trial_cuts: list = field(default_factory=list)      # per-trial best cut
    trial_balanced: list = field(default_factory=list)  # per-trial balance
    trial_parts: Any = None           # (T, n_max) finest-level parts batch


def _resolve_trial_seeds(cfg: PartitionConfig) -> tuple:
    if cfg.trials < 1:
        raise ValueError(f"trials must be >= 1, got {cfg.trials}")
    if cfg.trial_seeds is None:
        return tuple(cfg.seed + t for t in range(cfg.trials))
    seeds = tuple(int(s) for s in cfg.trial_seeds)
    if len(seeds) != cfg.trials:
        raise ValueError(
            f"trial_seeds has {len(seeds)} entries but trials={cfg.trials}"
        )
    return seeds


@trace.spanned("jet.level")
def uncoarsen_level(fine: Graph, cmap, parts_batch, phi, *, k, lam, c, backend,
                    patience, max_iter, b_max, variant, rebuild_every,
                    max_degree=None, active=None):
    """One uncoarsening level over the trial axis: project -> ghost-mask ->
    ConnState build -> Jet refinement.  ``parts_batch`` is (T, nc_max).

    On a fleet bucket (the reference's ``uncoarsen_level_fleet``) ``fine``
    is stacked, ``cmap`` (B, n_max), ``parts_batch`` (B, T, nc_max) and
    ``active`` (B,) the lanes' refine flags: an inactive lane (its own
    hierarchy is shallower) projects through its identity cmap and is not
    refined.
    """
    parts = co.project_partition(cmap, parts_batch)
    parts = torch.where(fine.vertex_mask().unsqueeze(-2), parts, k).int()
    with trace.span("jet.level.build"):
        conn0 = cn.build_state(fine, parts, k, backend, max_degree=max_degree)
    return refine._refine_loop(
        fine, parts, conn0, phi, k=k, lam=lam, c=c, backend=backend,
        patience=patience, max_iter=max_iter, b_max=b_max, variant=variant,
        rebuild_every=rebuild_every, active=active)


def _best_trial(balanced, cut, maxsize) -> torch.Tensor:
    """Best-of-T selection along the last axis (same ordering as Alg 4.1's
    best tracking): a balanced trial beats an unbalanced one; among
    balanced trials the lowest cut wins; if none is balanced, the lowest
    max part weight wins with the lower cut breaking ties.  ``argmin``
    takes the first index on ties."""
    inf = 0x7FFFFFFF
    idx_bal = torch.argmin(torch.where(balanced, cut, inf), dim=-1)
    low = maxsize == maxsize.amin(-1, keepdim=True)
    idx_imb = torch.argmin(torch.where(low, cut, inf), dim=-1)
    return torch.where(balanced.any(-1), idx_bal, idx_imb)


def partition(g: Graph, cfg: PartitionConfig, device=None) -> PartitionResult:
    """Full multilevel partition of ``g`` into ``cfg.k`` parts.

    With ``cfg.trials = T > 1`` the uncoarsening phase runs over T seed
    trials on the shared hierarchy and returns the best; ``trial_cuts`` /
    ``trial_balanced`` / ``trial_parts`` expose the whole batch.  Trial
    ``t`` equals a ``trials=1`` run with ``trial_seeds=(seeds[t],)``.

    Besides the phase seconds, ``times`` holds the call's record
    (:mod:`repro_torch.trace`): ``host_reads``, the refinement loop's
    ``refine_wait_s`` (the host blocked at its per-iteration read) and
    ``refine_issue_s`` (the rest of its host time), and ``jet_gain_host_s``.
    """
    with trace.call() as rec, trace.span("jet.partition"):
        res = _partition(g, cfg, device)
        res.times.update(rec.times())
    return res


def _partition(g: Graph, cfg: PartitionConfig, device) -> PartitionResult:
    device = resolve_device(device)
    g = g.to(device)
    k = cfg.k
    seeds = _resolve_trial_seeds(cfg)
    trials = cfg.trials
    cn._check_backend(cfg.backend)
    if cfg.backend == "sorted":  # the finest level is the largest
        cn.check_sorted(g, k)

    t0 = time.perf_counter()
    with trace.span("jet.coarsen"):
        levels = co.multilevel_coarsen(
            g, coarse_target=cfg.coarse_target, max_levels=cfg.max_levels,
            stall_ratio=cfg.stall_ratio, seed=cfg.seed,
            mode=cfg.coarsen_mode, bucket_ratio=cfg.bucket_ratio,
            bucket_safety=cfg.bucket_safety, bucket_align=cfg.bucket_align,
        )
        synchronize(device)
    t_coarsen = time.perf_counter() - t0

    t0 = time.perf_counter()
    with trace.span("jet.initial"):
        parts_b = initial.initial_partition_batch(
            levels[-1].graph, k, seeds, method=cfg.init_method)
        synchronize(device)
    t_init = time.perf_counter() - t0

    t0 = time.perf_counter()
    stats_per_level = []   # dicts of (T,) stat tensors, coarsest first
    meta_per_level = []    # host-side size stats captured during coarsening
    for i in range(len(levels) - 1, -1, -1):
        gi, lv_stats = levels[i].graph, levels[i].stats
        c = cfg.c_finest if i == 0 else cfg.c_coarse
        max_deg = lv_stats["max_degree"] if cfg.backend == "ell" else None
        if i == len(levels) - 1:
            cmap = torch.arange(gi.n_max, dtype=torch.int32, device=device)
        else:
            cmap = levels[i].cmap
        parts_b, stats = uncoarsen_level(
            gi, cmap, parts_b, cfg.phi, k=k, lam=cfg.lam, c=c,
            backend=cfg.backend, patience=cfg.patience, max_iter=cfg.max_iter,
            b_max=cfg.b_max, variant=cfg.variant,
            rebuild_every=cfg.rebuild_every, max_degree=max_deg,
        )
        stats_per_level.append(stats)
        meta = {kk: lv_stats[kk]
                for kk in ("n", "m", "n_max", "m_max", "max_degree")}
        meta_per_level.append({"level": i} | meta)

    # rung 0 of the shape schedule is the caller's exact capacity
    if parts_b.shape[1] != g.n_max:
        raise RuntimeError(f"finest parts {tuple(parts_b.shape)} do not match "
                           f"the graph's capacity {g.n_max}")

    with trace.span("jet.epilogue"):
        fstats = stats_per_level[-1]
        best_idx = trace.read("epilogue.best", _best_trial(
            fstats["best_balanced"], fstats["best_cost"],
            fstats["best_maxsize"]).item)
        parts = parts_b[best_idx]
        sizes = metrics.part_sizes(g, parts, k)
        W = g.total_vweight()
        cut = trace.read("epilogue.cut", metrics.cutsize(g, parts).item)
        imb = trace.read("epilogue.imbalance",
                         metrics.imbalance(sizes, W, k).item)
        balanced = trace.read("epilogue.balanced",
                              metrics.is_balanced(sizes, W, k, cfg.lam).item)
        names = list(fstats)
        per_level = torch.stack([torch.stack([s[kk].int() for kk in names])
                                 for s in stats_per_level])  # (L, S, T)
        per_level = trace.read("epilogue.stats", per_level.tolist)
        t_uncoarsen = time.perf_counter() - t0
        trial_cuts = trace.read("epilogue.trial_cuts",
                                fstats["best_cost"].tolist)
        trial_balanced = trace.read("epilogue.trial_balanced",
                                    fstats["best_balanced"].tolist)

    level_stats = []
    for meta, vals in zip(meta_per_level, per_level):
        per = dict(zip(names, vals))
        if trials == 1:
            per = {kk: vv[0] for kk, vv in per.items()}
        level_stats.append(meta | per)

    return PartitionResult(
        parts=parts,
        cut=cut,
        imbalance=imb,
        balanced=balanced,
        levels=len(levels),
        times={
            "coarsen_s": t_coarsen,
            "initpart_s": t_init,
            "uncoarsen_s": t_uncoarsen,
            "total_s": t_coarsen + t_init + t_uncoarsen,
        },
        level_stats=level_stats,
        config=cfg,
        trials=trials,
        best_trial=best_idx,
        trial_cuts=trial_cuts,
        trial_balanced=trial_balanced,
        trial_parts=parts_b,
    )


# every (lanes, T, n_max, m_max, nc, c, ell width, k, backend) signature a
# fleet level has run in this process (see level_signatures)
_FLEET_SIGNATURES: set = set()


def level_signatures(lanes: int, trials: int, level_stats, *, k: int,
                     backend: str, c_finest: float, c_coarse: float) -> set:
    """The signatures of one bucket's uncoarsening levels: (lanes, T, the
    level's (n_max, m_max), the coarser level's n_max, c, the ELL width
    (ell only), k, backend), the key of the reference's compiled
    ``uncoarsen_level_fleet``.  ``level_stats`` is the bucket's metas,
    coarsest first."""
    sigs = set()
    for j, st in enumerate(level_stats):
        nc = level_stats[j - 1]["n_max"] if j else st["n_max"]
        c = c_finest if st["level"] == 0 else c_coarse
        width = st.get("ell_width") if backend == "ell" else None
        sigs.add((lanes, trials, st["n_max"], st["m_max"], nc, c, width, k,
                  backend))
    return sigs


def fleet_signature_count() -> int:
    """Distinct level signatures the fleet has run in this process: the
    counterpart of the reference's count of compiled fleet executables.
    "Zero new executables after warmup" means, in the port, that a replay
    runs no shape signature that warmup did not, so this count stays put."""
    return len(_FLEET_SIGNATURES)


# the phases of a fleet call, in its ``times``; ``total_s`` is their sum
FLEET_PHASES = ("bucket_s", "coarsen_s", "initpart_s", "uncoarsen_s",
                "fetch_s")


@dataclass
class FleetBucket:
    """Host-side record of one shape bucket's run."""

    capacity: tuple          # (n_cap, m_cap) rung-0 capacity of the bucket
    indices: list            # lane tags: fleet indices (None: filler lane)
    levels: int              # batched hierarchy depth (levels list length)
    level_stats: list = field(default_factory=list)  # coarsest-first metas


@dataclass
class FleetResult:
    """``partition_fleet`` output: per-graph results in input order (a
    ``{tag: PartitionResult}`` dict from ``partition_fleet_stacked``) plus
    the bucket accounting."""

    results: Any
    buckets: list            # list[FleetBucket]
    times: dict = field(default_factory=dict)
    trials: int = 1
    config: Any = None


def _fleet_epilogue(gb: Graph, parts_bt, fstats, *, k: int, lam: float):
    """Per-lane best-of-T selection and final metrics, on the device."""
    idx = _best_trial(fstats["best_balanced"], fstats["best_cost"],
                      fstats["best_maxsize"])
    n_max = parts_bt.shape[-1]
    parts = parts_bt.gather(1, idx.view(-1, 1, 1).expand(-1, 1, n_max))[:, 0]
    sizes = metrics.part_sizes(gb, parts, k)
    W = gb.total_vweight()
    return parts, {
        "best_idx": idx.int(),
        "cut": metrics.cutsize(gb, parts),
        "imbalance": metrics.imbalance(sizes, W, k).view(torch.int32),
        "balanced": metrics.is_balanced(sizes, W, k, lam).int(),
        "trial_cuts": fstats["best_cost"],
        "trial_balanced": fstats["best_balanced"].int(),
    }


def _restore_padding(x: torch.Tensor, own_n_max: int, k: int) -> torch.Tensor:
    """A lane's (..., cap) parts at its own padding: cut, or extended with
    the ghost part k beyond the bucket's capacity."""
    cap = x.shape[-1]
    if own_n_max <= cap:
        return x[..., :own_n_max]
    pad = torch.full((*x.shape[:-1], own_n_max - cap), k, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], -1)


def partition_fleet_stacked(buckets, cfg: PartitionConfig, schedule,
                            times_extra=None, device=None) -> FleetResult:
    """Partition pre-stacked shape buckets — the serving entry point.

    ``buckets`` is a list of :class:`~repro_torch.core.graph.StackedBucket`
    (e.g. from a :class:`~repro_torch.core.graph.BucketAssembler` flush) and
    ``schedule`` the fixed capacity ladder they were assembled on.  Each
    bucket runs one batched V-cycle: coarsening, initial partitioning and
    uncoarsening over (B lanes, T trials), so each kernel launches once per
    batched step for the whole bucket.

    Returns a :class:`FleetResult` whose ``results`` is a ``{tag:
    PartitionResult}`` dict keyed by the lane tags; filler lanes (tag
    ``None``) are computed and dropped.  ``parts`` and ``trial_parts`` stay
    on the device at each member's own padding; every other result comes
    back in ONE blocking transfer for the whole fleet, at the end.

    ``times`` holds the phase seconds summed over the buckets, their sum
    ``total_s``, and the call's record as :func:`partition` gives it.
    """
    if not buckets:
        raise ValueError("partition_fleet_stacked needs at least one bucket")
    with trace.call(), trace.span("jet.fleet"):
        return _fleet_stacked(buckets, cfg, schedule, times_extra, device)


def _fleet_stacked(buckets, cfg: PartitionConfig, schedule, times_extra,
                   device) -> FleetResult:
    device = resolve_device(device)
    k = cfg.k
    seeds = _resolve_trial_seeds(cfg)
    trials = cfg.trials
    cn._check_backend(cfg.backend)
    times = {"coarsen_s": 0.0, "initpart_s": 0.0, "uncoarsen_s": 0.0,
             "fetch_s": 0.0}
    if times_extra:
        times.update(times_extra)

    pending = []  # (FleetBucket, orig_n_max, metas, packed, parts, parts_bt)
    for sb in buckets:
        gb = sb.graph.to(device)
        if cfg.backend == "sorted":
            cn.check_sorted(gb, k)
        t0 = time.perf_counter()
        with trace.span("jet.coarsen"):
            levels = co.multilevel_coarsen_fleet(
                gb, schedule, coarse_target=cfg.coarse_target,
                max_levels=cfg.max_levels, stall_ratio=cfg.stall_ratio,
                seed=cfg.seed)
            synchronize(device)
        times["coarsen_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        with trace.span("jet.initial"):
            parts_bt = initial.initial_partition_batch(
                levels[-1].graph, k, seeds, method=cfg.init_method)
            synchronize(device)
        times["initpart_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        stats_per_level, metas = [], []
        for i in range(len(levels) - 1, -1, -1):
            lv = levels[i]
            gi = lv.graph
            c = cfg.c_finest if i == 0 else cfg.c_coarse
            # one ELL width for the bucket: the max over its lanes, frozen
            # lanes included (their state is built too)
            max_deg = (int(lv.stats["max_degree"].max())
                       if cfg.backend == "ell" else None)
            cmap = lv.cmap
            if cmap is None:
                cmap = torch.arange(gi.n_max, dtype=torch.int32,
                                    device=device).expand(len(sb.tags), -1)
            active = trace.read(
                "fleet.active", lambda: torch.from_numpy(lv.active).to(device))
            parts_bt, stats = uncoarsen_level(
                gi, cmap, parts_bt, cfg.phi, k=k, lam=cfg.lam, c=c,
                backend=cfg.backend, patience=cfg.patience,
                max_iter=cfg.max_iter, b_max=cfg.b_max, variant=cfg.variant,
                rebuild_every=cfg.rebuild_every, max_degree=max_deg,
                active=active)
            stats_per_level.append(stats)
            meta = {"level": i, "n_max": lv.stats["n_max"],
                    "m_max": lv.stats["m_max"], "n": lv.stats["n"],
                    "m": lv.stats["m"], "max_degree": lv.stats["max_degree"],
                    "active": lv.active}
            if max_deg is not None:
                meta["ell_width"] = max_deg
            metas.append(meta)
        with trace.span("jet.epilogue"):
            parts, ep = _fleet_epilogue(levels[0].graph, parts_bt,
                                        stats_per_level[-1], k=k, lam=cfg.lam)
            names = list(stats_per_level[-1])
            ep["stats"] = torch.stack([
                torch.stack([st[kk].int() for kk in names])
                for st in stats_per_level])  # (L, S, B, T)
        times["uncoarsen_s"] += time.perf_counter() - t0
        _FLEET_SIGNATURES.update(level_signatures(
            len(sb.tags), trials, metas, k=k, backend=cfg.backend,
            c_finest=cfg.c_finest, c_coarse=cfg.c_coarse))
        bucket = FleetBucket(capacity=sb.capacity, indices=list(sb.tags),
                             levels=len(levels), level_stats=metas)
        pending.append((bucket, sb.orig_n_max, names, ep, parts, parts_bt))

    # the ONE blocking transfer of the whole fleet's results
    t0 = time.perf_counter()
    flat = torch.cat([v.reshape(-1) for p in pending for v in p[3].values()])
    host = trace.read("fleet.fetch", flat.cpu).numpy()
    times["fetch_s"] = time.perf_counter() - t0
    times["total_s"] = sum(times.get(name, 0.0) for name in FLEET_PHASES)
    times.update(trace.current().times())

    results: dict = {}
    off = 0
    for bucket, orig_n_max, names, ep, parts, parts_bt in pending:
        got = {}
        for key, v in ep.items():
            got[key] = host[off: off + v.numel()].reshape(tuple(v.shape))
            off += v.numel()
        imb = got["imbalance"].view(np.float32)
        for j, tag in enumerate(bucket.indices):
            if tag is None:  # filler lane: batch-width ballast only
                continue
            level_stats = []
            for li, meta in enumerate(bucket.level_stats):
                entry = {"level": meta["level"],
                         "n": int(meta["n"][j]), "m": int(meta["m"][j]),
                         "max_degree": int(meta["max_degree"][j]),
                         "n_max": meta["n_max"], "m_max": meta["m_max"],
                         "active": bool(meta["active"][j])}
                for si, kk in enumerate(names):
                    vals = got["stats"][li, si, j].tolist()
                    entry[kk] = vals[0] if trials == 1 else vals
                level_stats.append(entry)
            results[tag] = PartitionResult(
                parts=_restore_padding(parts[j], orig_n_max[j], k),
                cut=int(got["cut"][j]),
                imbalance=float(imb[j]),
                balanced=bool(got["balanced"][j]),
                levels=int(sum(m["active"][j] for m in bucket.level_stats)),
                # phase times are fleet-wide: one run serves every member
                times=dict(times, shared_across_fleet=True),
                level_stats=level_stats,
                config=cfg,
                trials=trials,
                best_trial=int(got["best_idx"][j]),
                trial_cuts=[int(x) for x in got["trial_cuts"][j]],
                trial_balanced=[bool(x) for x in got["trial_balanced"][j]],
                trial_parts=_restore_padding(parts_bt[j], orig_n_max[j], k),
            )
    return FleetResult(results=results, buckets=[p[0] for p in pending],
                       times=times, trials=trials, config=cfg)


def partition_fleet(graphs, cfg: PartitionConfig, schedule=None,
                    device=None) -> FleetResult:
    """Partition a fleet of graphs as shape-bucketed batched V-cycles.

    Graphs are grouped into static shape buckets on one shared capacity
    ladder (:func:`~repro_torch.core.graph.bucket_graphs`); each bucket's
    members are stacked along a lane axis and run through
    :func:`partition_fleet_stacked`.  Per-graph termination (coarsening
    depth, stalls, refinement patience) is select-masked per lane, so every
    graph's result equals its standalone ``partition()`` bit for bit.
    With ``schedule`` given, bucketing runs on that fixed ladder.

    Host reads: one batched (n, m) fetch at admission, two small reads per
    coarsening level and one per refinement iteration per bucket, and ONE
    transfer of all results at the end.
    """
    graphs = list(graphs)
    if not graphs:
        raise ValueError("partition_fleet needs at least one graph")
    with trace.call():   # the bucketing's read counts in the call's record
        t0 = time.perf_counter()
        schedule, bucket_map = gr.bucket_graphs(
            graphs, ratio=cfg.bucket_ratio, safety=cfg.bucket_safety,
            stall_ratio=cfg.stall_ratio, align=cfg.bucket_align,
            schedule=schedule)
        buckets = [gr.StackedBucket(
            capacity=cap,
            graph=gr.stack_bucket([graphs[i] for i in bucket_map[cap]], cap),
            tags=tuple(bucket_map[cap]),
            orig_n_max=tuple(graphs[i].n_max for i in bucket_map[cap]),
        ) for cap in sorted(bucket_map, reverse=True)]
        bucket_s = time.perf_counter() - t0

        sres = partition_fleet_stacked(buckets, cfg, schedule,
                                       times_extra={"bucket_s": bucket_s},
                                       device=device)
    results: list = [None] * len(graphs)
    for tag, r in sres.results.items():
        results[tag] = r
    return FleetResult(results=results, buckets=sres.buckets,
                       times=sres.times, trials=sres.trials, config=cfg)


def refine_only(g: Graph, parts0, cfg: PartitionConfig,
                device=None) -> PartitionResult:
    """Refinement-effectiveness mode: refine an imported partition on the
    finest graph only (paper §5.1 effectiveness tests)."""
    device = resolve_device(device)
    g = g.to(device)
    max_deg = int(g.degrees().max()) if cfg.backend == "ell" else None
    parts0 = torch.as_tensor(np.asarray(parts0), dtype=torch.int32,
                             device=device)[None]
    parts, stats = refine.jet_refine(
        g, parts0, cfg.k, lam=cfg.lam, c=cfg.c_finest, phi=cfg.phi,
        backend=cfg.backend, patience=cfg.patience, max_iter=cfg.max_iter,
        b_max=cfg.b_max, variant=cfg.variant,
        rebuild_every=cfg.rebuild_every, max_degree=max_deg,
    )
    parts = parts[0]
    sizes = metrics.part_sizes(g, parts, cfg.k)
    W = g.total_vweight()
    return PartitionResult(
        parts=parts,
        cut=int(metrics.cutsize(g, parts)),
        imbalance=float(metrics.imbalance(sizes, W, cfg.k)),
        balanced=bool(metrics.is_balanced(sizes, W, cfg.k, cfg.lam)),
        levels=1,
        level_stats=[{kk: int(vv[0]) for kk, vv in stats.items()}],
        config=cfg,
    )
