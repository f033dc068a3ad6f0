"""The Jet partitioner — multilevel driver (Alg 2.1) with batched trials.

Counterpart of ``repro.core.partition`` (single-graph entry points):
coarsen -> initial partition (coarsest) -> [project -> Jet refine] per
level, with T seed trials batched along a leading axis over ONE shared
hierarchy and the best trial (balanced first, then lowest cut) selected on
the device.

Every entry point runs on the card by default: ``device=None`` means
``cuda``, and raises when there is none.  Pass ``device="cpu"`` to run the
plain versions of the kernels on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import coarsen as co
from repro_torch.core import connectivity as cn
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


def uncoarsen_level(fine: Graph, cmap, parts_batch, phi, *, k, lam, c, backend,
                    patience, max_iter, b_max, variant, rebuild_every,
                    max_degree=None):
    """One uncoarsening level over the trial axis: project -> ghost-mask ->
    ConnState build -> Jet refinement.  ``parts_batch`` is (T, nc_max)."""
    parts = co.project_partition(cmap, parts_batch)
    parts = torch.where(fine.vertex_mask(), parts, k).int()
    conn0 = cn.build_state(fine, parts, k, backend, max_degree=max_degree)
    return refine._refine_loop(
        fine, parts, conn0, phi, k=k, lam=lam, c=c, backend=backend,
        patience=patience, max_iter=max_iter, b_max=b_max, variant=variant,
        rebuild_every=rebuild_every)


def _best_trial(balanced, cut, maxsize) -> torch.Tensor:
    """Best-of-T selection (same ordering as Alg 4.1's best tracking): a
    balanced trial beats an unbalanced one; among balanced trials the lowest
    cut wins; if none is balanced, the lowest max part weight wins with the
    lower cut breaking ties.  ``argmin`` takes the first index on ties."""
    inf = 0x7FFFFFFF
    idx_bal = torch.argmin(torch.where(balanced, cut, inf))
    idx_imb = torch.argmin(torch.where(maxsize == maxsize.min(), cut, inf))
    return torch.where(balanced.any(), idx_bal, idx_imb)


def partition(g: Graph, cfg: PartitionConfig, device=None) -> PartitionResult:
    """Full multilevel partition of ``g`` into ``cfg.k`` parts.

    With ``cfg.trials = T > 1`` the uncoarsening phase runs over T seed
    trials on the shared hierarchy and returns the best; ``trial_cuts`` /
    ``trial_balanced`` / ``trial_parts`` expose the whole batch.  Trial
    ``t`` equals a ``trials=1`` run with ``trial_seeds=(seeds[t],)``.
    """
    device = resolve_device(device)
    g = g.to(device)
    k = cfg.k
    seeds = _resolve_trial_seeds(cfg)
    trials = cfg.trials
    cn._check_backend(cfg.backend)
    if cfg.backend == "sorted":  # the finest level is the largest
        cn.check_sorted(g, k, trials)

    t0 = time.perf_counter()
    levels = co.multilevel_coarsen(
        g, coarse_target=cfg.coarse_target, max_levels=cfg.max_levels,
        stall_ratio=cfg.stall_ratio, seed=cfg.seed, mode=cfg.coarsen_mode,
        bucket_ratio=cfg.bucket_ratio, bucket_safety=cfg.bucket_safety,
        bucket_align=cfg.bucket_align,
    )
    synchronize(device)
    t_coarsen = time.perf_counter() - t0

    t0 = time.perf_counter()
    parts_b = initial.initial_partition_batch(levels[-1].graph, k, seeds,
                                              method=cfg.init_method)
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

    fstats = stats_per_level[-1]
    best_idx = int(_best_trial(fstats["best_balanced"], fstats["best_cost"],
                               fstats["best_maxsize"]))
    parts = parts_b[best_idx]
    sizes = metrics.part_sizes(g, parts, k)
    W = g.total_vweight()
    cut = int(metrics.cutsize(g, parts))
    imb = float(metrics.imbalance(sizes, W, k))
    balanced = bool(metrics.is_balanced(sizes, W, k, cfg.lam))
    names = list(fstats)
    per_level = torch.stack([torch.stack([s[kk].int() for kk in names])
                             for s in stats_per_level]).tolist()  # (L, S, T)
    t_uncoarsen = time.perf_counter() - t0

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
        trial_cuts=fstats["best_cost"].tolist(),
        trial_balanced=fstats["best_balanced"].tolist(),
        trial_parts=parts_b,
    )


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
