"""Partitioner CLI: partition generated or user-supplied graphs.

Single graph:

    PYTHONPATH=src python -m repro_torch.launch.partition_cli --graph grid \
        --size 96 --k 16 --backend sorted --out parts.npy

Fleet mode (DESIGN.md §10) — many graphs, shape-bucketed and batched
through one V-cycle per bucket:

    PYTHONPATH=src python -m repro_torch.launch.partition_cli \
        --fleet grid:96 grid:90 cube:12 --k 16

Runs on the GPU (``--device cuda``, the default) or the CPU (``--device
cpu``) and prints the same JSON report as ``repro.launch.partition_cli``.
Exits nonzero (with a stderr diagnostic) when the selected partition of
any requested graph is unbalanced, so callers can gate on the return code.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.core.graph import build_csr_host
from repro_torch.core.partition import (PartitionConfig, partition,
                                        partition_fleet)
from repro_torch.data import graphs as gen

GRAPH_KINDS = ("grid", "cube", "rmat", "geo", "smallworld", "edgelist")


def _make_graph(kind: str, size: int, seed: int, edges: str | None = None):
    if kind == "edgelist":
        if not edges:
            raise SystemExit("--graph edgelist requires --edges PATH")
        e = np.load(edges)
        return build_csr_host(int(e.max()) + 1, e)
    if kind == "grid":
        return gen.grid2d(size, size)
    if kind == "cube":
        s = max(4, round(size ** (2 / 3)))
        return gen.grid3d(s, s, s)
    if kind == "rmat":
        return gen.rmat(scale=max(8, size.bit_length() + 2))
    if kind == "geo":
        return gen.random_geometric(size * size, seed=seed)
    if kind == "smallworld":
        return gen.small_world(size * size, seed=seed)
    raise SystemExit(f"unknown graph kind {kind!r}")


def _parse_fleet_spec(spec: str, default_size: int, default_seed: int):
    """``name[:size[:seed]]`` -> (kind, size, seed)."""
    parts = spec.split(":")
    kind = parts[0]
    try:
        if kind not in GRAPH_KINDS or kind == "edgelist" or len(parts) > 3:
            raise ValueError
        size = int(parts[1]) if len(parts) > 1 else default_size
        seed = int(parts[2]) if len(parts) > 2 else default_seed
    except ValueError:
        raise SystemExit(
            f"bad --fleet spec {spec!r}: expected name[:size[:seed]] with "
            f"name in {GRAPH_KINDS[:-1]} and integer size/seed"
        ) from None
    return kind, size, seed


def _graph_report(g, res, k):
    return {
        "n": int(g.n), "m": int(g.m) // 2, "k": k,
        "cut": res.cut, "imbalance": res.imbalance,
        "balanced": res.balanced, "levels": res.levels,
        "trials": res.trials, "best_trial": res.best_trial,
        "trial_cuts": res.trial_cuts, "trial_balanced": res.trial_balanced,
        "times": res.times,
        "level_stats": [
            {kk: st[kk] for kk in ("level", "n", "m", "n_max", "m_max")
             if kk in st}
            for st in res.level_stats
        ],
    }


def _fleet(args, cfg) -> int:
    """Fleet mode: one JSON report per member; exits 1 if any member is
    unbalanced, 2 on duplicate members."""
    if args.out or args.edges:
        raise SystemExit(
            "--out/--edges are single-graph options and would be "
            "silently ignored in fleet mode — drop them or run per graph"
        )
    specs = [_parse_fleet_spec(s, args.size, args.seed) for s in args.fleet]
    dupes = sorted({
        f"{kind}:{size}:{seed}" for i, (kind, size, seed)
        in enumerate(specs) if (kind, size, seed) in specs[:i]
    })
    if dupes:
        print(
            f"ERROR: duplicate --fleet member name(s): {', '.join(dupes)} — "
            "every fleet member must be unique, or downstream consumers "
            "keying reports by spec would silently collapse entries (give "
            "duplicates distinct seeds, e.g. grid:96:0 grid:96:1)",
            file=sys.stderr,
        )
        return 2
    graphs = [_make_graph(kind, size, seed) for kind, size, seed in specs]
    fres = partition_fleet(graphs, cfg, device=args.device)
    report = {
        "fleet": [
            {"spec": args.fleet[i]}
            | _graph_report(graphs[i], fres.results[i], args.k)
            for i in range(len(graphs))
        ],
        "buckets": [
            {"capacity": list(b.capacity), "members": b.indices,
             "levels": b.levels}
            for b in fres.buckets
        ],
        "times": fres.times,
    }
    print(json.dumps(report, indent=1))
    unbalanced = [args.fleet[i] for i, r in enumerate(fres.results)
                  if not r.balanced]
    if unbalanced and not args.allow_unbalanced:
        print(
            f"ERROR: selected partition unbalanced for {len(unbalanced)}/"
            f"{len(graphs)} fleet member(s) ({', '.join(unbalanced)}) at "
            f"lam={args.imbalance} — failing so callers can gate on the exit "
            "code (--allow-unbalanced to override)",
            file=sys.stderr,
        )
        return 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="grid", choices=list(GRAPH_KINDS))
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--edges", default=None,
                    help="path to a .npy (E,2) edge list (--graph edgelist)")
    ap.add_argument("--fleet", nargs="+", default=None, metavar="SPEC",
                    help="fleet mode: partition several graphs in one "
                         "shape-bucketed batched run; SPEC is "
                         "name[:size[:seed]], e.g. grid:96 cube:12")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--imbalance", type=float, default=0.03)
    ap.add_argument("--phi", type=float, default=0.999)
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "sorted", "ell"])
    ap.add_argument("--rebuild-every", type=int, default=0,
                    help="full ConnState rebuild period inside refinement "
                         "(0=never/incremental, 1=rebuild each iteration)")
    ap.add_argument("--coarse-target", type=int, default=4096,
                    help="stop coarsening at this many vertices")
    ap.add_argument("--max-levels", type=int, default=40,
                    help="coarsening depth cap")
    ap.add_argument("--coarsen-mode", default="device",
                    choices=["device", "host"],
                    help="device: on-device levels on the shape schedule; "
                         "host: legacy per-level numpy repack (single-graph "
                         "mode only)")
    ap.add_argument("--bucket-ratio", type=float, default=1.6,
                    help="shape-schedule geometric shrink per rung")
    ap.add_argument("--bucket-safety", type=float, default=1.25,
                    help="headroom multiplier on the rung shrink")
    ap.add_argument("--bucket-align", type=int, default=64,
                    help="capacity rung alignment (bucket sharing)")
    ap.add_argument("--init", default="voronoi", choices=["voronoi", "random"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trials", type=int, default=None,
                    help="best-of-N trials over one shared hierarchy; the "
                         "balanced lowest-cut trial wins (default: "
                         "len(--trial-seeds), else 1)")
    ap.add_argument("--trial-seeds", default=None,
                    help="comma-separated per-trial init seeds "
                         "(default: seed..seed+trials-1)")
    ap.add_argument("--allow-unbalanced", action="store_true",
                    help="exit 0 even when the selected partition misses "
                         "the balance constraint")
    ap.add_argument("--out", default=None, help="write parts as .npy "
                    "(single-graph mode only)")
    args = ap.parse_args(argv)

    trial_seeds = (
        tuple(int(s) for s in args.trial_seeds.split(","))
        if args.trial_seeds else None
    )
    if args.trials is None:  # the seed list determines the trial count
        args.trials = len(trial_seeds) if trial_seeds else 1
    cfg = PartitionConfig(k=args.k, lam=args.imbalance, phi=args.phi,
                          backend=args.backend, init_method=args.init,
                          rebuild_every=args.rebuild_every, seed=args.seed,
                          coarse_target=args.coarse_target,
                          max_levels=args.max_levels,
                          coarsen_mode=args.coarsen_mode,
                          bucket_ratio=args.bucket_ratio,
                          bucket_safety=args.bucket_safety,
                          bucket_align=args.bucket_align,
                          trials=args.trials, trial_seeds=trial_seeds)

    if args.fleet:
        return _fleet(args, cfg)
    g = _make_graph(args.graph, args.size, args.seed, edges=args.edges)
    res = partition(g, cfg, device=args.device)
    print(json.dumps(_graph_report(g, res, args.k), indent=1))
    if args.out:
        np.save(args.out, res.parts.cpu().numpy()[: int(g.n)])
        print(f"parts -> {args.out}")
    if not res.balanced and not args.allow_unbalanced:
        print(
            f"ERROR: selected trial {res.best_trial} is unbalanced "
            f"(imbalance {res.imbalance:.4f} > lam {args.imbalance}) — "
            "failing so callers can gate on the exit code "
            "(--allow-unbalanced to override)",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

