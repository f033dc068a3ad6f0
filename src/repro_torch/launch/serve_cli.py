"""Serving CLI: replay a partition request stream through PartitionServer.

Counterpart of ``repro.launch.serve_cli``.  A workload spec names graph
families, a k mix, an arrival rate, and a request count; the CLI generates
the (seeded, deterministic) request stream, replays it through an
in-process :class:`PartitionServer` with simulated arrival times, and
reports latency / throughput / occupancy.

    PYTHONPATH=src python -m repro_torch.launch.serve_cli \
        --families grid:16 grid:15 grid:8 --ks 4,8 --count 24 \
        --rate 500 --window-ms 2 --lanes 2 --verify

    PYTHONPATH=src python -m repro_torch.launch.serve_cli --workload spec.json

Runs on the GPU (``--device cuda``, the default) or the CPU (``--device
cpu``).  Spec JSON mirrors the flags::

    {"families": [{"graph": "grid", "size": 16, "weight": 2},
                  {"graph": "grid", "size": 8}],
     "ks": [4, 8], "count": 24, "rate_rps": 500.0,
     "trials": 1, "seed": 0}
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.core.partition import (PartitionConfig, fleet_signature_count,
                                        partition)
from repro_torch.launch.partition_cli import _make_graph, _parse_fleet_spec
from repro_torch.launch.partition_serve import (
    PartitionServer, ServeConfig, serve_signatures,
)


def build_workload(spec: dict) -> list[dict]:
    """Materialize a spec into a deterministic request list.

    Each request: ``{"t": arrival offset (s), "graph": Graph, "k": int,
    "trials": int, "family": label}``.  Families are sampled by weight and
    arrival gaps are exponential at ``rate_rps``, both from one seeded
    generator — the same spec always yields the same stream, the one the
    reference's ``build_workload`` yields.  k cycles round-robin through
    the mix so every replay is mixed-k by construction.
    """
    fams = spec.get("families") or [{"graph": "grid", "size": 16}]
    fams = [f if isinstance(f, dict) else {"graph": f[0], "size": f[1]}
            for f in fams]
    ks = list(spec.get("ks") or [8])
    count = int(spec.get("count", 16))
    rate = float(spec.get("rate_rps", 500.0))
    trials = int(spec.get("trials", 1))
    seed = int(spec.get("seed", 0))

    rng = np.random.default_rng(seed)
    weights = np.asarray([float(f.get("weight", 1.0)) for f in fams])
    weights = weights / weights.sum()
    # one Graph instance per family, shared by its requests (the server
    # never mutates request graphs)
    built = [
        _make_graph(f["graph"], int(f["size"]), int(f.get("seed", seed)))
        for f in fams
    ]
    # the label keys verify/warmup dedup, so it must be unique per distinct
    # graph: families that pin their own seed carry it in the label (two
    # geo:8 entries with different seeds are different graphs)
    labels = [
        f"{f['graph']}:{f['size']}" + (f":{f['seed']}" if "seed" in f
                                       else "")
        for f in fams
    ]
    reqs = []
    t = 0.0
    for i in range(count):
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        fi = int(rng.choice(len(fams), p=weights))
        reqs.append({
            "t": t,
            "graph": built[fi],
            "k": ks[i % len(ks)],
            "trials": trials,
            "family": labels[fi],
        })
    return reqs


def workload_shapes(workload: list[dict]):
    """One representative graph per distinct family — the warmup grid's
    shape axis."""
    seen, shapes = set(), []
    for r in workload:
        if r["family"] not in seen:
            seen.add(r["family"])
            shapes.append(r["graph"])
    return shapes


async def replay_workload(server: PartitionServer,
                          workload: list[dict]) -> list[dict]:
    """Fire the request stream at its arrival offsets; gather responses.

    Returns one record per request with the caller-observed latency
    (submit -> response, inclusive of coalescing wait) and the result.
    """

    async def one(req):
        await asyncio.sleep(req["t"])
        t0 = time.perf_counter()
        res = await server.submit(req["graph"], k=req["k"],
                                  trials=req["trials"])
        return {
            "family": req["family"], "k": req["k"], "trials": req["trials"],
            "latency_s": time.perf_counter() - t0,
            "cut": res.cut, "balanced": res.balanced, "result": res,
        }

    async with server:
        return list(await asyncio.gather(*(one(r) for r in workload)))


def verify_responses(records: list[dict], workload: list[dict],
                     pcfg: PartitionConfig, device) -> dict:
    """Run every distinct (family, k, trials) of ``records`` through a
    standalone ``partition()`` on ``device`` and raise ``AssertionError``
    unless each response has its cut, balance and parts, bit for bit.
    Returns the standalone results by (family, k, trials)."""
    solo_cache: dict = {}
    for rec in records:
        key = (rec["family"], rec["k"], rec["trials"])
        if key not in solo_cache:
            g = next(r["graph"] for r in workload
                     if r["family"] == rec["family"])
            solo_cache[key] = partition(
                g, replace(pcfg, k=rec["k"], trials=rec["trials"]),
                device=device)
        solo = solo_cache[key]
        # parts stay on the device: compare them on the host
        same = (rec["cut"] == solo.cut
                and rec["balanced"] == solo.balanced
                and torch.equal(rec["result"].parts.cpu(), solo.parts.cpu()))
        if not same:
            raise AssertionError(
                f"serve response diverged from standalone partition() "
                f"for {key}: serve cut {rec['cut']} vs solo {solo.cut}"
            )
    return solo_cache


def run_workload(scfg: ServeConfig, spec: dict, *, warmup: bool = True,
                 verify: bool = False, workload: "list[dict] | None" = None,
                 device=None) -> dict:
    """Build, (optionally) warm up, and replay a workload; return a report.

    ``verify=True`` re-runs every distinct (family, k, trials) combination
    through standalone ``partition()`` on the same device and asserts each
    coalesced response is bit-identical — the serving correctness
    contract.  ``workload`` passes a stream already built from ``spec``
    (callers that sized the ladder from it) so graphs aren't constructed
    twice.
    """
    if workload is None:
        workload = build_workload(spec)
    server = PartitionServer(scfg, device=device)
    report = {"spec": {kk: vv for kk, vv in spec.items()
                       if kk != "families"} |
              {"families": [f"{f['graph']}:{f['size']}" if isinstance(f, dict)
                            else f"{f[0]}:{f[1]}"
                            for f in (spec.get("families") or [])]},
              "device": str(server.device)}
    if warmup:
        report["warmup"] = {
            kk: vv for kk, vv in server.warmup(
                workload_shapes(workload),
                ks=sorted({r["k"] for r in workload}),
                trials=sorted({r["trials"] for r in workload}),
                seed=scfg.partition.seed,
            ).items() if kk != "signatures"
        }
    sigs0 = fleet_signature_count()
    t0 = time.perf_counter()
    records = asyncio.run(replay_workload(server, workload))
    wall = time.perf_counter() - t0
    report["post_warmup_new_executables" if warmup
           else "new_executables"] = fleet_signature_count() - sigs0

    if verify:
        verify_responses(records, workload, scfg.partition, server.device)
        report["bit_identical"] = True

    lats = sorted(r["latency_s"] for r in records)
    report |= {
        "requests": len(records),
        "wall_s": wall,
        "throughput_rps": len(records) / max(wall, 1e-9),
        "p50_latency_ms": 1e3 * float(np.percentile(lats, 50)),
        "p95_latency_ms": 1e3 * float(np.percentile(lats, 95)),
        "per_request": [
            {kk: r[kk] for kk in ("family", "k", "trials", "cut",
                                  "balanced")}
            | {"latency_ms": 1e3 * r["latency_s"]}
            for r in records
        ],
        "server": server.metrics(),
        "serve_signatures": len(serve_signatures(server.dispatch_log)),
        # per-dispatch bucket records (lanes/real/member_n_max/levels) —
        # the mixed-occupancy evidence
        "dispatch_buckets": [d["buckets"] for d in server.dispatch_log],
    }
    if warmup:
        wsigs = serve_signatures(server.warmup_log)
        report["warmup_signatures"] = len(wsigs)
        report["replay_covered_by_warmup"] = (
            serve_signatures(server.dispatch_log) <= wsigs
        )
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default=None,
                    help="workload spec JSON path (overrides the stream "
                         "flags below)")
    ap.add_argument("--families", nargs="+", default=["grid:16", "grid:8"],
                    metavar="SPEC", help="graph families, name[:size[:seed]]")
    ap.add_argument("--ks", default="8", help="comma-separated k mix")
    ap.add_argument("--count", type=int, default=16)
    ap.add_argument("--rate", type=float, default=500.0,
                    help="mean arrival rate, requests/s")
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="coalescing window")
    ap.add_argument("--lanes", type=int, default=2,
                    help="fixed batch width per dispatched bucket")
    ap.add_argument("--ladder-n", type=int, default=None,
                    help="serve ladder top rung, vertices (default: fit "
                         "the workload's largest family)")
    ap.add_argument("--ladder-m", type=int, default=None)
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "sorted", "ell"])
    ap.add_argument("--coarse-target", type=int, default=4096)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup pass over the (rung, k) grid")
    ap.add_argument("--verify", action="store_true",
                    help="assert every response is bit-identical to a "
                         "standalone partition() run")
    ap.add_argument("--compile-cache", default=None,
                    help="directory for the CUDA kernel libraries, shared "
                         "by every process pointed at it")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)

    if args.workload:
        with open(args.workload) as f:
            spec = json.load(f)
    else:
        fams = [_parse_fleet_spec(s, 16, args.seed) for s in args.families]
        spec = {
            "families": [{"graph": kk, "size": ss, "seed": sd}
                         for kk, ss, sd in fams],
            "ks": [int(x) for x in args.ks.split(",")],
            "count": args.count, "rate_rps": args.rate,
            "trials": args.trials, "seed": args.seed,
        }

    workload = build_workload(spec)
    if args.ladder_n is None or args.ladder_m is None:
        shapes = workload_shapes(workload)
        args.ladder_n = args.ladder_n or max(g.n_max for g in shapes)
        args.ladder_m = args.ladder_m or max(g.m_max for g in shapes)

    pcfg = PartitionConfig(backend=args.backend,
                           coarse_target=args.coarse_target, seed=args.seed)
    scfg = ServeConfig(ladder_n=args.ladder_n, ladder_m=args.ladder_m,
                       window_s=args.window_ms / 1e3, lanes=args.lanes,
                       partition=pcfg, compile_cache=args.compile_cache)
    try:
        report = run_workload(scfg, spec, warmup=not args.no_warmup,
                              verify=args.verify, workload=workload,
                              device=args.device)
    except AssertionError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    summary = {kk: vv for kk, vv in report.items()
               if kk not in ("per_request", "dispatch_buckets")}
    print(json.dumps(summary, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"-> {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
