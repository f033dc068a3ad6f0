"""Read the numbers that decide ``correct`` over many seeds in one process:
the program's, the control's and the faults', one call a seed, at the
cell's own size.  Each seed is the partitioner's seed and shifts the
generator seeds of the traffic's random graph classes, so the readings
cover graphs and seeds beyond the benchmark's fixed pool.  The limits in ``limits/<cell>.json`` are set from what
this prints (the program's largest reading below, the control's and the
faults' smallest above).  The benchmark's runs never run it.

    python3 portbench/readings.py --workload mesh.single --base 7000000001 \\
        --seeds 12 --control 3 --faults state_unchanged:3
"""
import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

import torch  # noqa: E402

import bench  # noqa: E402
import plants  # noqa: E402


def read_seed(spec, seed: int, device, plant=None, cache=None) -> dict:
    """One call of the partitioner (or of a plant) with the partitioner
    seed ``seed``, on the traffic's graphs shifted by ``seed`` (made once
    where the traffic's graphs do not depend on it), judged by the plain
    reference."""
    lattices = all(e["gen"] in ("grid2d", "grid3d")
                   for e in spec.traffic["graphs"])
    key = None if lattices else seed
    if cache is None or cache.get("key", object()) != key:
        els = bench.make_graphs(spec, device, shift=seed)
        system = bench.System(spec, [bench.port_graph(el, device)
                                     for el in els], device)
        if cache is not None:
            cache.update(key=key, els=els, system=system)
    else:
        els, system = cache["els"], cache["system"]
    t0 = time.perf_counter()
    with plant(system) if plant else contextlib.nullcontext():
        answers, res = system.call(seed % bench.SEED_SPAN)
    del res
    call_s = time.perf_counter() - t0
    numbers, readings = bench.judge_all(spec, els, [answers])
    ok, _, failed = bench.verdict(spec, numbers, readings)
    return dict(numbers, seed=seed, call_s=call_s, correct=ok,
                failed=failed, cuts=[r["cut"] for r in readings])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--base", type=int, default=7000000001)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[],
                    help="name:count, a plant of plants.FAULTS")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(HERE)
    spec = bench.Spec(bench.Path(root), args.workload)
    cache = {}
    runs = [("program", None, args.seeds),
            ("control", plants.control, args.control)]
    for item in args.faults:
        name, count = item.split(":")
        runs.append((name, plants.FAULTS[name], int(count)))
    seed = args.base
    summary = {}
    for kind, plant, count in runs:
        rows = []
        for _ in range(count):
            row = read_seed(spec, seed, args.device, plant, cache)
            seed += 1
            row["kind"] = kind
            rows.append(row)
            print(json.dumps(row), flush=True)
        summary[kind] = rows
    names = list(spec.limits)
    for kind, rows in summary.items():
        pick = max if kind == "program" else min
        vals = {n: pick(r[n] for r in rows) for n in names if rows}
        print(f"{kind}: {'largest' if pick is max else 'smallest'} "
              f"readings {json.dumps(vals)}; correct "
              f"{sum(r['correct'] for r in rows)}/{len(rows)}", flush=True)
    if args.device == "cuda":
        print("peak", torch.cuda.max_memory_allocated(), "bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
