"""One run of one benchmark cell of the port's partitioner.

The cell, its configuration, its traffic and its metrics are found by name:
``BENCHMARK.json`` at the checkout's root names the cell's configuration
and traffic; ``configs/<config>.json`` holds the partitioner's settings and
the graph class's sizes; ``traffic/<traffic>.json`` the graphs, the pool
of partitioner seeds and how calls arrive; ``limits/<cell>.json`` the
limits of the numbers that decide ``correct``; ``metrics/<metric>.py`` the
reader of each per-layer metric.  So a new cell, configuration, traffic
mix or metric is new files and new entries, and no file here changes.

A run: make the graphs on the device, warm up with one call of the cell's
own shapes (set-up ends there), then call the partitioner back to back
over the pool of seeds, in whole passes, until ``--seconds`` have passed
(``--trace 0``), or three times with one seed: plainly, counting host
reads, and under ``torch.profiler`` (``--trace 1``); then judge every
answer against the plain reference (``reference.py``) and print one JSON
line.  The run seed picks where in the pool the calls start, so every run
seed gives the same work in another order.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

import graphgen
import reference

PB = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SEED_SPAN = (1 << 31) - (1 << 16)   # partitioner seeds stay int32 with T


class CellError(Exception):
    """The cell cannot run here: no such cell, not enough devices, or a
    forbidden module loaded."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """Everything one cell is made of, read from the benchmark's files."""

    def __init__(self, root: Path, workload: str):
        manifest = load_json(root / "BENCHMARK.json")
        cells = {c["name"]: c for c in manifest["workloads"]}
        if workload not in cells:
            raise CellError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.name = workload
        self.chips = int(self.cell["chips"])
        self.config = load_json(PB / "configs" / f"{self.cell['config']}.json")
        self.traffic = load_json(
            PB / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = load_json(PB / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [])
                          or ("workloads" not in m and m["moves"] in reported)]
        self.partitioner = dict(self.config["partitioner"])
        self.mode = self.traffic["mode"]

    def arg(self, value):
        """A traffic parameter: a number, or ``{"config": key}``."""
        if isinstance(value, dict):
            return self.config[value["config"]]
        return value


def make_graphs(spec: Spec, device, shift: int = 0) -> list:
    """The traffic's graphs, each from its generator seed (plus ``shift``,
    which only ``readings.py`` sets, to read other graphs of the class)."""
    out = []
    for entry in spec.traffic["graphs"]:
        gen = graphgen.GENERATORS[entry["gen"]]
        args = {k: spec.arg(v) for k, v in entry.get("args", {}).items()}
        gseed = (shift + int(entry.get("seed", 0))) & ((1 << 63) - 1)
        out.append(gen(**args, device=device, seed=gseed))
    return out


def port_graph(el, device):
    """The partitioner's input graph, from the benchmark's CSR arrays."""
    from repro_torch.core.graph import Graph

    xadj, adjncy, adjwgt, esrc = graphgen.to_csr(el)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    vwgt = torch.ones(el.n, dtype=torch.int32, device=device)
    return Graph(xadj, adjncy, adjwgt, vwgt, esrc, scalar(el.n),
                 scalar(adjncy.numel()))


def call_seed(spec: Spec, seed: int, call: int) -> int:
    """The partitioner's seed of call ``call``: the traffic's pool of seeds
    in the order that ``seed`` starts it at."""
    pool = spec.traffic["call_seeds"]
    return int(pool[(seed + call) % len(pool)]) % SEED_SPAN


def _answer(res) -> dict:
    return {"parts": res.parts.cpu(), "trial_parts": res.trial_parts.cpu(),
            "cut": int(res.cut), "balanced": bool(res.balanced),
            "trial_cuts": [int(c) for c in res.trial_cuts],
            "trial_balanced": [bool(b) for b in res.trial_balanced],
            "best_trial": int(res.best_trial)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class System:
    """The system under test: the port's ``partition`` (one graph a call)
    or ``partition_fleet`` (every graph of the traffic in one call)."""

    def __init__(self, spec: Spec, graphs, device, partitioner=None):
        from repro_torch.core import partition as pt

        self.pt = pt
        self.spec = spec
        self.graphs = graphs
        self.device = device
        self.settings = dict(partitioner or spec.partitioner)

    def config(self, seed: int):
        return self.pt.PartitionConfig(**self.settings, seed=seed)

    def run(self, seed: int):
        """One call of the partitioner, finished on the device."""
        cfg = self.config(seed)
        if self.spec.mode == "fleet":
            res = self.pt.partition_fleet(self.graphs, cfg,
                                          device=self.device)
        else:
            res = self.pt.partition(self.graphs[0], cfg, device=self.device)
        _sync(self.device)
        return res

    def answers(self, res) -> list:
        """What a call returned for each graph, copied to the host."""
        if self.spec.mode == "fleet":
            return [None if r is None else _answer(r) for r in res.results]
        return [_answer(res)]

    def call(self, seed: int):
        """One call; returns (its answers on the host, the raw result)."""
        res = self.run(seed)
        return self.answers(res), res


def _iterations(level) -> int:
    it = level["iterations"]
    return max(it) if isinstance(it, list) else int(it)


def launch_groups(mode: str, res, trials: int) -> list[dict]:
    """The jet_gain launches of one call, by level (and fleet bucket): the
    loop's iterations, the trials, the level's real rows and slots."""
    if mode != "fleet":
        return [{"launches": _iterations(st), "trials": trials,
                 "rows": int(st["n"]), "slots": int(st["m"])}
                for st in res.level_stats]
    groups = []
    for bucket in res.buckets:
        members = [res.results[t] for t in bucket.indices if t is not None]
        for li, meta in enumerate(bucket.level_stats):
            groups.append({
                "launches": max(_iterations(r.level_stats[li])
                                for r in members),
                "trials": trials,
                "rows": int(sum(int(x) for x in meta["n"])),
                "slots": int(sum(int(x) for x in meta["m"]))})
    return groups


def count_host_reads(fn):
    """``fn()`` with CUDA's sync debug mode on: (its result, the number of
    synchronizing device-to-host reads it made)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def read_profile(prof) -> dict:
    """Device busy time (the union of the device's operations), device time
    by operation name, and the idle gaps between device operations named
    by the innermost host operation running at their middle."""
    import bisect

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        elif e.duration_ns() > 0:
            host.append(span)
    dev.sort()
    host.sort()
    by_name: dict[str, float] = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
    busy_ns, gaps = 0, []
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy_ns += cur_t - cur_s
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy_ns += cur_t - cur_s
    starts = [h[0] for h in host]
    by_host: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "(no host operation)"
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e9
    return {"busy_s": busy_ns / 1e9, "device_ops": by_name,
            "idle_gaps": by_host, "device_op_count": len(dev)}


def load_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    if str(PB / "metrics") not in sys.path:
        sys.path.insert(0, str(PB / "metrics"))
    path = PB / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _finite(x):
    """A number as JSON can hold it: NaN (no answer read) becomes null."""
    return x if isinstance(x, int) or math.isfinite(x) else None


def power_limit() -> str | None:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def judge_all(spec: Spec, graphs, calls: list[list]) -> tuple[dict, list]:
    """Every answer of every call against the plain reference."""
    p = spec.partitioner
    k, lam, trials = int(p["k"]), float(p["lam"]), int(p.get("trials", 1))
    refs = [reference.Graph(el, k) for el in graphs]
    readings = []
    for answers in calls:
        for i, ref in enumerate(refs):
            ans = answers[i] if i < len(answers) else None
            readings.append(reference.judge(ref, ans, k, lam, trials))
    return reference.summarize(readings), readings


def verdict(spec: Spec, numbers: dict, readings: list) -> tuple[bool, dict,
                                                                  int]:
    """Each number that the cell's limits name against its limit, and the
    count of answers that fail one."""
    def within(value, limit):
        return value == value and value <= limit

    checks, ok = {}, bool(readings)
    for name, limit in spec.limits.items():
        ok &= within(numbers[name], limit)
        checks[name] = {"value": _finite(numbers[name]), "limit": limit}
    failed = sum(1 for r in readings
                 if not all(within(r[n], lim)
                            for n, lim in spec.limits.items()))
    return ok, checks, failed


def run(spec: Spec, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float | None = None, system_factory=System) -> dict:
    """One run; returns the result line's object.  ``system_factory`` lets
    a check put a broken or controlled system in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    from repro_torch.kernels import _build

    cuda = torch.device(device).type == "cuda"
    if cuda:
        _build.enable_compile_cache(
            PB.parent / "src" / "repro_torch" / "kernels" / "_build")
    els = make_graphs(spec, device)
    system = system_factory(spec, [port_graph(el, device) for el in els],
                            device)
    system.call(int(spec.traffic["warm_seed"]))  # warm-up: the cell's shapes
    _sync(device)
    setup_s = time.perf_counter() - t_start
    warm_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    calls, extra = [], {}
    if not trace:
        # whole passes over the pool, until --seconds have passed
        passes = len(spec.traffic["call_seeds"])
        t0 = time.perf_counter()
        while len(calls) % passes or not calls or \
                time.perf_counter() - t0 < seconds:
            answers, res = system.call(call_seed(spec, seed, len(calls)))
            del res
            calls.append(answers)
        window_s = time.perf_counter() - t0
    else:
        extra = trace_calls(system, spec, seed, calls, cuda)
        window_s = extra["wall_s"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise CellError("the run loaded " + ", ".join(found))
    del system
    if cuda:
        torch.cuda.empty_cache()

    numbers, readings = judge_all(spec, els, calls)
    correct, checks, failed = verdict(spec, numbers, readings)
    graphs = len(calls) * len(els)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": spec.chips,
                   "memory_peak_bytes": int(max(peak, warm_peak))}
    result = {"correct": correct, "attempted": graphs, "failed": failed}
    if not trace:
        good = [r for r in readings if r["cut"]]
        values = {
            "partition_s": window_s / len(calls),
            "graphs_per_s": graphs / window_s,
            "cut_pct": 100.0 * sum(r["cut"] for r in good)
            / max(sum(r["total_w"] for r in good), 1),
            "peak_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in spec.end_to_end}
    else:
        ctx = dict(extra, mode=spec.mode, graphs=len(els),
                   peaks=load_json(PB / "peaks.json"))
        result["metrics"] = {}
        for m in spec.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        device_info["busy_s"] = extra["profile"]["busy_s"]
        device_info["window_s"] = window_s
        result["breakdown"] = {
            "device_ops": _top(extra["profile"]["device_ops"]),
            "idle_gaps": _top(extra["profile"]["idle_gaps"])}
    result["device"] = device_info
    result["card"] = power_limit() if cuda else None
    result["calls"] = len(calls)
    result["checks"] = checks
    return result


def trace_calls(system: System, spec: Spec, seed: int, calls: list,
                cuda: bool) -> dict:
    """Three calls of one seed (the same work): plain (phase times,
    iterations, jet_gain's launches and their level shapes), with host
    reads counted, and under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.kernels as kernels

    s = call_seed(spec, seed, 0)
    trials = int(spec.partitioner.get("trials", 1))
    before = kernels.launch_counts["jet_gain"]
    t0 = time.perf_counter()
    answers, res = system.call(s)
    wall_s = time.perf_counter() - t0
    calls.append(answers)
    launches = kernels.launch_counts["jet_gain"] - before
    plain = {"times": dict(res.times),
             "iterations": (sum(_iterations(st) for st in res.level_stats)
                            if spec.mode != "fleet" else None)}
    groups = launch_groups(spec.mode, res, trials)
    del res
    if cuda:
        res, reads = count_host_reads(lambda: system.run(s))
        calls.append(system.answers(res))
        del res
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            res = system.run(s)
        calls.append(system.answers(res))
        del res
        profile_info = read_profile(prof)
        del prof
    else:
        reads, profile_info = None, {"busy_s": 0.0, "device_ops": {},
                                     "idle_gaps": {}, "device_op_count": 0}
    profile_info["jet_gain_launches"] = launches
    profile_info["launch_groups"] = groups
    return {"wall_s": wall_s, "plain": plain, "host_reads": reads,
            "profile": profile_info}


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = PB.parent
    try:
        spec = Spec(root, args.workload)
        if not torch.cuda.is_available():
            raise CellError("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < spec.chips:
            raise CellError(f"{spec.name} needs {spec.chips} devices, "
                            f"{torch.cuda.device_count()} found")
        sys.path.insert(0, str(root / "src"))
        result = run(spec, args.seed, args.seconds, bool(args.trace),
                     t_start=t_start)
    except (CellError, FileNotFoundError, ImportError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
