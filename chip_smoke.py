#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout's
``src/``; it imports no JAX.  Phases, each of which must pass:

  (a) card and build: the card's name and power limit; build every kernel
      (one nvcc per source, all at once) and print ptxas's report of each.
  (b) jet_gain against plain: its plain PyTorch version on random panels
      (D in {4, 6, 37, 300}, k in {2, 64, 1000}, T in {1, 4}, with ties,
      ghost rows and rows with no other part): exact.
  (b2) segment_reduce against plain: M in {1, 255, 256, 257, 10^5,
      2.4*10^7} at F = 1 and up to 10^5 at F in {3, 128}; all rows in one
      segment, every row its own, runs spanning many tiles, mostly empty
      segments, ids >= S.  int32 exact; float32 within 1e-5 + 1e-5 * (the
      sum of |x| over the segment) and bitwise equal across two launches.
  (b3) slot() on the card equals the CPU's over [-2^16, 2^22] and the
      float32 windows around every 2^j (its log2 correction table).
  (c) card against golden: partition() on the card, every backend and
      the host-mode cases, against the committed JAX reference results of
      the small parity graphs: exact.
  (d) card against CPU: grid2d 256x256, k=16, T=2, with ell, sorted, and
      ell after host-mode coarsening, on the card and on the CPU: parts
      and all stats exactly equal.
  (e) full width: grid3d 100^3 (10^6 vertices), k=64, T=4, ell, defaults
      otherwise: balanced, the cut equals one recomputed from the parts,
      jet_gain launched once per refinement iteration; then jet_gain and its
      plain version timed with CUDA events at the finest level's shapes.
  (f) where the time goes: the same partition() once more under
      torch.profiler — device busy time against phase (e)'s wall time, and
      the kernels that take the most device time.
  (g) full width, sorted: the configuration of (e) with backend="sorted":
      parts, trial parts, cut and level stats equal (e)'s bit for bit, and
      segment_reduce launched as often as the loop's queries need; the
      kernel, its plain version and index_add_ timed at the finest level's
      shapes; the top device operations and the sort's share of them.
  (h) power-law graph: rmat scale 20, edge factor 8, k=64, T=4, sorted
      against dense: equal parts; the time and peak memory of each, and
      the padded degree and state bytes that ell would need there.

Prints ``{"kernels": [...]}`` and the card's name and power limit on lines
before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, with no result line, when any phase fails or there is no card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    build_s = time.perf_counter() - t0
    for name, log in _build.build_logs.items():
        ptxas = [ln for ln in log.splitlines() if "ptxas info" in ln]
        print(f"(a) {name} ptxas: " + " | ".join(ptxas))
    print(f"(a) kernels built in {build_s:.1f} s")


def phase_kernel_vs_plain(tp, dev):
    import torch

    from repro_torch.kernels.jet_gain import ops
    from repro_torch.kernels.jet_gain.ref import jet_gain_ref

    n_cases = 0
    for t in (None, 4):
        for d in (4, 6, 37, 300):
            for k in (2, 64, 1000):
                n = max(2000, 400000 // d)
                ins = [torch.from_numpy(a).to(dev)
                       for a in tp.panel(n, d, k, t, seed=d * k)]
                want = jet_gain_ref(*ins, k)
                got = ops.jet_gain_from_parts(*ins, k)
                torch.cuda.synchronize()
                for g_, w in zip(got, want):
                    if not torch.equal(g_, w):
                        raise AssertionError(
                            f"(b) jet_gain differs from plain at T={t} D={d} "
                            f"k={k}")
                n_cases += 1
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (500, 40)))
    for fn in (torch.argmax, torch.argmin):
        if not torch.equal(fn(x.to(dev), dim=1).cpu(), fn(x, dim=1)):
            raise AssertionError(f"(b) {fn.__name__} ties differ on the card")
    print(f"(b) jet_gain == plain on {n_cases} panels; argmax/argmin ties agree")


def phase_segment_vs_plain(tp, dev):
    import torch

    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref

    shapes = [(m, 1) for m in (1, 255, 256, 257, 10**5, 24_000_000)]
    shapes += [(m, f) for f in (3, 128) for m in (1, 255, 256, 257, 10**5)]
    n_cases, worst = 0, 0.0
    t0 = time.perf_counter()
    for m, f in shapes:
        for kind in tp.SEGMENT_KINDS:
            for dtype in (torch.int32, torch.float32):
                data, seg, s = tp.segment_case(m, f, kind, dtype, seed=m + f,
                                               device=dev)
                want = segment_sum_sorted_ref(data, seg, s)
                got = ops.segment_sum_sorted(data, seg, s)
                again = ops.segment_sum_sorted(data, seg, s)
                torch.cuda.synchronize()
                where = f"(b2) segment_reduce M={m} F={f} {kind} {dtype}"
                if not torch.equal(got, again):
                    raise AssertionError(f"{where}: two launches differ")
                if dtype == torch.int32:
                    if not torch.equal(got, want):
                        raise AssertionError(f"{where}: differs from plain")
                else:
                    err = (got - want).abs()
                    bound = 1e-5 + 1e-5 * segment_sum_sorted_ref(
                        data.abs(), seg, s)
                    if not bool((err <= bound).all()):
                        raise AssertionError(
                            f"{where}: |kernel - plain| {float(err.max())} "
                            "over the tolerance")
                    worst = max(worst, float((err / bound).max()))
                n_cases += 1
                del data, seg, want, got, again
    print(f"(b2) segment_reduce == plain on {n_cases} panels (int32 exact; "
          f"float32 at most {worst:.3f} of its tolerance; bitwise equal "
          f"across launches) in {time.perf_counter() - t0:.1f} s")


def phase_slot(tp, dev):
    import torch

    from repro_torch.core.rebalance import slot

    loss = torch.from_numpy(tp.slot_losses())
    cpu = slot(loss)
    card = slot(loss.to(dev)).cpu()
    if not torch.equal(card, cpu):
        bad = loss[card != cpu][:10].tolist()
        raise AssertionError(f"(b3) slot() differs on the card at {bad}")
    print(f"(b3) slot() on the card == CPU on {loss.numel()} losses")


def phase_golden(tp, dev):
    golden = tp.load_golden()
    t0 = time.perf_counter()
    names = tp.all_cases()
    for name in names:
        got = tp.summary(tp.torch_result(name, "cuda"))
        if got != golden[name]:
            raise AssertionError(f"(c) {name}: card {got} != golden "
                                 f"{golden[name]}")
    print(f"(c) {len(names)} small cases (dense, sorted, ell, host mode) "
          f"equal the JAX golden results ({time.perf_counter() - t0:.1f} s)")


def phase_card_vs_cpu(tp):
    from repro_torch.core.partition import PartitionConfig, partition
    from repro_torch.data import graphs as gen

    g = gen.grid2d(256, 256)
    for backend, mode in (("ell", "device"), ("sorted", "device"),
                          ("ell", "host")):
        cfg = PartitionConfig(k=16, trials=2, backend=backend,
                              coarsen_mode=mode)
        t0 = time.perf_counter()
        card = partition(g, cfg)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = partition(g, cfg, device="cpu")
        t_cpu = time.perf_counter() - t0
        what = f"grid2d 256x256 k=16 T=2 {backend}, {mode} coarsening"
        if tp.summary(card) != tp.summary(cpu) or \
                card.imbalance != cpu.imbalance:
            raise AssertionError(f"(d) {what}: card {tp.summary(card)} != "
                                 f"cpu {tp.summary(cpu)}")
        print(f"(d) {what}: card == cpu, cut {card.cut}, {card.levels} "
              f"levels (card {t_card:.1f} s, cpu {t_cpu:.1f} s)")


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _run(g, cfg):
    """partition() on the card from zeroed launch counts and peak memory:
    (result, launch counts, peak bytes)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.partition import partition

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = partition(g, cfg)
    torch.cuda.synchronize()
    return res, dict(kernels.launch_counts), torch.cuda.max_memory_allocated()


def phase_full_width(dev):
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.data import graphs as gen
    from repro_torch.kernels.jet_gain import ops
    from repro_torch.kernels.jet_gain.ref import jet_gain_ref

    t0 = time.perf_counter()
    g = gen.grid3d(100, 100, 100)
    print(f"(e) grid3d 100^3: n={int(g.n)}, directed edges={int(g.m)} "
          f"(built in {time.perf_counter() - t0:.1f} s)")
    cfg = PartitionConfig(k=64, trials=4, backend="ell")
    res, launches, peak = _run(g, cfg)

    # independent checks from the host arrays
    n, k = int(g.n), cfg.k
    parts = res.parts.cpu().numpy()[:n]
    src, dst = g.esrc.numpy()[: int(g.m)], g.adjncy.numpy()[: int(g.m)]
    w = g.adjwgt.numpy()[: int(g.m)]
    cut = int(w[parts[src] != parts[dst]].sum()) // 2
    sizes = np.bincount(parts, weights=g.vwgt.numpy()[:n], minlength=k)
    limit = int((1.0 + cfg.lam) * sizes.sum() / k)  # W/k is far from an integer
    iters = [max(st["iterations"]) for st in res.level_stats]
    if not (parts.min() >= 0 and parts.max() < k):
        raise AssertionError("(e) parts out of range")
    if cut != res.cut:
        raise AssertionError(f"(e) reported cut {res.cut} != recomputed {cut}")
    if not res.balanced or sizes.max() > limit:
        raise AssertionError(f"(e) unbalanced: max part {sizes.max()} > {limit}")
    if launches.get("jet_gain", 0) != sum(iters) or sum(iters) == 0:
        raise AssertionError(f"(e) jet_gain launches {launches} != "
                             f"refinement iterations {sum(iters)}")
    print(f"(e) cut {res.cut}, imbalance {res.imbalance:.6f}, levels "
          f"{res.levels}, trial cuts {res.trial_cuts}, best trial "
          f"{res.best_trial}")
    print(f"(e) iterations per level (coarsest first, max over trials): {iters}")
    print("(e) phase times: " + json.dumps(
        {kk: round(v, 3) for kk, v in res.times.items()}))
    print(f"(e) max_memory_allocated {peak} bytes; launches {launches}")

    # jet_gain at the finest level's shapes, as the main path launches it
    gd = g.to(dev)
    nbr, wgt = ops.csr_to_ell(gd, res.level_stats[-1]["max_degree"])
    tparts = res.trial_parts.contiguous()
    nbr_parts = ops.lookup_nbr_parts(nbr, tparts, k)
    got = ops.jet_gain_from_parts(nbr_parts, wgt, tparts, k)
    want = jet_gain_ref(nbr_parts, wgt, tparts, k)
    err = max(int((a - b).abs().max()) for a, b in zip(got, want))
    ms = _time_ms(lambda: ops.jet_gain_from_parts(nbr_parts, wgt, tparts, k), 50)
    plain_ms = _time_ms(lambda: jet_gain_ref(nbr_parts, wgt, tparts, k), 5)
    nbytes = (nbr_parts.numel() + wgt.numel() + tparts.numel()
              + 3 * tparts.numel()) * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t, nn, d = nbr_parts.shape
    print(f"(e) jet_gain at T={t} N={nn} D={d} k={k}: {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    if err != 0:
        raise AssertionError(f"(e) jet_gain differs from plain by {err}")
    phase_profile("(f)", g, cfg, res.times["total_s"])
    entry = {
        "name": "jet_gain", "route": "cuda",
        "source": "src/repro_torch/kernels/jet_gain/jet_gain.cu",
        "replaces": "src/repro/kernels/jet_gain/jet_gain.py:29",
        "launches": launches["jet_gain"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "check": "exact against plain (phases b, c, d, e)",
        "shape": {"T": t, "N": nn, "D": d, "k": k},
    }
    return g, cfg, res, entry


def phase_profile(tag: str, g, cfg, wall_s: float) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.partition import partition

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        partition(g, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"{tag} the profiler saw no device time: busy share not "
              "measured")
        return
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"{tag} device busy {busy_s:.3f} s of the {wall_s:.3f} s "
          f"partition(): idle share {1 - busy_s / wall_s:.3f}; "
          f"{sum(e.count for e in kernels)} device operations")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"{tag}   {e.self_device_time_total / 1e3:9.1f} ms  "
              f"{e.count:6d}x  {e.key[:90]}")
    for what, words in (("sort", ("sort",)),
                        ("segment_reduce", ("tile_pass", "carry_pass"))):
        sel = [e for e in kernels if any(w in e.key.lower() for w in words)]
        ms = sum(e.self_device_time_total for e in sel) / 1e3
        print(f"{tag} {what} kernels: {ms:.1f} ms in "
              f"{sum(e.count for e in sel)} calls, "
              f"{ms / 1e3 / busy_s:.3f} of device busy time")


def _count_queries():
    """Wrap the ConnState query functions with call counters; returns the
    counts and a function that restores the originals."""
    from repro_torch.core import connectivity as cn

    calls = {"state_queries": 0, "rw_queries": 0, "rs_queries": 0}
    saved = {name: getattr(cn, name) for name in calls}

    def counted(name):
        def fn(*args, **kw):
            calls[name] += 1
            return saved[name](*args, **kw)
        return fn

    def restore():
        for name, fn in saved.items():
            setattr(cn, name, fn)

    for name in calls:
        setattr(cn, name, counted(name))
    return calls, restore


def phase_sorted_full_width(tp, dev, g, cfg_ell, res_ell):
    import dataclasses

    import torch

    from repro_torch.core import connectivity as cn
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref

    cfg = dataclasses.replace(cfg_ell, backend="sorted")
    calls, restore = _count_queries()
    try:
        res, launches, peak = _run(g, cfg)
    finally:
        restore()
    if tp.summary(res) != tp.summary(res_ell) or \
            not torch.equal(res.trial_parts, res_ell.trial_parts):
        raise AssertionError(f"(g) sorted {tp.summary(res)} != ell "
                             f"{tp.summary(res_ell)}")
    iters = [max(st["iterations"]) for st in res.level_stats]
    # one Jetlp query per loop iteration: 2 sums (run weights by run id,
    # conn_self by run vertex); a Jetrw query re-derives the runs: 1 sum; a
    # Jetrs query: the runs, then the sum and the count by run vertex: 3
    want = 2 * calls["state_queries"] + calls["rw_queries"] \
        + 3 * calls["rs_queries"]
    n_launch = launches.get("segment_reduce", 0)
    if calls["state_queries"] != sum(iters) or n_launch != want or \
            n_launch == 0:
        raise AssertionError(
            f"(g) segment_reduce launches {n_launch} != 2 x "
            f"{calls['state_queries']}"
            f" Jetlp + {calls['rw_queries']} Jetrw + 3 x "
            f"{calls['rs_queries']} Jetrs queries = {want} (iterations "
            f"{sum(iters)})")
    print(f"(g) sorted == ell bit for bit: cut {res.cut}, trial cuts "
          f"{res.trial_cuts}, {res.levels} levels")
    print(f"(g) segment_reduce launches {n_launch} = 2 x "
          f"{calls['state_queries']} "
          f"iterations + {calls['rw_queries']} Jetrw + 3 x "
          f"{calls['rs_queries']} Jetrs queries")
    print("(g) phase times: " + json.dumps(
        {kk: round(v, 3) for kk, v in res.times.items()}))
    print(f"(g) max_memory_allocated {peak} bytes; launches {launches}")

    def trial_ids(seg, num_segments):
        """Per-trial ids flattened and offset, as ``cn._segment_sum`` does."""
        off = torch.arange(seg.shape[0], device=dev)[:, None] * num_segments
        return (seg.long() + off).int().reshape(-1)

    def check_and_time(what, data, ids, s):
        err = int((ops.segment_sum_sorted(data, ids, s)
                   - segment_sum_sorted_ref(data, ids, s)).abs().max())
        if err != 0:
            raise AssertionError(f"(g) segment_reduce differs from plain by "
                                 f"{err} at the {what}")
        return _time_ms(lambda: ops.segment_sum_sorted(data, ids, s), 50), err

    # the run-weight sum at the finest level's shapes, as the path gives it
    gd, k, tparts = g.to(dev), cfg.k, res.trial_parts
    dst_part = torch.where(gd.edge_mask(), tparts[:, gd.adjncy], k)
    _, sw, run_id = cn.sorted_edge_keys(gd, dst_part, k)
    t, m_max = sw.shape
    s = t * m_max
    ids, data = trial_ids(run_id, m_max), sw.reshape(-1, 1)
    ms, err = check_and_time("run-weight sum", data, ids, s)
    plain_ms = _time_ms(lambda: segment_sum_sorted_ref(data, ids, s), 5)
    idx = ids.long()

    def library():
        out = torch.zeros(s, 1, dtype=torch.int32, device=dev)
        return out.index_add_(0, idx, data)

    library_ms = _time_ms(library, 20)
    nbytes = (ids.numel() + data.numel() + s) * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"(g) segment_reduce at the run-weight sum (M={ids.numel()}, F=1, "
          f"S={s}, up to {int(run_id[:, -1].max()) + 1} runs per trial): "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, zeros + index_add_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    # the conn_self sum by run vertex: runs past a trial's last real run
    # all hold the ghost vertex n_max, one long run across many tiles
    run_vertex, run_part, run_conn, valid = cn.runs_from_dst_part(
        gd, dst_part, k)
    own = valid & (run_part == tparts.gather(
        1, run_vertex.clamp(0, gd.n_max - 1).long()))
    s2 = t * (gd.n_max + 1)
    ids2 = trial_ids(run_vertex, gd.n_max + 1)
    data2 = torch.where(own, run_conn, 0).reshape(-1, 1)
    ms2, err2 = check_and_time("conn_self sum", data2, ids2, s2)
    bytes2 = (ids2.numel() + data2.numel() + s2) * 4
    print(f"(g) segment_reduce at the conn_self sum (M={ids2.numel()}, "
          f"S={s2}, a ghost run of {int((~valid).sum()) // t} rows per "
          f"trial): {ms2:.4f} ms, bound "
          f"{bytes2 / HBM_BYTES_PER_S * 1e3:.4f} ms ({bytes2} bytes)")
    phase_profile("(g)", g, cfg, res.times["total_s"])
    return {
        "name": "segment_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/segment_reduce/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce/segment_reduce.py:28",
        "launches": n_launch, "max_abs_err": max(err, err2),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": library_ms,
        "check": "int32 exact, float32 within tolerance, against plain "
                 "(phases b2, c, d, g)",
        "shape": {"M": ids.numel(), "F": 1, "S": s},
    }


def phase_powerlaw(tp):
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.data import graphs as gen

    t0 = time.perf_counter()
    g = gen.rmat(20, edge_factor=8)
    d_max = int(g.degrees().max())
    n, m = int(g.n), int(g.m)
    print(f"(h) rmat scale 20, edge factor 8: n={n}, directed edges={m}, "
          f"max degree {d_max} (built in {time.perf_counter() - t0:.1f} s)")
    out = {}
    for backend in ("sorted", "dense"):
        cfg = PartitionConfig(k=64, trials=4, backend=backend)
        res, launches, peak = _run(g, cfg)
        out[backend] = res
        print(f"(h) {backend}: cut {res.cut}, balanced {res.balanced}, "
              f"{res.levels} levels, total {res.times['total_s']:.3f} s "
              f"(uncoarsen {res.times['uncoarsen_s']:.3f} s), "
              f"max_memory_allocated {peak} bytes, launches {launches}")
    if tp.summary(out["sorted"]) != tp.summary(out["dense"]):
        raise AssertionError(f"(h) sorted {tp.summary(out['sorted'])} != "
                             f"dense {tp.summary(out['dense'])}")
    t, n_max = 4, g.n_max
    ell_bytes = t * n_max * d_max * 4 + n_max * d_max * 8
    print(f"(h) sorted == dense; ell would pad every row to D_max={d_max}: "
          f"{ell_bytes} bytes of state at the finest level (neighbor parts "
          f"for T={t} plus ids and weights), against "
          f"{t * m * 4 + m * 12} for the sorted backend's edge parts and "
          "the graph's edge arrays")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import torch_parity as tp

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"(a) {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def timed(tag, phase, *args):
        t1 = time.perf_counter()
        result = phase(*args)
        print(f"({tag}) took {time.perf_counter() - t1:.1f} s")
        return result

    t0 = time.perf_counter()
    timed("a", phase_build)
    timed("b", phase_kernel_vs_plain, tp, dev)
    timed("b2", phase_segment_vs_plain, tp, dev)
    timed("b3", phase_slot, tp, dev)
    timed("c", phase_golden, tp, dev)
    timed("d", phase_card_vs_cpu, tp)
    g, cfg, res_ell, jet_gain = timed("e, f", phase_full_width, dev)
    segment_reduce = timed("g", phase_sorted_full_width, tp, dev, g, cfg,
                           res_ell)
    timed("h", phase_powerlaw, tp)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [jet_gain, segment_reduce]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
