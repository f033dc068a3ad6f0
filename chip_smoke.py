#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout's
``src/``; it imports no JAX.  Phases, each of which must pass:

  (a) card and build: the card's name and power limit; build every kernel.
  (b) kernel against plain: jet_gain against its plain PyTorch version on
      random panels (D in {4, 6, 37, 300}, k in {2, 64, 1000}, T in {1, 4},
      with ties, ghost rows and rows with no other part): exact.
  (c) card against golden: partition() on the card, dense and ell, against
      the committed JAX reference results of the small parity graphs: exact.
  (d) card against CPU: grid2d 256x256, k=16, T=2, ell, on the card and on
      the CPU: parts and all stats exactly equal.
  (e) full width: grid3d 100^3 (10^6 vertices), k=64, T=4, ell, defaults
      otherwise: balanced, the cut equals one recomputed from the parts,
      jet_gain launched once per refinement iteration; then jet_gain and its
      plain version timed with CUDA events at the finest level's shapes.
  (f) where the time goes: the same partition() once more under
      torch.profiler — device busy time against phase (e)'s wall time, and
      the kernels that take the most device time.

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
    _build.build(["jet_gain"])
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


def phase_golden(tp, dev):
    golden = tp.load_golden()
    t0 = time.perf_counter()
    for graph in tp.GRAPHS:
        for name in tp.case_names(graph):
            got = tp.summary(tp.torch_result(name, "cuda"))
            if got != golden[name]:
                raise AssertionError(f"(c) {name}: card {got} != golden "
                                     f"{golden[name]}")
    print(f"(c) {len(golden)} small cases equal the JAX golden results "
          f"({time.perf_counter() - t0:.1f} s)")


def phase_card_vs_cpu(tp):
    from repro_torch.core.partition import PartitionConfig, partition
    from repro_torch.data import graphs as gen

    g = gen.grid2d(256, 256)
    cfg = PartitionConfig(k=16, trials=2, backend="ell")
    t0 = time.perf_counter()
    card = partition(g, cfg)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = partition(g, cfg, device="cpu")
    t_cpu = time.perf_counter() - t0
    if tp.summary(card) != tp.summary(cpu) or card.imbalance != cpu.imbalance:
        raise AssertionError(f"(d) card {tp.summary(card)} != cpu "
                             f"{tp.summary(cpu)}")
    print(f"(d) grid2d 256x256 k=16 T=2 ell: card == cpu, cut {card.cut}, "
          f"{card.levels} levels (card {t_card:.1f} s, cpu {t_cpu:.1f} s)")


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


def phase_full_width(dev):
    import torch

    from repro_torch import kernels
    from repro_torch.core.partition import PartitionConfig, partition
    from repro_torch.data import graphs as gen
    from repro_torch.kernels.jet_gain import ops
    from repro_torch.kernels.jet_gain.ref import jet_gain_ref

    t0 = time.perf_counter()
    g = gen.grid3d(100, 100, 100)
    print(f"(e) grid3d 100^3: n={int(g.n)}, directed edges={int(g.m)} "
          f"(built in {time.perf_counter() - t0:.1f} s)")
    cfg = PartitionConfig(k=64, trials=4, backend="ell")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = partition(g, cfg)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()

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
    phase_profile(g, cfg, res.times["total_s"])
    return {
        "name": "jet_gain", "route": "cuda",
        "source": "src/repro_torch/kernels/jet_gain/jet_gain.cu",
        "replaces": "src/repro/kernels/jet_gain/jet_gain.py:29",
        "launches": launches["jet_gain"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "check": "exact against plain (phases b, c, d, e)",
        "shape": {"T": t, "N": nn, "D": d, "k": k},
    }


def phase_profile(g, cfg, wall_s: float) -> None:
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
        print("(f) the profiler saw no device time: busy share not measured")
        return
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"(f) device busy {busy_s:.3f} s of the {wall_s:.3f} s partition() "
          f"in (e): idle share {1 - busy_s / wall_s:.3f}; "
          f"{sum(e.count for e in kernels)} device operations")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"(f)   {e.self_device_time_total / 1e3:9.1f} ms  "
              f"{e.count:6d}x  {e.key[:90]}")


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
    t0 = time.perf_counter()
    phase_build()
    phase_kernel_vs_plain(tp, dev)
    phase_golden(tp, dev)
    phase_card_vs_cpu(tp)
    entry = phase_full_width(dev)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
