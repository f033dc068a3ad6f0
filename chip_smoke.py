#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout's
``src/``; it imports no JAX.  Phases, each of which must pass:

  (a) card and build: the card's name and power limit; build every kernel
      (one nvcc per source, all at once) and print ptxas's report of each,
      with the registers and spill bytes of every instantiation of
      flash_attention's forward and its tensor-core backward; where
      ``cuobjdump`` exists, the count of tensor-core (HMMA) instructions in
      each of their kernels, which must be nonzero for the bfloat16 and
      float16 ones (flash_kernel_tc, dkdv_tc, dq_tc).
  (b) jet_gain against plain: its plain PyTorch version on random panels
      (D in {1, 4, 6, 8, 31, 32, 33, 37, 300}: the lane-group path up to 32
      and the histogram path above; k in {2, 64, 1000}, T in {1, 4}, with
      ties, ghost rows, rows with no other part, part ids outside [0, k] and
      rows whose parts all tie at connectivity 0); a fleet's panels (B, T,
      N, D) with per-lane weights (B, N, D), B up to 17; strided views:
      exact, one launch a call.
  (b2) segment_reduce against plain: M in {1, 255, 256, 257, 10^5,
      2.4*10^7} at F = 1 and up to 10^5 at F in {3, 128}; all rows in one
      segment, every row its own, runs spanning many tiles, mostly empty
      segments, ids >= S, and a ghost run (id S-1) over most rows.  int32
      exact; float32 within 1e-5 + 1e-5 * (the sum of |x| over the
      segment) and bitwise equal across two launches; bfloat16 and float16
      (float32 sums, rounded once) within that plus one rounding step of
      the output; strided views.
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
      torch.profiler (device activity only) — device busy time against
      phase (e)'s wall time, the
      kernels that take the most device time, and jet_gain's device time
      over the whole partition().
  (g) full width, sorted: the configuration of (e) with backend="sorted":
      parts, trial parts, cut and level stats equal (e)'s bit for bit, and
      segment_reduce launched as often as the loop's queries need; the
      kernel, its plain version and index_add_ timed at the finest level's
      shapes (a profiled partition() is cut for the script's time
      limit); the kernel timed at every shape
      the timed partition() gave it (inputs
      kept on the host during that run; the sum of launches x time); and a
      record at F = 128, M = 2^20 (runs of about 8 rows) against plain and
      index_add_.
  (h) power-law graph: rmat scale 19, edge factor 8, k=64, T=4, sorted
      against dense: equal parts; the time and peak memory of each, and
      the padded degree and state bytes that ell would need there.
  (i) fm_interaction against plain: B in {1, 255, 256, 257, 512, 262144},
      F in {1, 8, 39}, D in {1, 10, 16, 128}, float32, bfloat16 and
      float16: within 1e-5 + 1e-5 * (the row's sum of e^2) and bitwise equal
      across two launches; a strided view.
  (j) FM serving at full width (39 fields, D=10, 262,144 rows per field):
      serve_p99 (B=512) and serve_bulk (B=262,144) through the port's serve
      cells, kernel path against plain path, one launch per call;
      retrieval_cand (10^6 candidates) against float64; the kernel, its
      plain version and each serve step timed with CUDA events; examples/s
      and peak memory; the two serve steps under torch.profiler (device
      busy time, idle share, the kernel's device time).
  (k) flash_attention against plain: groups 1 and 4, D = Dv in {8, 36, 64,
      128, 256} and values of their own width, (D, Dv) in {(24, 16), (192,
      128), (36, 8)}; causal and not, windows 0/16/512, query offsets, Sq !=
      Skv, ragged tiles, rows that see no key (exactly 0), float32 (the
      CUDA-core kernel), bfloat16 and float16 (the tensor-core kernel):
      within 2e-5 + 2e-5 * |plain| (float32) or 1e-5 + 1e-2 * |plain|
      (bfloat16, float16) and bitwise equal across two launches; strided
      (transposed) views.
  (l) Gemma-3 1B serving at full width (bfloat16, seeded weights): prefill
      4 prompts of 4096 tokens, then 32 greedy decode steps, through
      ``repro_torch.launch.serve.generate``: 26 flash_attention launches per
      prefill; prefill logits of the kernel path within relative L2
      max(1e-2, 2 x that of the same prefill with PyTorch's fused attention,
      the spread of bf16 through 26 layers) of the plain path's; greedy
      tokens equal wherever the plain run's top-2
      margin exceeds twice the logit difference; times, tokens/s and peak
      memory.  Then the kernel, its plain version and
      ``F.scaled_dot_product_attention`` timed at a global and a local
      layer's shapes (with the kernel/SDPA time ratio), and the smoke
      config's logits on the card against the CPU within 2e-4.
  (m) the fleet at full width: 12 graphs (4 grid2d of sides 241..253, 4
      small_world of 60000 + 365 i vertices, 2 grid3d of sides 33, 37, 2
      random_geometric of 32768 + 1024 i vertices, i a multiple of 4), k=64,
      T=4, ell, through
      ``partition_fleet`` and through a loop of standalone ``partition()``
      calls: every member equal bit for bit, balanced, cuts recomputed on
      the host; jet_gain launched once per batched loop iteration, fewer
      times than the loop's; buckets, graphs/s of both, peak memory, host
      reads, and jet_gain at the largest bucket's finest shapes.  (No
      profile: the fleet's ~10^6 device operations take the profiler far
      longer than the script's time allows.)
  (n) the fleet against the reference: tests/test_fleet.py's fleet plus its
      over-padded member, dense, sorted and ell, k in {2, 8, 33}, T in {1,
      2}: the card's fleet equals the CPU's and the JAX reference's
      standalone runs (the golden file).
  (o) partition-as-a-service at (m)'s sizes: ``PartitionServer`` (ell, k
      in {16, 64}, T=4, lanes 4, a 50 ms window, the ladder fitted to the
      largest family) over six families (grid 256x256 at weight 2 and
      250x250, small_world 245^2 and 250^2, grid3d 40^3, random_geometric
      200^2); the bucket map, with one bucket holding two true sizes; the
      warmup grid (every lane composition of each rung's families), a
      burst of 32 requests at 2000 req/s (throughput, occupancy), a Poisson
      replay of 6 at half that throughput (p50/p95 latency, new allocator
      segments); no new signature after warmup, jet_gain launched once per
      batched loop iteration, every response equal bit for bit to its
      standalone partition() on the card; peak memory, filler lanes.
  (p) the reference serve test's burst (tests/test_serve.py) served on the
      card on dense, sorted and ell: responses and dispatch logs equal the
      JAX reference's (golden); then two processes on one fresh kernel
      library directory: the first builds the serve path's kernels, the
      second builds nothing.
  (q) DeepSeek-V2-Lite 16B serving at full width (27 layers, MLA with
      r = 512 and q, k 192 / v 128 wide, 64 routed experts top-6 + 2 shared,
      bfloat16; 16,000,595,968 seeded parameters, every routed expert drawn
      on its own): prefill 4 prompts of 4096 tokens, then 32 greedy decode
      steps, through ``repro_torch.launch.serve.generate``: 27
      flash_attention launches per prefill (Dv != D), none on the plain
      path; prefill logits within relative L2 max(1e-2, 2 x the SDPA
      path's) of the plain path's; greedy tokens as in (l); times,
      tokens/s, peak memory and the MLA cache's bytes; the share of (token,
      layer) top-6 expert sets that differ between the two paths' prefills
      (printed, not gated); profiles of the prefill and of 8 decode steps;
      the kernel, its plain version and SDPA timed at the MLA layer's
      shapes; the smoke config on the card against the CPU within 2e-4.
  (r) MeshGraphNet training on a Jet-partitioned mesh, the GNN training
      path at full width: ``mesh_batch(512, 512)`` (262,144 nodes,
      1,568,770 directed edges) and the published config (15 blocks,
      d_hidden 128, 2-layer MLPs, float32).  partition() on the card (k=8,
      lam=0.05, ell: jet_gain runs), the Jet and naive device plans (local
      edges, halo, bytes per layer), the batch reordered into the Jet
      plan's device blocks (its loss equals the input order's within
      1e-5); step 1 on the kernel and plain paths (loss within 1e-5
      relative, gradients within relative L2 1e-4) and twice on the kernel
      path (bit for bit); segment_reduce launched 4 x 15 times a step
      (``gnn_segment_sums``); 5 AdamW steps through ``train/loop.run`` on
      the kernel path and 2 on the plain path (losses within 1e-5); step
      time, peak memory (20-30 GB: every block's saved input and one
      recomputed block); the step under
      torch.profiler (idle share, top operations, no index_add, scatter_add
      or index_put operation or kernel); the kernel, its plain version and
      index_add_ at the step's shape (M = 1,568,770, F = 128).
  (s) the other GNNs at their published configs, 3 AdamW steps each on the
      kernel and plain paths (losses within 1e-5), launches as counted,
      step 1 bit for bit across two runs: graphsage-reddit on minibatch_lg
      (1024 seeds sampled with fanouts (15, 10) from a planted-partition
      graph of Reddit's 232,965 nodes at degree 50, 602 random features,
      196,608 pad nodes, 262,144 pad edges), schnet and nequip on 128
      molecules of 30 atoms, 64 edges each; NequIP's energies under a
      rotation and a translation (rtol = atol = 1e-4); a SchNet run killed
      at step 2 and resumed equals a whole run bit for bit;
      ``launch/train.main --arch meshgraphnet`` on the card; each smoke
      config's loss and gradients on the card within 2e-4 of the CPU's.
  (t) the backward kernels against their plain versions: fm_interaction's
      (D in {1, 8, 10, MAX_DIM}, F in {0, 1, 39}, B up to 65,536, float32
      within 1e-6 relative L2, bfloat16 and float16 within one rounding
      step of the output, a strided view) and flash_attention's (the
      shapes of (k) at (D, Dv) in {16/16, 36/8, 64/64, 128/128, 192/128,
      256/256}: float32 within 1e-4 relative L2 of plain for dq, dk, dv,
      16-bit within 2e-2; dq = 0 for rows that see no key; float32 on the
      CUDA-core kernels, bfloat16 and float16 on the tensor cores' route);
      bitwise equal across two launches; unaligned fm views; the forward
      with its log-sum-exp bitwise equal to the forward without; the
      backward, its plain version and SDPA's backward timed at Gemma-3 1B's
      training layers (8, 4, 4096, 256), windows 0 and 512, and at the MLA
      layer.
  (u) FM training at its published config (39 fields, D = 10, 262,144
      rows per field), train_batch B = 65,536: step 1 on the kernel and
      plain paths (loss within 1e-6 relative, gradients within 1e-5
      relative L2) and twice on the kernel path (bit for bit);
      fm_interaction 1 + 1 and segment_reduce 2 launches a step; 5 AdamW
      steps through ``train/loop.run``; step time, examples/s, peak
      memory; the step under torch.profiler (idle share, no index_add,
      scatter_add or index_put); the backward kernel timed at the step's
      shape.
  (v) Gemma-3 1B training at full width and depth (26 layers, bfloat16,
      remat; 999,812,736 parameters) on train_4k's sequence of 4096 with
      the batch cut from 256 to 8: step 1 on the kernel, plain and SDPA
      paths (loss within 1e-3 relative of plain, gradients within
      max(2e-2, 2 x the SDPA path's) relative L2) and twice on the kernel
      path (bit for bit); flash_attention 2 x 26, its backward 26 and
      segment_reduce 1 launches a step; 3 AdamW steps through
      ``train/loop.run``, the checkpoint's bfloat16 parameters restored bit
      for bit; step time, tokens/s, TFLOP/s of model flops, peak memory
      (gated on PERF.md's 20-45 GB); the step under torch.profiler (idle
      share, top operations, the flash backward's share of the step, no
      index_add, index_put or embedding backward).
  (w) the smoke configs of gemma3-1b, deepseek-v2-lite-16b (MLA + MoE),
      moonshot-v1-16b-a3b (GQA + MoE) and fm: loss and gradients on the
      card within 2e-4 of the CPU's; two MoE train steps bit for bit equal
      on the card, with segment_reduce launched ``lm_segment_sums`` times a
      step (the dispatch's sums); ``launch/train.main --arch gemma3-1b``
      and ``--arch fm`` on the card.
  (x) partition-aware MeshGraphNet training (``launch/gnn_partitioned.py``)
      at full width on (r)'s mesh and config: partition() on the card (k=8,
      lam=0.05, ell: jet_gain runs).  (x1) world size 1 on NCCL, the cell
      from ``steps.build_cell(..., tuning={"mode": "partitioned"})`` on the
      layout of one rank: loss within 1e-4 relative and step-1 gradients
      within ``GNN_GRAD_RL2`` of the dense path's, two runs of step 1 bit
      for bit, segment_reduce ``partitioned_segment_sums`` times a step,
      no scatter-add in the profiled step; step time, peak memory.  (x2) 8
      ranks as 8 processes on the one card over gloo (CUDA tensors), the
      layout sized from the partition (no dropped edge or halo slot): the
      loss and grad_norm within 1e-4 relative of (x1)'s, whether step 1
      repeats bit for bit (recorded), the collective bytes a layer (the
      exchange's D x h_cap x F x 4, the real halo rows, the naive 2 N F);
      the spawn and the joins time out at 240 s.
  (y) the cost-counting dry run (``launch/dryrun.py``, ``launch/op_cost.py``)
      against the card: for Gemma-3 1B train_4k at (v)'s batch of 8,
      MeshGraphNet at (r)'s mesh size (262,144 nodes, 1,568,770 edges,
      padded to 512) and FM train_batch, the ``card`` record built on the
      host under fake tensors, then the cell on the card: one step timed
      with the peak memory reset, one step under op_cost, whose flops,
      bytes and transcendentals must equal the record's and whose kernels
      must launch as often as the record counts their calls (above 0); the
      peak against the record's prediction within ``PEAK_RATIO``; counted
      over model flops, TFLOP/s and the one-card bound printed.  Then the
      host time a segment_reduce and a jet_gain call spends in the custom
      op's dispatch, against the launch alone.  (The dry run over every
      cell of the production meshes needs no card: ``python -m
      repro_torch.launch.dryrun --mesh both``.)
  (z) the LM cells as sharded programs on a ``DeviceMesh``
      (``launch/steps.sharded_step``).  (z1) Gemma-3 1B at full width and
      depth on a one-rank NCCL mesh (1, 1): two train_4k steps at (v)'s
      batch of 8, then a prefill of 4 x 4096 tokens and 8 greedy decode
      steps: losses, parameters, logits and the cache bit for bit the
      unsharded cell's; flash_attention, its backward and segment_reduce
      launched as (v) counts them; step time and peak memory beside (v)'s.
      (z2) 4 ranks as 4 processes on the one card over ``gloo_host``
      (``dist/host_group.py``: every collective staged through host
      memory) on a (2, 2) ("data", "model") mesh: first the record of
      plain gloo on CUDA tensors (``lm_sharded.probe``, each collective in
      processes of its own, until the first refusal) and gloo_host's
      probes (all four must carry); then for Gemma-3 1B at full width and
      depth 6 (batch 4 x 1024), DeepSeek-V2-Lite's smoke config (experts
      over "model"), FM train_batch at full width (B = 65,536) and
      MeshGraphNet 15 x 128 on mesh_batch(256, 256): one train step's
      loss within 1e-3 relative and each gradient leaf within 2e-2
      (bfloat16) or 1e-4 (float32) relative L2 of the one-device step
      (``SHARDED_GATES``); each rank's peak within ``PEAK_RATIO`` of the
      dry run's prediction on a fake (2, 2) world and its collectives by
      kind equal to that count; each of the job's kernels launched on
      every rank; the probes and the four steps run in one world of
      ranks, which times out at 600 s.  (z3) a
      zero-head flash_attention call on the card
      returns an empty output with no launch.
  (z4) the FM and GNN cells as sharded programs on a one-rank NCCL mesh:
      FM at its published width (39 fields, D 10, 262,144 rows a field)
      for two train_batch steps (B = 65,536), serve_bulk (B = 262,144) and
      retrieval_cand (10^6 candidates), and two MeshGraphNet steps at
      (r)'s width and size (15 blocks, d 128, mesh_batch(512, 512) in
      input order): losses, parameters, optimizer state and scores bit
      for bit the unsharded cells'; fm_interaction, its backward and
      segment_reduce launched as often as the unsharded run (counts reset
      before each run); step times against the unsharded ones and peak
      memory beside the card's name and power limit.
  The script ends by checking that no jax or repro (JAX package) module was
  imported.  ``--phases`` runs a subset, for debugging; such a run prints no
  result line.

Prints ``{"kernels": [...]}`` and the card's name and power limit on lines
before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, with no result line, when any phase fails or there is no card.
"""
from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)


def gnn_segment_sums(arch_id: str, cfg) -> int:
    """segment_reduce calls in one train step of a GNN, counted from the
    code (``repro_torch/models/gnn``): every scatter_sum forward, again in
    each block's checkpoint recompute, and one per gather_nodes backward
    (none where the gathered input needs no gradient: a GraphSAGE layer 0's
    input features, NequIP's zero V and T in layer 0); the species lookups'
    backward and the per-graph energy sum add one each."""
    if arch_id == "meshgraphnet":  # 1 scatter x 2 + hs, hr backward
        return 4 * cfg.n_layers
    if arch_id == "graphsage-reddit":  # no checkpoint in the reference
        return 2 * cfg.n_layers - 1
    if arch_id == "schnet":  # 1 scatter x 2 + 1 gather backward
        return 3 * cfg.n_interactions + 2
    if arch_id == "nequip":  # 3 scatters x 2 + s_j, V_j, T_j backward
        return 9 * cfg.n_layers - 2 + 2
    raise ValueError(arch_id)


def partitioned_segment_sums(cfg) -> int:
    """segment_reduce calls in one rank's partitioned MeshGraphNet train
    step (``launch/gnn_partitioned.py``): in each block the local sum and
    its checkpoint recompute, and the backward of the three gathers that
    need a gradient (senders from the exchanged rows, receivers, the
    exported boundary rows); the position gathers need none."""
    return 5 * cfg.n_layers


def lm_flash_launches(cfg) -> tuple[int, int]:
    """flash_attention forward and backward launches in one LM train step,
    counted from the code (``repro_torch/models/transformer.py``): one
    forward a layer, again in each layer's checkpoint recompute when
    ``cfg.remat`` is on, and one backward a layer."""
    return cfg.n_layers * (2 if cfg.remat else 1), cfg.n_layers


# segment_reduce calls in one LM or FM train step, counted from the code
# (``models/gather.py``): one for each embedding table's gradient, the LM's
# ``embed`` and FM's ``table`` and ``linear``
EMBED_SEGMENT_SUMS = {"lm": 1, "recsys": 2}


def lm_segment_sums(cfg) -> int:
    """segment_reduce calls in one LM train step (``models/gather.py``):
    the embedding's gradient, and in each MoE layer the combine's sum (run
    again in the layer's recompute when ``cfg.remat`` is on) and the
    dispatch gather's gradient."""
    moe = cfg.n_layers * ((2 if cfg.remat else 1) + 1) if cfg.moe else 0
    return EMBED_SEGMENT_SUMS["lm"] + moe


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _cuda_tool(name: str) -> str | None:
    """A tool of the CUDA toolkit, on PATH or under /usr/local/cuda."""
    import shutil

    path = Path("/usr/local/cuda/bin") / name
    return shutil.which(name) or (str(path) if path.exists() else None)


def _demangle(names: list[str]) -> list[str]:
    """C++ names through cu++filt where it exists."""
    tool = _cuda_tool("cu++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def _short(name: str) -> str:
    """A demangled kernel name without its parameter list and casts:
    ``flash_kernel_tc<__nv_bfloat16, 256, 32>``."""
    name = name.replace("(int)", "").replace("<unnamed>::", "")
    return name.split("(")[0].removeprefix("void ")


def _ptxas_functions(log: str) -> dict[str, dict]:
    """Per entry function of a ``-Xptxas -v`` log: registers and spill
    bytes."""
    import re

    funcs, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return funcs


def _hmma_counts(lib: Path) -> dict[str, int] | None:
    """Tensor-core (HMMA) instructions per kernel of a built library, from
    ``cuobjdump -sass``; None where there is no cuobjdump."""
    tool = _cuda_tool("cuobjdump")
    if not tool:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :", 1)[1].strip()
            counts[cur] = 0
        elif cur is not None and "HMMA" in ln:
            counts[cur] += 1
    return counts


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    build_s = time.perf_counter() - t0
    for name, log in _build.build_logs.items():
        ptxas = [ln for ln in log.splitlines() if "ptxas info" in ln]
        print(f"(a) {name} ptxas: " + " | ".join(ptxas))
    print(f"(a) kernels built in {build_s:.1f} s")
    # flash_attention's forward and its tensor-core backward: registers and
    # spills of each instantiation, and its tensor-core instructions
    for lib, tc_names in (("flash_attention", ("flash_kernel_tc",)),
                          ("flash_attention_bwd_tc", ("dkdv_tc", "dq_tc"))):
        funcs = _ptxas_functions(_build.build_logs.get(lib, ""))
        for name, pretty in zip(funcs, _demangle(list(funcs))):
            f = funcs[name]
            print(f"(a) {lib} {_short(pretty)}: {f.get('registers')} "
                  f"registers, {f.get('spill_stores')} bytes spill stores, "
                  f"{f.get('spill_loads')} bytes spill loads")
        hmma = _hmma_counts(_build._library(lib))
        if hmma is None:
            print(f"(a) {lib} HMMA count: no cuobjdump, not measured")
            continue
        for name, pretty in zip(hmma, _demangle(list(hmma))):
            print(f"(a) {lib} {_short(pretty)}: {hmma[name]} HMMA "
                  "instructions")
            if any(t in name for t in tc_names) and hmma[name] == 0:
                raise AssertionError(f"(a) {pretty}: no tensor-core "
                                     "instruction")
        for t in tc_names:
            if not any(t in n for n in hmma):
                raise AssertionError(f"(a) no {t} in the {lib} library")


def phase_kernel_vs_plain(tp, dev):
    import torch

    from repro_torch.kernels.jet_gain import ops
    from repro_torch.kernels.jet_gain.ref import jet_gain_ref

    n_cases = 0
    for t in (None, 4):
        for d in (1, 4, 6, 8, 31, 32, 33, 37, 300):
            for k in (2, 64, 1000):
                n = max(2000, 400000 // d)
                ins = [torch.from_numpy(a).to(dev)
                       for a in tp.panel(n, d, k, t, seed=d * k, odd=True)]
                want = jet_gain_ref(*ins, k)
                got = ops.jet_gain_from_parts(*ins, k)
                torch.cuda.synchronize()
                for g_, w in zip(got, want):
                    if not torch.equal(g_, w):
                        raise AssertionError(
                            f"(b) jet_gain differs from plain at T={t} D={d} "
                            f"k={k}")
                n_cases += 1
    # a fleet bucket's panels: (B, T, N, D) with per-lane weights (B, N, D)
    n_lanes = 0
    for b, t in ((3, 2), (2, 2), (17, 4)):
        for d in (1, 6, 12, 17, 33, 300):
            panels = [tp.panel(max(1000, 60000 // d), d, 64, t, seed=d + i,
                               odd=True) for i in range(b)]
            ins = [torch.from_numpy(np.stack(a)).to(dev)
                   for a in zip(*panels)]
            want = jet_gain_ref(*ins, 64)
            got = _one_launch("jet_gain", ops.jet_gain_from_parts, *ins, 64)
            if not all(torch.equal(g_, w) for g_, w in zip(got, want)):
                raise AssertionError(f"(b) jet_gain with lane weights differs "
                                     f"from plain at B={b} T={t} D={d}")
            n_lanes += 1
    # strided views: panels sliced out of wider ones, parts every other column
    nbr_parts, wgt, parts = (torch.from_numpy(a).to(dev)
                             for a in tp.panel(20000, 9, 64, 4, seed=9))
    views = (nbr_parts[..., :6], wgt[:, 3:9],
             torch.stack([parts, parts], -1)[..., 1])
    got = _one_launch("jet_gain", ops.jet_gain_from_parts, *views, 64)
    want = jet_gain_ref(*(v.contiguous() for v in views), 64)
    if any(v.is_contiguous() for v in views) or \
            not all(torch.equal(g_, w) for g_, w in zip(got, want)):
        raise AssertionError("(b) jet_gain on strided views differs from plain")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (500, 40)))
    for fn in (torch.argmax, torch.argmin):
        if not torch.equal(fn(x.to(dev), dim=1).cpu(), fn(x, dim=1)):
            raise AssertionError(f"(b) {fn.__name__} ties differ on the card")
    print(f"(b) jet_gain == plain on {n_cases} panels (D <= 32 lane groups, "
          f"D > 32 histogram), {n_lanes} fleet panels with per-lane weights "
          "(B up to 17) and strided views (one launch each); argmax/argmin "
          "ties agree")


def _one_launch(name, fn, *args):
    """fn(*args) on the card; fails unless it launched kernel ``name``
    exactly once."""
    import torch

    from repro_torch import kernels

    before = kernels.launch_counts[name]
    out = fn(*args)
    torch.cuda.synchronize()
    if kernels.launch_counts[name] != before + 1:
        raise AssertionError(f"{name}: {kernels.launch_counts[name] - before}"
                             " launches for one call")
    return out


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
    # bfloat16 and float16: float32 sums rounded once; strided views
    worst16, n16 = 0.0, 0
    for m, f in ((257, 1), (10**5, 1), (10**6, 1), (10**5, 3), (4099, 128)):
        for kind in tp.SEGMENT_KINDS:
            for dtype in (torch.bfloat16, torch.float16):
                data, seg, s = tp.segment_case(m, f, kind, dtype, seed=m + f,
                                               device=dev)
                got = _one_launch("segment_reduce", ops.segment_sum_sorted,
                                  data, seg, s)
                again = ops.segment_sum_sorted(data, seg, s)
                want = segment_sum_sorted_ref(data, seg, s)
                ratio = tp.segment_error_ratio(got, want, data, seg, s)
                if got.dtype != dtype or not torch.equal(got, again) or \
                        not ratio <= 1:
                    raise AssertionError(
                        f"(b2) segment_reduce M={m} F={f} {kind} {dtype}: "
                        f"{ratio:.3f} of its tolerance, or launches differ")
                worst16, n16 = max(worst16, ratio), n16 + 1
    data, seg, s = tp.segment_case(10**5, 6, "span", torch.float32, seed=6,
                                   device=dev)
    dv, sv = data[:, ::2], torch.stack([seg, seg], -1)[:, 0]
    got = _one_launch("segment_reduce", ops.segment_sum_sorted, dv, sv, s)
    ratio = tp.segment_error_ratio(
        got, segment_sum_sorted_ref(dv.contiguous(), sv.contiguous(), s),
        dv, sv, s)
    if dv.is_contiguous() or sv.is_contiguous() or not ratio <= 1:
        raise AssertionError(f"(b2) segment_reduce on strided views: "
                             f"{ratio:.3f} of its tolerance")
    print(f"(b2) segment_reduce == plain on {n_cases} panels (int32 exact; "
          f"float32 at most {worst:.3f} of its tolerance; bitwise equal "
          f"across launches); bfloat16/float16 on {n16} panels, at most "
          f"{worst16:.3f} of the tolerance plus one rounding step; strided "
          f"views {ratio:.3f}; in {time.perf_counter() - t0:.1f} s")


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
    from repro_torch.core.partition import PartitionConfig, partition
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
    nbytes = ops.jet_gain_cost(nbr_parts, wgt, tparts, k)["bytes"]
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t, nn, d = nbr_parts.shape
    print(f"(e) jet_gain at T={t} N={nn} D={d} k={k}: {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    if err != 0:
        raise AssertionError(f"(e) jet_gain differs from plain by {err}")
    groups = phase_profile("(f)", lambda: partition(g, cfg),
                           res.times["total_s"], cuda_only=True)
    print(f"(e) jet_gain device time per partition(): "
          f"{groups.get('jet_gain', 'not measured')} ms (the profile of (f))")
    _jet_gain_levels(g, cfg)
    entry = {
        "name": "jet_gain", "route": "cuda",
        "source": "src/repro_torch/kernels/jet_gain/jet_gain.cu",
        "replaces": "src/repro/kernels/jet_gain/jet_gain.py:29",
        "launches": launches["jet_gain"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "check": "exact against plain (phases b, c, d, e)",
        "shape": {"T": t, "N": nn, "D": d, "k": k},
        "device_ms_per_partition": groups.get("jet_gain"),
    }
    return g, cfg, res, entry


def _jet_gain_levels(g, cfg) -> None:
    """One partition() more, keeping the first jet_gain panel of each level:
    the kernel timed at each level's shapes, beside its launches there and
    its bound."""
    from collections import Counter

    from repro_torch.core.partition import partition
    from repro_torch.kernels.jet_gain import ops

    first, launches = {}, Counter()
    kernel = ops.jet_gain_from_parts

    def keep(nbr_parts, wgt, parts, k):
        key = tuple(nbr_parts.shape)
        launches[key] += 1
        if key not in first:
            first[key] = (nbr_parts.clone(), wgt.clone(), parts.clone(), k)
        return kernel(nbr_parts, wgt, parts, k)

    with swapped(ops, "jet_gain_from_parts", keep):
        partition(g, cfg)
    total = 0.0
    for key, ins in first.items():
        ms = _time_ms(lambda ins=ins: kernel(*ins), 20)
        total += launches[key] * ms
        nbytes = ops.jet_gain_cost(*ins)["bytes"]
        print(f"(e) jet_gain at T, N, D = {key}: {launches[key]} launches, "
              f"{ms:.4f} ms each, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} "
              f"ms")
    print(f"(e) jet_gain, the sum of launches x time over the levels: "
          f"{total:.2f} ms per partition()")


PARTITION_GROUPS = (("sort", ("sort",)),
                    ("segment_reduce", ("splits_pass", "tiles_pass",
                                        "carry_pass")),
                    ("jet_gain", ("jet_gain",)))
FM_GROUPS = (("fm_interaction", ("fm_kernel",)),)


def phase_profile(tag: str, run, wall_s: float, what: str = "partition()",
                  groups=PARTITION_GROUPS, keys: list | None = None,
                  cuda_only: bool = False) -> dict[str, float]:
    """``run()`` once more under torch.profiler: device busy time against
    ``wall_s``, the unprofiled run's wall time, the kernels that take the
    most device time, and the share of each group of kernel names.  Returns
    each group's device time in ms, and its launches under "<group> calls"
    (empty if the profiler saw none); ``keys``, if given, receives the name
    of every operation and kernel the profiler saw.  ``cuda_only`` records
    device activity alone (no host operator names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if cuda_only else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    if keys is not None:
        keys.extend(e.key for e in events)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"{tag} the profiler saw no device time: busy share not "
              "measured")
        return {}
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"{tag} device busy {busy_s:.4f} s of the {wall_s:.4f} s "
          f"{what}: idle share {1 - busy_s / wall_s:.3f}; "
          f"{sum(e.count for e in kernels)} device operations")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"{tag}   {e.self_device_time_total / 1e3:9.2f} ms  "
              f"{e.count:6d}x  {e.key[:90]}")
    out = {}
    for name, words in groups:
        sel = [e for e in kernels if any(w in e.key.lower() for w in words)]
        ms = out[name] = sum(e.self_device_time_total for e in sel) / 1e3
        out[f"{name} calls"] = sum(e.count for e in sel)
        print(f"{tag} {name} kernels: {ms:.2f} ms in "
              f"{sum(e.count for e in sel)} calls, "
              f"{ms / 1e3 / busy_s:.3f} of device busy time")
    return out


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
    first, by_shape = {}, {}
    try:
        with swapped(ops, "segment_sum_sorted",
                     _recording_shapes(ops.segment_sum_sorted, first,
                                       by_shape)):
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
    nbytes = ops.segment_reduce_cost(data, ids, s)["bytes"]
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
    bytes2 = ops.segment_reduce_cost(data2, ids2, s2)["bytes"]
    print(f"(g) segment_reduce at the conn_self sum (M={ids2.numel()}, "
          f"S={s2}, a ghost run of {int((~valid).sum()) // t} rows per "
          f"trial): {ms2:.4f} ms, bound "
          f"{bytes2 / HBM_BYTES_PER_S * 1e3:.4f} ms ({bytes2} bytes)")
    for what, args in (("run-weight", (data, ids, s)),
                       ("conn_self", (data2, ids2, s2))):
        _segment_kernels(what, lambda a=args: ops.segment_sum_sorted(*a))
    # a profiled partition() (~92 s with its report) is not run: the
    # script's time limit (its per-kernel device times are the lines above)
    print("(g) segment_reduce device time per partition(): not measured "
          "(the profiled run is cut for the script's time limit)")
    _segment_levels(first, by_shape)
    _segment_wide(dev)
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
        "conn_self_sum": {"ms": ms2, "bound_ms": bytes2 / HBM_BYTES_PER_S
                          * 1e3, "shape": {"M": ids2.numel(), "F": 1,
                                           "S": s2}},
        "device_ms_per_partition": None,
    }


def _segment_kernels(what: str, call, reps: int = 20) -> None:
    """Each kernel's device time in one segment_reduce call, from
    torch.profiler over ``reps`` calls (each launches each kernel once; the
    profiler may miss the first few, so the mean is over the launches it
    saw)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        m = re.search(r"(splits_pass|tiles_pass_wide|tiles_pass|carry_pass)",
                      e.key)
        if e.device_type == DeviceType.CUDA and m:
            times[m.group(1)] = e.self_device_time_total / e.count / 1e3
    print(f"(g) segment_reduce kernels at the {what} sum, device ms per "
          "call: " + (", ".join(f"{k} {v:.4f}" for k, v in times.items())
                      or "not measured"))


def _recording_shapes(kernel, first: dict, launches: dict):
    """``kernel`` that also keeps, per input shape (M, F, S), its launches
    and a host copy of its first inputs (a copy on the host, so the run's
    peak device memory stays its own)."""

    def keep(data, seg_ids, num_segments):
        key = (*data.shape, num_segments)
        launches[key] = launches.get(key, 0) + 1
        if key not in first:
            first[key] = (data.cpu(), seg_ids.cpu())
        return kernel(data, seg_ids, num_segments)

    return keep


def _segment_levels(first: dict, launches: dict) -> None:
    """The kernel timed at each shape (M, F, S) that (g)'s timed
    partition() gave it, on the inputs recorded there, beside its launches
    there and its bound."""
    import torch

    from repro_torch.kernels.segment_reduce import ops

    total = 0.0
    for key in sorted(first, key=lambda k_: -k_[0]):
        data, seg = (x.to("cuda") for x in first.pop(key))
        m, f, s = key
        ms = _time_ms(lambda: ops.segment_sum_sorted(data, seg, s), 20)
        total += launches[key] * ms
        nbytes = ops.segment_reduce_cost(data, seg, s)["bytes"]
        print(f"(g) segment_reduce at M, F, S = {key}: {launches[key]} "
              f"launches, {ms:.4f} ms each, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        del data, seg
    torch.cuda.empty_cache()
    print(f"(g) segment_reduce, the sum of launches x time over the shapes: "
          f"{total:.2f} ms per partition()")


def _segment_wide(dev) -> None:
    """A record at F = 128 (the shape of a GNN's scatter_sum): M = 2^20
    float32 rows in runs of about 8, against plain and index_add_."""
    import torch

    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref

    m, f = 2**20, 128
    s = m // 8
    gen = torch.Generator(device=dev).manual_seed(128)
    seg = torch.sort(torch.randint(0, s, (m,), device=dev, generator=gen)
                     ).values.int()
    data = torch.randn(m, f, device=dev, generator=gen)
    got, want = ops.segment_sum_sorted(data, seg, s), \
        segment_sum_sorted_ref(data, seg, s)
    bound = 1e-5 + 1e-5 * segment_sum_sorted_ref(data.abs(), seg, s)
    ratio = float(((got - want).abs() / bound).max())
    if not ratio <= 1:
        raise AssertionError(f"(g) segment_reduce at F={f}: {ratio:.3f} of "
                             "its tolerance")
    idx = seg.long()
    ms = _time_ms(lambda: ops.segment_sum_sorted(data, seg, s), 20)
    plain_ms = _time_ms(lambda: segment_sum_sorted_ref(data, seg, s), 5)
    library_ms = _time_ms(lambda: torch.zeros(s, f, device=dev).index_add_(
        0, idx, data), 20)
    nbytes = ops.segment_reduce_cost(data, seg, s)["bytes"]
    print(f"(g) segment_reduce at F={f} (M={m}, S={s}, float32, runs of about "
          f"8 rows): {ms:.4f} ms, plain {plain_ms:.4f} ms, zeros + "
          f"index_add_ {library_ms:.4f} ms, bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes); "
          f"{ratio:.4f} of the float32 tolerance")


def phase_powerlaw(tp):
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.data import graphs as gen

    t0 = time.perf_counter()
    g = gen.rmat(19, edge_factor=8)
    d_max = int(g.degrees().max())
    n, m = int(g.n), int(g.m)
    print(f"(h) rmat scale 19, edge factor 8: n={n}, directed edges={m}, "
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


# ---------------------------------------------------------------------------
# the fleet: shape-bucketed, batched V-cycles over many graphs
# ---------------------------------------------------------------------------

def phase_fleet_small(tp):
    """(n): the reference fleet test's graphs on every backend, k and T:
    the card's fleet equals the CPU's and the reference's standalone runs
    (golden)."""
    from repro_torch.core import graph as gr
    from repro_torch.core.partition import PartitionConfig, partition_fleet
    from repro_torch.data import graphs as gen

    golden = tp.load_golden_fleet()
    graphs = tp.fleet_graphs(gr, gen)
    t0 = time.perf_counter()
    launched = {}
    for name in tp.fleet_case_names():
        cfg = PartitionConfig(**tp.fleet_config_kwargs(name))
        card, launches = _counted(partition_fleet, graphs, cfg)
        cpu = partition_fleet(graphs, cfg, device="cpu")
        for i, (c, h) in enumerate(zip(card.results, cpu.results)):
            got = tp.member_summary(c)
            if got != tp.member_summary(h) or c.imbalance != h.imbalance \
                    or got != golden[name][i]:
                raise AssertionError(f"(n) {name} member {i}: card {got} != "
                                     f"cpu or golden {golden[name][i]}")
        if sorted(b.indices for b in card.buckets) != [[0, 1], [2, 3]]:
            raise AssertionError(f"(n) {name}: buckets "
                                 f"{[b.indices for b in card.buckets]}")
        for kernel in launches:
            launched[kernel] = launched.get(kernel, 0) + launches[kernel]
    if not launched.get("jet_gain") or not launched.get("segment_reduce"):
        raise AssertionError(f"(n) launches {launched}: ell and sorted must "
                             "run their kernels")
    print(f"(n) {len(tp.fleet_case_names())} fleets (grids 13x13, 12x12, 8x8 "
          f"and 8x8 padded to {tp.FLEET_OVERPAD}; dense, sorted, ell; k in "
          f"{tp.FLEET_KS}; T in {tp.FLEET_TRIALS}): card == cpu == the JAX "
          f"reference's standalone runs (golden); launches {launched} in "
          f"{time.perf_counter() - t0:.1f} s")


# every fourth graph of a 48-graph set (sizes in steps of 2), so that the
# whole script stays inside its time limit on a slow host
FLEET_JOBS = (
    [("grid2d", (s, s), {}) for s in range(241, 257, 4)]
    + [("small_world", (60000 + 365 * i,), {"seed": i})
       for i in range(0, 16, 4)]
    + [("grid3d", (s, s, s), {}) for s in range(33, 41, 4)]
    + [("random_geometric", (32768 + 1024 * i,), {"seed": i})
       for i in range(0, 8, 4)])


def _host_reads(run):
    """run() with CUDA's sync debug mode on: (its result, the number of
    synchronizing device-to-host reads it made)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def phase_fleet_full_width(tp, dev):
    """(m): 12 graphs of a mesh/GNN pipeline's dataset, partitioned as one
    fleet and one by one; every member equal, bit for bit."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import graph as gr
    from repro_torch.core.partition import (PartitionConfig, partition,
                                            partition_fleet)
    from repro_torch.data import graphs as gen
    from repro_torch.kernels.jet_gain import ops
    from repro_torch.kernels.jet_gain.ref import jet_gain_ref

    t0 = time.perf_counter()
    graphs = [getattr(gen, fn)(*a, **kw) for fn, a, kw in FLEET_JOBS]
    n_all = sum(int(g.n) for g in graphs)
    m_all = sum(int(g.m) for g in graphs)
    print(f"(m) {len(graphs)} graphs (4 grid2d 241..253, 4 small_world "
          f"60000+365i, 2 grid3d 33, 37, 2 random_geometric 32768+1024i, "
          f"i a multiple of 4): "
          f"{n_all} vertices, {m_all} directed edges (made in "
          f"{time.perf_counter() - t0:.1f} s)")
    cfg = PartitionConfig(k=64, trials=4, backend="ell")

    # the fleet: counts from 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fres, fleet_reads = _host_reads(lambda: partition_fleet(graphs, cfg))
    fleet_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    # the standalone loop
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    solos, solo_reads = _host_reads(
        lambda: [partition(g, cfg) for g in graphs])
    solo_s = time.perf_counter() - t0
    solo_launches = dict(kernels.launch_counts)

    for i, (g, res, solo) in enumerate(zip(graphs, fres.results, solos)):
        if tp.member_summary(res) != tp.member_summary(solo) or \
                res.imbalance != solo.imbalance or \
                not torch.equal(res.parts, solo.parts) or \
                not torch.equal(res.trial_parts, solo.trial_parts):
            raise AssertionError(f"(m) member {i} ({FLEET_JOBS[i][:2]}) "
                                 f"differs from its standalone run")
        n, k = int(g.n), cfg.k
        parts = res.parts.cpu().numpy()[:n]
        src, dst = g.esrc.numpy()[: int(g.m)], g.adjncy.numpy()[: int(g.m)]
        cut = int(g.adjwgt.numpy()[: int(g.m)][parts[src] != parts[dst]]
                  .sum()) // 2
        if not res.balanced or cut != res.cut:
            raise AssertionError(f"(m) member {i}: balanced {res.balanced}, "
                                 f"cut {res.cut} != recomputed {cut}")
    # one batched loop iteration launches jet_gain once for the bucket
    batched, per_bucket = 0, []
    for b in fres.buckets:
        its = [max(max(fres.results[j].level_stats[li]["iterations"])
                   for j in b.indices) for li in range(b.levels)]
        per_bucket.append(its)
        batched += sum(its)
    standalone = sum(max(st["iterations"]) for r in solos
                     for st in r.level_stats)
    if launches.get("jet_gain", 0) != batched or \
            solo_launches.get("jet_gain", 0) != standalone or \
            not batched < standalone:
        raise AssertionError(
            f"(m) jet_gain launches {launches} != batched iterations "
            f"{batched}, or standalone {solo_launches} != {standalone}, or "
            "not fewer")
    for b, its in zip(fres.buckets, per_bucket):
        print(f"(m) bucket {list(b.capacity)}: {len(b.indices)} members "
              f"{b.indices}, {b.levels} levels, batched loop iterations per "
              f"level (coarsest first) {its}")
    print(f"(m) every member == its standalone partition() bit for bit "
          f"(parts, trial parts, cuts, balance, levels, level stats); all "
          f"balanced, cuts recomputed on the host; cuts "
          f"{[r.cut for r in fres.results]}")
    print(f"(m) fleet {fleet_s:.3f} s ({len(graphs) / fleet_s:.4f} graphs/s) "
          f"against the standalone loop {solo_s:.3f} s "
          f"({len(graphs) / solo_s:.4f} graphs/s): {solo_s / fleet_s:.3f}x; "
          "phase times " + json.dumps(
              {kk: round(v, 3) for kk, v in fres.times.items()
               if isinstance(v, float)}))
    print(f"(m) jet_gain launches: fleet {batched} (= the batched "
          f"iterations), standalone {standalone}; max_memory_allocated "
          f"{peak} bytes (fleet)")
    print(f"(m) host reads (CUDA sync debug mode): fleet {fleet_reads}, "
          f"standalone loop {solo_reads}; per bucket level, 2 in coarsening "
          "(the two-hop trigger, the (B, 3) stats) and one per batched loop "
          "iteration plus one, and one transfer of all results at the end")

    # jet_gain at the largest bucket's finest shapes, as the path gives it
    big = max(fres.buckets, key=lambda b: len(b.indices) * b.capacity[0])
    cap = big.capacity
    gb = gr.stack_bucket([graphs[j] for j in big.indices], cap).to(dev)
    width = big.level_stats[-1]["ell_width"]
    tparts = torch.stack([
        torch.cat([fres.results[j].trial_parts[:, :cap[0]],
                   torch.full((cfg.trials, max(0, cap[0] - graphs[j].n_max)),
                              cfg.k, dtype=torch.int32, device=dev)], -1)
        for j in big.indices])
    nbr, wgt = ops.csr_to_ell(gb, width)
    nbr_parts = ops.lookup_nbr_parts(nbr, tparts, cfg.k)
    got = ops.jet_gain_from_parts(nbr_parts, wgt, tparts, cfg.k)
    want = jet_gain_ref(nbr_parts, wgt, tparts, cfg.k)
    err = max(int((a - b_).abs().max()) for a, b_ in zip(got, want))
    ms = _time_ms(lambda: ops.jet_gain_from_parts(nbr_parts, wgt, tparts,
                                                  cfg.k), 50)
    plain_ms = _time_ms(lambda: jet_gain_ref(nbr_parts, wgt, tparts, cfg.k), 5)
    nbytes = ops.jet_gain_cost(nbr_parts, wgt, tparts, cfg.k)["bytes"]
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    b, t, nn, d = nbr_parts.shape
    print(f"(m) jet_gain at the largest bucket's finest level (B={b}, T={t}, "
          f"N={nn}, D={d}, k={cfg.k}, per-lane weights): {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes)")
    if err != 0:
        raise AssertionError(f"(m) jet_gain differs from plain by {err}")
    return {"launches": batched, "standalone_launches": standalone,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "max_abs_err": err, "shape": {"B": b, "T": t, "N": nn, "D": d,
                                           "k": cfg.k},
            "graphs_per_s": len(graphs) / fleet_s,
            "standalone_graphs_per_s": len(graphs) / solo_s}


# ---------------------------------------------------------------------------
# partition-as-a-service: PartitionServer over the fleet
# ---------------------------------------------------------------------------

# a mesh/GNN pipeline's jobs at (m)'s sizes: (family, size, seed, weight)
SERVE_FAMILIES = (("grid", 256, 0, 2.0), ("grid", 250, 0, 1.0),
                  ("smallworld", 245, 0, 1.0), ("smallworld", 250, 1, 1.0),
                  ("cube", 250, 0, 1.0), ("geo", 200, 0, 1.0))
SERVE_KS = (16, 64)


def _batched_iterations(fleets) -> int:
    """jet_gain launches that stacked-fleet runs must make: per bucket and
    level, the most refinement iterations of any of its rows."""
    total = 0
    for fres in fleets:
        by_tag = fres.results
        for b in fres.buckets:
            real = [by_tag[t] for t in b.indices if t is not None]
            total += sum(max(max(r.level_stats[li]["iterations"])
                             for r in real) for li in range(b.levels))
    return total


def _replay(server, workload):
    """One replay through the server: (records, wall seconds, stacked-fleet
    results it ran)."""
    import asyncio

    from repro_torch.launch import partition_serve as ps
    from repro_torch.launch import serve_cli

    fleets = []
    run_fleet = ps.partition_fleet_stacked

    def keep(*a, **kw):
        fres = run_fleet(*a, **kw)
        fleets.append(fres)
        return fres

    with swapped(ps, "partition_fleet_stacked", keep):
        t0 = time.perf_counter()
        records = asyncio.run(serve_cli.replay_workload(server, workload))
        wall = time.perf_counter() - t0
    return records, wall, fleets


def _latency_ms(records, q) -> float:
    return 1e3 * float(np.percentile([r["latency_s"] for r in records], q))


def phase_serve_full_width(tp):
    """(o): a partition service at (m)'s graph sizes: warmup, a burst, a
    Poisson replay; every response equal to its standalone run."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import graph as gr
    from repro_torch.core.partition import (PartitionConfig,
                                            fleet_signature_count)
    from repro_torch.launch import partition_serve as ps
    from repro_torch.launch import serve_cli

    spec = {"families": [{"graph": f, "size": s, "seed": sd, "weight": w}
                         for f, s, sd, w in SERVE_FAMILIES],
            "ks": list(SERVE_KS), "count": 32, "rate_rps": 2000.0,
            "trials": 4, "seed": 0}
    t0 = time.perf_counter()
    burst = serve_cli.build_workload(spec)
    by_family = {r["family"]: r["graph"] for r in burst}  # first-seen order
    names, shapes = list(by_family), list(by_family.values())
    sizes = [int(g.n) for g in shapes]
    scfg = ps.ServeConfig(
        ladder_n=max(g.n_max for g in shapes),
        ladder_m=max(g.m_max for g in shapes), window_s=0.05, lanes=4,
        max_batch=64, partition=PartitionConfig(backend="ell", trials=4))
    server = ps.PartitionServer(scfg)
    _, bucket_map = gr.bucket_graphs(shapes, schedule=server.schedule)
    print(f"(o) families {names} (vertices {sizes}), made in "
          f"{time.perf_counter() - t0:.1f} s; ladder top "
          f"({scfg.ladder_n}, {scfg.ladder_m}); buckets "
          + "; ".join(f"{list(cap)}: {[names[i] for i in ix]}"
                      for cap, ix in sorted(bucket_map.items(),
                                            reverse=True)))
    if not any(len({sizes[i] for i in ix}) >= 2
               for ix in bucket_map.values()):
        raise AssertionError("(o) no bucket holds two different true sizes")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = server.warmup(shapes, ks=SERVE_KS, trials=(4,))
    print(f"(o) warmup (compositions=subsets, k in {SERVE_KS}, T=4): "
          f"{len(server.warmup_log)} dispatches, "
          f"{warm['new_executables']} new signatures, "
          f"warmup_s {warm['warmup_s']:.3f}")

    # the served path: counts from 0 just before, read just after
    sigs0 = fleet_signature_count()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rec_burst, burst_s, fleets = _replay(server, burst)
    occ_burst = dict(server.stats["occupancy_hist"])
    rps = len(rec_burst) / burst_s
    # a Poisson stream at half the burst's throughput, on the same graphs
    poisson = serve_cli.build_workload(dict(spec, count=6, seed=1,
                                            rate_rps=rps / 2))
    for r in poisson:
        r["graph"] = by_family[r["family"]]
    seg0 = torch.cuda.memory_stats()["segment.all.allocated"]
    rec_poisson, poisson_s, more = _replay(server, poisson)
    torch.cuda.synchronize()
    new_segments = torch.cuda.memory_stats()["segment.all.allocated"] - seg0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    fleets += more
    new_sigs = fleet_signature_count() - sigs0
    covered = ps.serve_signatures(server.dispatch_log) <= \
        ps.serve_signatures(server.warmup_log)
    batched = _batched_iterations(fleets)
    metrics = server.metrics()

    records = rec_burst + rec_poisson
    t0 = time.perf_counter()
    solos = serve_cli.verify_responses(records, burst, scfg.partition,
                                       server.device)
    verify_s = time.perf_counter() - t0
    for rec in records:
        solo = solos[(rec["family"], rec["k"], rec["trials"])]
        res = rec["result"]
        if tp.member_summary(res) != tp.member_summary(solo) or \
                res.imbalance != solo.imbalance or \
                not torch.equal(res.trial_parts, solo.trial_parts):
            raise AssertionError(f"(o) {rec['family']} k={rec['k']} differs "
                                 "from its standalone run")
    unbalanced = sum(not r["balanced"] for r in records)

    print(f"(o) burst: {len(rec_burst)} requests at 2000 req/s in "
          f"{burst_s:.3f} s: {rps:.4f} req/s, latency p50 "
          f"{_latency_ms(rec_burst, 50):.1f} ms, p95 "
          f"{_latency_ms(rec_burst, 95):.1f} ms; occupancy (real lanes: "
          f"buckets) {occ_burst}")
    print(f"(o) Poisson: {len(rec_poisson)} requests at "
          f"{rps / 2:.4f} req/s in {poisson_s:.3f} s "
          f"({len(rec_poisson) / poisson_s:.4f} req/s), latency p50 "
          f"{_latency_ms(rec_poisson, 50):.1f} ms, p95 "
          f"{_latency_ms(rec_poisson, 95):.1f} ms; new allocator segments "
          f"(segment.all.allocated) {new_segments}")
    print(f"(o) server: {metrics['dispatches']} dispatches, "
          f"{metrics['buckets']} buckets, occupancy "
          f"{metrics['occupancy_hist']}, filler lanes "
          f"{metrics['filler_lanes']}, mean occupancy "
          f"{metrics['mean_occupancy']:.3f}; max_memory_allocated {peak} "
          f"bytes; jet_gain launches {launches.get('jet_gain', 0)} (batched "
          f"loop iterations {batched}); new signatures after warmup "
          f"{new_sigs}, replay covered by warmup {covered}; {unbalanced} "
          f"unbalanced responses")
    print(f"(o) every response == its standalone partition() on the card bit "
          f"for bit ({len(solos)} standalone runs, {verify_s:.1f} s)")
    if new_sigs != 0 or not covered:
        raise AssertionError(f"(o) {new_sigs} new signatures after warmup, "
                             f"covered {covered}")
    if launches.get("jet_gain", 0) != batched:
        raise AssertionError(f"(o) jet_gain launches {launches} != batched "
                             f"loop iterations {batched}")
    if metrics["responses"] != len(records) or \
            not any(b["real"] >= 2 and len(set(b["member_n_max"])) >= 2
                    for d in server.dispatch_log for b in d["buckets"]):
        raise AssertionError(f"(o) responses {metrics['responses']} != "
                             f"{len(records)}, or no mixed bucket")
    return {"launches": launches.get("jet_gain", 0),
            "warmup_s": warm["warmup_s"], "throughput_rps": rps,
            "p50_ms": _latency_ms(rec_burst, 50),
            "p95_ms": _latency_ms(rec_burst, 95),
            "poisson_p50_ms": _latency_ms(rec_poisson, 50),
            "poisson_p95_ms": _latency_ms(rec_poisson, 95),
            "peak_bytes": peak}


CACHE_PROBE = """
import dataclasses, json, sys
import torch_parity as tp
from repro_torch.core import partition as pa
from repro_torch.data import graphs as gen
from repro_torch.kernels import _build
from repro_torch.launch import partition_serve as ps
for name in ("serve_sorted", "serve_ell"):
    cfg = dataclasses.replace(tp.serve_config(ps, pa, name),
                              compile_cache=sys.argv[1])
    tp.run_burst(ps.PartitionServer(cfg), tp.serve_burst(gen))
print(json.dumps(_build.cache_stats().snapshot()))
"""


def phase_serve_small(tp):
    """(p): the reference serve test's burst on the card, every backend:
    responses and dispatch logs equal the golden file's; then the kernel
    library cache across two processes."""
    import os
    import shutil
    import tempfile

    from repro_torch.core import partition as pa
    from repro_torch.data import graphs as gen
    from repro_torch.kernels import _build
    from repro_torch.launch import partition_serve as ps

    golden = tp.load_golden_serve()
    launched = {}
    for name in tp.serve_case_names():
        server = ps.PartitionServer(tp.serve_config(ps, pa, name))
        got, launches = _counted(tp.run_burst, server, tp.serve_burst(gen))
        log = json.loads(json.dumps(list(server.dispatch_log)))
        if [tp.member_summary(r) for r in got] != golden[name]["members"] \
                or log != golden[name]["dispatch_log"]:
            raise AssertionError(f"(p) {name}: responses or dispatch log "
                                 "differ from the reference's (golden)")
        for kernel in launches:
            launched[kernel] = launched.get(kernel, 0) + launches[kernel]
    if not launched.get("jet_gain") or not launched.get("segment_reduce"):
        raise AssertionError(f"(p) launches {launched}: ell and sorted must "
                             "run their kernels")
    print(f"(p) the reference serve test's burst (grids 6x6, 6x5 at k=2, 4x4 "
          f"at k=3; lanes 2) on dense, sorted, ell: responses and dispatch "
          f"logs == the JAX reference's (golden); launches {launched}")

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cache = tempfile.mkdtemp(prefix="serve-cache-", dir=_build.BUILD_DIR)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    try:
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", CACHE_PROBE, cache],
                                 capture_output=True, text=True, env=env,
                                 timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"(p) cache probe failed:\n{out.stderr}")
            runs.append((json.loads(out.stdout.splitlines()[-1]),
                         time.perf_counter() - t0))
        libs = sorted(p.name.split("-")[0] for p in Path(cache).glob("*.so"))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    (first, first_s), (second, second_s) = runs
    print(f"(p) kernel-library cache, two processes on one fresh directory: "
          f"first {first} in {first_s:.1f} s, second {second} in "
          f"{second_s:.1f} s; libraries {libs}")
    if libs != ["jet_gain", "segment_reduce"] or \
            first.get("cache_misses") != len(libs) or \
            second.get("cache_misses", 0) != 0 or \
            second.get("cache_hits", 0) < 1:
        raise AssertionError("(p) the second process must build nothing")
    return launched


# ---------------------------------------------------------------------------
# serving: FM (fm_interaction) and Gemma-3 1B (flash_attention)
# ---------------------------------------------------------------------------

F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores (data sheet)


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """Inside, ``module.name`` is ``fn``."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def plain_versions():
    """Inside, the models call the kernels' plain versions on the card: the
    plain path that the kernel path is held against."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fm_interaction import ops as fm_ops
    from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

    with swapped(fm_ops, "fm_interaction", fm_interaction_ref), \
            swapped(fa_ops, "flash_attention", flash_attention_ref):
        yield


def sdpa_attention(q, k, v, causal=True, window=0, q_offset=0):
    """PyTorch's fused attention with the kernel's masks: the library
    yardstick, timed and compared here and used nowhere in the port."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_mask

    if causal and not window and not q_offset and q.shape[2] == k.shape[2]:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    allowed = ~attention_mask(q.shape[2], k.shape[2], causal, window,
                              q_offset, q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                          enable_gqa=True)


LM_GROUPS = (("flash_attention", ("flash_kernel",)),
             ("matrix product", ("gemm", "gemv", "cutlass", "nvjet",
                                 "xmma")))


def _counted(fn, *args):
    """fn(*args) on the card from zeroed launch counts: (result, counts)."""
    import torch

    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(kernels.launch_counts)


def phase_fm_vs_plain(tp, dev):
    import torch

    from repro_torch.kernels.fm_interaction import ops
    from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

    n_cases, worst = 0, 0.0
    for b in (1, 255, 256, 257, 512, 262144):
        for f in (1, 8, 39):
            for d in (1, 10, 16, 128):
                gen = torch.Generator(device=dev).manual_seed(b * f + d)
                e32 = torch.randn(b, f, d, generator=gen, device=dev)
                for dtype in (torch.float32, torch.bfloat16, torch.float16):
                    emb = e32.to(dtype)
                    got = ops.fm_interaction(emb)
                    again = ops.fm_interaction(emb)
                    want = fm_interaction_ref(emb)
                    torch.cuda.synchronize()
                    where = f"(i) fm_interaction B={b} F={f} D={d} {dtype}"
                    if not torch.equal(got, again):
                        raise AssertionError(f"{where}: two launches differ")
                    ratio = tp.fm_error_ratio(got, want, emb)
                    if not ratio <= 1:
                        raise AssertionError(f"{where}: {ratio:.3f} of its "
                                             "tolerance")
                    worst = max(worst, ratio)
                    n_cases += 1
                del e32, emb, got, again, want
    gen = torch.Generator(device=dev).manual_seed(7)
    emb = torch.randn(4099, 40, 24, generator=gen, device=dev)[:, 1:, ::2]
    got = _one_launch("fm_interaction", ops.fm_interaction, emb)
    ratio = tp.fm_error_ratio(got, fm_interaction_ref(emb.contiguous()), emb)
    if emb.is_contiguous() or not ratio <= 1:
        raise AssertionError(f"(i) fm_interaction on a strided view: "
                             f"{ratio:.3f} of its tolerance")
    print(f"(i) fm_interaction == plain on {n_cases} panels (float32, "
          f"bfloat16 and float16 in, at most {worst:.4f} of the tolerance "
          "1e-5 + 1e-5 * sum of e^2 per row; bitwise equal across launches); "
          f"a strided view at {ratio:.4f}")


def phase_fm_serving(tp, dev):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.fm_interaction import ops
    from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref
    from repro_torch.launch import steps
    from repro_torch.models.recsys import fm

    arch = get_arch("fm")
    cfg = arch.config
    t0 = time.perf_counter()
    params = fm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"(j) fm: {cfg.n_fields} fields, D={cfg.embed_dim}, "
          f"{cfg.vocab_total} table rows ({params['table'].numel() * 4} B "
          f"table, {params['linear'].numel() * 4} B linear), "
          f"{cfg.param_count()} parameters, made in "
          f"{time.perf_counter() - t0:.1f} s")
    cells = {name: steps.build_cell(arch, name, device=dev, params=params)
             for name in ("serve_p99", "serve_bulk", "retrieval_cand")}

    # the serving path: counts from 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, launches = _counted(lambda: {
        name: cells[name].step_fn(*cells[name].args)
        for name in ("serve_p99", "serve_bulk")})
    peak = torch.cuda.max_memory_allocated()
    if launches.get("fm_interaction", 0) != 2:
        raise AssertionError(f"(j) fm_interaction launches {launches} != 1 "
                             "per serve call")
    with plain_versions():
        plain, plain_launches = _counted(lambda: {
            name: cells[name].step_fn(*cells[name].args)
            for name in ("serve_p99", "serve_bulk")})
    if plain_launches.get("fm_interaction", 0) != 0:
        raise AssertionError("(j) the plain path launched the kernel")
    worst = 0.0
    for name, scores in out.items():
        ids = cells[name].args[1]
        emb = params["table"][(ids.long() % cfg.rows_per_field)
                              + torch.arange(cfg.n_fields, device=dev)
                              * cfg.rows_per_field]
        ratio = tp.fm_error_ratio(scores, plain[name], emb)
        if not (ratio <= 1 and bool(torch.isfinite(scores).all())
                and scores.shape == ids.shape[:1]):
            raise AssertionError(f"(j) {name}: kernel path {ratio:.3f} of "
                                 "its tolerance against the plain path")
        worst = max(worst, ratio)
    print(f"(j) serve_p99 (B=512) and serve_bulk (B=262144): kernel path == "
          f"plain path within {worst:.4f} of the tolerance; launches "
          f"{launches}; max_memory_allocated {peak} bytes")

    cell = cells["retrieval_cand"]
    scores = cell.step_fn(*cell.args)
    _, user, cand = cell.args
    t = params["table"].double()
    u = t[(user[0].long() % cfg.rows_per_field)
          + torch.arange(cfg.n_fields - 1, device=dev) * cfg.rows_per_field]
    flat_c = cand.long() % cfg.rows_per_field \
        + (cfg.n_fields - 1) * cfg.rows_per_field
    want = t[flat_c] @ u.sum(0) + params["linear"].double()[flat_c]
    err = float((scores.double() - want).abs().max())
    if scores.shape != (1_000_000,) or not err <= 1e-5:
        raise AssertionError(f"(j) retrieval: shape {tuple(scores.shape)}, "
                             f"|f32 - f64| {err}")
    print(f"(j) retrieval_cand: 1,000,000 candidates, |scores - float64| "
          f"{err:.2e}")

    # times at serve_bulk
    ids = cells["serve_bulk"].args[1]
    flat = (ids.long() % cfg.rows_per_field) \
        + torch.arange(cfg.n_fields, device=dev) * cfg.rows_per_field
    emb = params["table"][flat]
    err = float((ops.fm_interaction(emb) - fm_interaction_ref(emb))
                .abs().max())
    ms = _time_ms(lambda: ops.fm_interaction(emb), 50)
    plain_ms = _time_ms(lambda: fm_interaction_ref(emb), 10)
    b, f, d = emb.shape
    cost = ops.fm_interaction_cost(emb)
    nbytes, flops = cost["bytes"], cost["flops"]
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    steps_ms = {name: _time_ms(lambda c=cells[name]: c.step_fn(*c.args), 20)
                for name in cells}
    print(f"(j) fm_interaction at serve_bulk (B={b}, F={f}, D={d}, float32): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes} bytes; {flops} flops)")
    print("(j) serve step times: " + ", ".join(
        f"{name} {v:.4f} ms" for name, v in steps_ms.items())
        + f"; serve_bulk {b / steps_ms['serve_bulk'] * 1e3:.4g} examples/s, "
        f"serve_p99 {512 / steps_ms['serve_p99'] * 1e3:.4g} examples/s")
    reps = 100  # a window of serve steps long enough for the profiler
    groups = phase_profile(
        "(j)", lambda: [cells[name].step_fn(*cells[name].args)
                        for _ in range(reps)
                        for name in ("serve_p99", "serve_bulk")],
        reps * (steps_ms["serve_p99"] + steps_ms["serve_bulk"]) / 1e3,
        f"{reps} x (serve_p99 + serve_bulk) steps", FM_GROUPS)
    # two launches a pair of steps; the profiler may drop the first few
    calls = groups.get("fm_interaction calls", 0)
    pair_ms = 2 * groups["fm_interaction"] / calls if calls else None
    print(f"(j) fm_interaction device time per serve_p99 + serve_bulk pair: "
          f"{pair_ms if pair_ms is not None else 'not measured'} ms")
    return {
        "name": "fm_interaction", "route": "cuda",
        "source": "src/repro_torch/kernels/fm_interaction/fm_interaction.cu",
        "replaces": "src/repro/kernels/fm_interaction/fm_interaction.py:20",
        "launches": launches["fm_interaction"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / F32_FLOPS_PER_S else "operations",
        "library_ms": None,
        "check": "within 1e-5 + 1e-5 * sum of e^2 per row of plain "
                 "(phases i, j)",
        "shape": {"B": b, "F": f, "D": d, "dtype": "float32"},
        "device_ms_per_serve_pair": pair_ms,
    }


def phase_flash_vs_plain(tp, dev):
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    n_cases, worst = 0, {}
    widths = [(d, d) for d in (8, 36, 64, 128, 256)] + list(tp.FLASH_DV)
    for shape in tp.FLASH_SHAPES:
        h, hkv, sq, skv, causal, window, off = shape
        for d, dv in widths:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                # D == Dv keeps its earlier seed, so its inputs are as before
                q, k, v = tp.qkv(2, h, hkv, sq, skv, d, dtype,
                                 seed=sq * skv + d + (dv != d) * dv,
                                 device=dev, dv=dv)
                got = ops.flash_attention(q, k, v, causal, window, off)
                again = ops.flash_attention(q, k, v, causal, window, off)
                want = flash_attention_ref(q, k, v, causal, window, off)
                torch.cuda.synchronize()
                where = f"(k) flash_attention {shape} D={d} Dv={dv} {dtype}"
                if got.shape != want.shape or not torch.equal(got, again):
                    raise AssertionError(f"{where}: two launches differ or "
                                         f"shape {tuple(got.shape)}")
                ratio = tp.flash_error_ratio(got, want)
                dead = want.float().abs().amax(dim=-1) == 0
                if not ratio <= 1 or not bool((got[dead] == 0).all()):
                    raise AssertionError(f"{where}: {ratio:.3f} of its "
                                         "tolerance, or a masked row not 0")
                worst[dtype] = max(worst.get(dtype, 0.0), ratio)
                n_cases += 1
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(2, 300, 4, 128, generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    got = _one_launch("flash_attention", ops.flash_attention, q, k, v, True,
                      16)
    ratio = tp.flash_error_ratio(got, flash_attention_ref(
        q.contiguous(), k.contiguous(), v.contiguous(), True, 16))
    if q.is_contiguous() or not ratio <= 1:
        raise AssertionError(f"(k) flash_attention on strided views: "
                             f"{ratio:.3f} of its tolerance")
    print(f"(k) flash_attention on strided (transposed) bfloat16 views: "
          f"{ratio:.4f} of the tolerance")
    print(f"(k) flash_attention == plain on {n_cases} cases (groups 1 and 4, "
          "D = Dv in {8, 36, 64, 128, 256} and (D, Dv) in "
          f"{set(tp.FLASH_DV)}, causal and not, windows 0/16/512, "
          "offsets, ragged tiles, rows that see no key = 0): worst "
          + ", ".join(f"{str(k_)[6:]} {v_:.4f}" for k_, v_ in worst.items())
          + " of the tolerance; bitwise equal across launches")


def _flash_at_shape(tp, dev, window: int, b=4, h=4, hkv=1, s=4096, d=256,
                    dv=256):
    """The kernel, its plain version and SDPA at one causal bfloat16 prefill
    layer; the default is Gemma-3 1B's (B=4, H=4, Hkv=1, S=4096, D=Dv=256)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask, flash_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(window)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16)
               for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, dv)))
    gqa = h != hkv
    got = ops.flash_attention(q, k, v, True, window)
    want = flash_attention_ref(q, k, v, True, window)
    ratio = tp.flash_error_ratio(got, want)
    err = float((got.float() - want.float()).abs().max())
    ms = _time_ms(lambda: ops.flash_attention(q, k, v, True, window), 10)
    plain_ms = _time_ms(lambda: flash_attention_ref(q, k, v, True, window), 3)
    if window:     # the mask is made once, outside the timed call
        allowed = ~attention_mask(s, s, True, window, 0, dev)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                  enable_gqa=gqa)
    else:
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=gqa)

    lib_err = float((library().float() - want.float()).abs().max())
    library_ms = _time_ms(library, 10)
    # q, k, v in, o out; q k^T and P V: 2 D + 2 Dv flops a visible pair
    cost = ops.flash_attention_cost(q, k, v, True, window)
    nbytes, flops = cost["bytes"], cost["flops"]
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bytes": nbytes, "flops": flops,
            "max_abs_err": err, "ratio": ratio, "library_err": lib_err,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / BF16_FLOPS_PER_S else "operations"}


def _greedy_agreement(tag: str, res, plain) -> int:
    """Greedy tokens of the kernel path equal the plain path's wherever the
    plain run's top-2 margin exceeds twice the logit difference, up to a
    row's first allowed divergence; returns the (row, step) pairs checked."""
    import torch

    tok, ptok = res["tokens"].cpu(), plain["tokens"].cpu()
    checked = 0
    for row in range(tok.shape[0]):
        for t in range(tok.shape[1]):
            diff = float((res["logits"][t][row] - plain["logits"][t][row])
                         .abs().max())
            top2 = torch.topk(plain["logits"][t][row], 2).values
            margin = float(top2[0] - top2[1])
            if tok[row, t] != ptok[row, t]:
                if margin > 2 * diff:
                    raise AssertionError(
                        f"{tag} row {row} step {t}: tokens "
                        f"{int(tok[row, t])} != {int(ptok[row, t])} at margin "
                        f"{margin:.4g} > 2 x {diff:.4g}")
                break
            checked += 1
    return checked


def _teacher_forced(cfg, params, prompts, fed, max_len):
    """Prefill logits and the logits after each fed token, in float32 on
    the host."""
    from repro_torch.models import transformer as tf

    logits, cache = tf.prefill(cfg, params, prompts, max_len=max_len)
    out = [logits.cpu()]
    for t in fed:
        logits, cache = tf.decode_step(cfg, params, cache, t)
        out.append(logits.cpu())
    return out


def phase_gemma(tp, dev):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("(l) TF32 matmuls are on: float32 products "
                             "would not be float32")
    arch = get_arch("gemma3-1b")
    cfg = arch.config
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = params["embed"].numel() + params["final_ln"].numel() + sum(
        w.numel() for w in params["layers"].values())
    if n_params != cfg.param_count():
        raise AssertionError(f"(l) {n_params} parameters != param_count() "
                             f"{cfg.param_count()}")
    print(f"(l) gemma3-1b: {n_params} parameters (bfloat16 weights, float32 "
          f"norms), made in {time.perf_counter() - t0:.1f} s")
    batch, prompt_len, steps = 4, 4096, 32
    max_len = prompt_len + steps
    prompts = next(synthetic.lm_batches(cfg.vocab, batch, prompt_len, seed=0,
                                        device=dev))["tokens"]

    serve.generate(cfg, params, prompts, 1)     # warm-up: library loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches = _counted(serve.generate, cfg, params, prompts, steps,
                             max_len, True)
    peak = torch.cuda.max_memory_allocated()
    if launches.get("flash_attention", 0) != cfg.n_layers:
        raise AssertionError(f"(l) flash_attention launches {launches} != "
                             f"{cfg.n_layers} per prefill")
    with plain_versions():
        plain, plain_launches = _counted(serve.generate, cfg, params,
                                         prompts, steps, max_len, True)
    if plain_launches.get("flash_attention", 0) != 0:
        raise AssertionError("(l) the plain path launched the kernel")
    # the spread between two correct bf16 attentions through 26 layers:
    # the same prefill with PyTorch's fused attention in place of the kernel
    got, want = res["logits"][0], plain["logits"][0]
    with swapped(fa_ops, "flash_attention", sdpa_attention):
        lib_logits, _ = tf.prefill(cfg, params, prompts, max_len)
    lib_rel = float((lib_logits - want).norm() / want.norm())
    rel = float((got - want).norm() / want.norm())
    if not (rel <= max(1e-2, 2 * lib_rel)
            and bool(torch.isfinite(got).all())
            and got.shape == (batch, cfg.vocab)):
        raise AssertionError(f"(l) prefill logits: kernel path vs plain "
                             f"path relative L2 {rel:.3e} > max(1e-2, 2 x "
                             f"the SDPA path's {lib_rel:.3e})")
    checked = _greedy_agreement("(l)", res, plain)
    tok = res["tokens"].cpu()
    prefill_s, decode_s = res["prefill_s"], res["decode_s"]
    print(f"(l) prefill {batch} x {prompt_len} tokens: {prefill_s:.4f} s "
          f"({batch * prompt_len / prefill_s:.6g} tokens/s); {steps} decode "
          f"steps: {decode_s / steps * 1e3:.4f} ms per step "
          f"({batch * steps / decode_s:.6g} tokens/s); plain path prefill "
          f"{plain['prefill_s']:.4f} s, decode "
          f"{plain['decode_s'] / steps * 1e3:.4f} ms per step")
    kv_bytes = 2 * cfg.n_layers * batch * cfg.n_kv_heads * max_len \
        * cfg.head_dim * 2
    print(f"(l) max_memory_allocated {peak} bytes (KV cache {kv_bytes} "
          f"bytes); launches {launches}")
    print(f"(l) prefill logits, kernel vs plain path: relative L2 {rel:.3e}, "
          f"max |diff| {float((got - want).abs().max()):.4g}; greedy tokens "
          f"equal at {checked} of {batch * (steps + 1)} (row, step) pairs "
          f"checked; first tokens {tok[:, :8].tolist()}")
    print(f"(l) prefill logits, SDPA path vs plain path (the yardstick): "
          f"relative L2 {lib_rel:.3e}, max |diff| "
          f"{float((lib_logits - want).abs().max()):.4g}")
    del res, plain, lib_logits

    # where the time goes: one prefill and 8 decode steps under the profiler
    phase_profile("(l) prefill", lambda: tf.prefill(
        cfg, params, prompts, max_len), prefill_s, "prefill", LM_GROUPS)
    logits, cache = tf.prefill(cfg, params, prompts, max_len)
    n_prof = min(8, steps)

    def decode_steps():
        c, t = cache, torch.argmax(logits, -1)
        for _ in range(n_prof):
            lg, c = tf.decode_step(cfg, params, c, t)
            t = torch.argmax(lg, -1)

    phase_profile("(l) decode", decode_steps, n_prof * decode_s / steps,
                  f"{n_prof} decode steps", LM_GROUPS)
    del logits, cache

    shapes = {"global": _flash_at_shape(tp, dev, 0),
              "local": _flash_at_shape(tp, dev, cfg.window)}
    for name, r in shapes.items():
        if not r["ratio"] <= 1:
            raise AssertionError(f"(l) flash_attention at a {name} layer: "
                                 f"{r['ratio']:.3f} of its tolerance")
        print(f"(l) flash_attention at a {name} layer (4, 4, 4096, 256) "
              f"bfloat16: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"SDPA {r['library_ms']:.4f} ms (kernel/SDPA "
              f"{r['ms'] / r['library_ms']:.3f}; |SDPA - plain| "
              f"{r['library_err']:.3g}), bound {r['bound_ms']:.4f} ms "
              f"({r['flops']} flops, {r['bytes']} bytes, bound by "
              f"{r['bound_by']}); |kernel - plain| {r['max_abs_err']:.3g}")

    # the smoke config on the card against this machine's CPU
    smoke = arch.smoke
    p_cpu = tf.init_params(smoke, torch.Generator().manual_seed(0))
    p_card = tf.tree_to(p_cpu, dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, smoke.vocab, (2, 64)))
    fed = torch.from_numpy(rng.integers(0, smoke.vocab, (8, 2)))
    cpu = _teacher_forced(smoke, p_cpu, toks, fed, 72)
    card = _teacher_forced(smoke, p_card, toks.to(dev), fed.to(dev), 72)
    err = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
    if not all(torch.allclose(a, b, rtol=2e-4, atol=2e-4)
               for a, b in zip(card, cpu)):
        raise AssertionError(f"(l) smoke config: card vs CPU logits {err}")
    print(f"(l) smoke config (6 layers, float32): card logits == CPU logits "
          f"within 2e-4 over prefill and 8 decode steps (max |diff| "
          f"{err:.3g})")
    g = shapes["global"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:25",
        "launches": launches["flash_attention"],
        "max_abs_err": g["max_abs_err"], "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "check": "within 2e-5 + 2e-5 |plain| (float32, CUDA cores), 1e-5 + "
                 "1e-2 |plain| (bfloat16, float16, tensor cores) of plain "
                 "(phases k, l)",
        "shape": {"B": 4, "H": 4, "Hkv": 1, "S": 4096, "D": 256,
                  "dtype": "bfloat16", "window": 0},
        "local_layer": {key: shapes["local"][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
    }


# ---------------------------------------------------------------------------
# serving: DeepSeek-V2-Lite 16B (MLA + MoE; flash_attention with Dv != D)
# ---------------------------------------------------------------------------

MOE_GROUPS = LM_GROUPS + (("sort", ("sort",)),
                          ("gather, scatter, index", ("gather", "scatter",
                                                      "index")))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _distinct_experts(cfg, params, gen) -> None:
    """Every routed expert of every layer drawn anew from ``gen`` (the
    port's ``init_params`` repeats one draw over a layer's experts, as the
    reference's ``moe_init`` does), one layer at a time."""
    from repro_torch.models.layers import dense_init

    experts = params["layers"]["moe"]
    d, f, e = cfg.d_model, cfg.d_expert, cfg.n_experts
    for i in range(cfg.n_layers):
        for name, d_in, d_out in (("w_gate", d, f), ("w_up", d, f),
                                  ("w_down", f, d)):
            w = experts[name][i]
            w.copy_(dense_init(gen, d_in, d_out, w.dtype, lead=(e,)))


def _recording(sets: list):
    """``moe.moe_apply`` that first keeps each token's top-k expert set
    (sorted ids, (T, K)) of the call."""
    import torch

    from repro_torch.models import moe

    inner = moe.moe_apply

    def recorded(params, x, *, top_k, **kw):
        sets.append(torch.sort(moe.route(params, x, top_k)[2], -1).values)
        return inner(params, x, top_k=top_k, **kw)
    return recorded


def phase_deepseek(tp, dev):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    torch.cuda.empty_cache()
    arch = get_arch("deepseek-v2-lite-16b")
    cfg = arch.config
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(cfg, gen)
    _distinct_experts(cfg, params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"(q) {n_params} parameters != param_count() "
                             f"{cfg.param_count()}")
    print(f"(q) deepseek-v2-lite-16b: {n_params} parameters (bfloat16 "
          f"weights, float32 router and norms; every routed expert drawn on "
          f"its own), made in {time.perf_counter() - t0:.1f} s")
    batch, prompt_len, steps = 4, 4096, 32
    max_len = prompt_len + steps
    prompts = next(synthetic.lm_batches(cfg.vocab, batch, prompt_len, seed=0,
                                        device=dev))["tokens"]

    serve.generate(cfg, params, prompts, 1)     # warm-up: library loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches = _counted(serve.generate, cfg, params, prompts, steps,
                             max_len, True)
    peak = torch.cuda.max_memory_allocated()
    if launches.get("flash_attention", 0) != cfg.n_layers:
        raise AssertionError(f"(q) flash_attention launches {launches} != "
                             f"{cfg.n_layers} per prefill")
    with plain_versions():
        plain, plain_launches = _counted(serve.generate, cfg, params,
                                         prompts, steps, max_len, True)
    if plain_launches.get("flash_attention", 0) != 0:
        raise AssertionError("(q) the plain path launched the kernel")
    # the yardstick: the same prefill with PyTorch's fused attention (Ev =
    # 128) in place of the kernel
    got, want = res["logits"][0], plain["logits"][0]
    with swapped(fa_ops, "flash_attention", sdpa_attention):
        lib_logits, _ = tf.prefill(cfg, params, prompts, max_len)
    lib_rel = float((lib_logits - want).norm() / want.norm())
    rel = float((got - want).norm() / want.norm())
    if not (rel <= max(1e-2, 2 * lib_rel)
            and bool(torch.isfinite(got).all())
            and got.shape == (batch, cfg.vocab)):
        raise AssertionError(f"(q) prefill logits: kernel path vs plain "
                             f"path relative L2 {rel:.3e} > max(1e-2, 2 x "
                             f"the SDPA path's {lib_rel:.3e})")
    checked = _greedy_agreement("(q)", res, plain)
    prefill_s, decode_s = res["prefill_s"], res["decode_s"]
    print(f"(q) prefill {batch} x {prompt_len} tokens: {prefill_s:.4f} s "
          f"({batch * prompt_len / prefill_s:.6g} tokens/s); {steps} decode "
          f"steps: {decode_s / steps * 1e3:.4f} ms per step "
          f"({batch * steps / decode_s:.6g} tokens/s); plain path prefill "
          f"{plain['prefill_s']:.4f} s, decode "
          f"{plain['decode_s'] / steps * 1e3:.4f} ms per step")
    cache_bytes = cfg.n_layers * batch * max_len \
        * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    print(f"(q) max_memory_allocated {peak} bytes (MLA cache ckv + krope "
          f"{cache_bytes} bytes at max_len {max_len}); launches {launches}")
    print(f"(q) prefill logits, kernel vs plain path: relative L2 {rel:.3e}, "
          f"max |diff| {float((got - want).abs().max()):.4g}; greedy tokens "
          f"equal at {checked} of {batch * (steps + 1)} (row, step) pairs "
          f"checked; first tokens {res['tokens'][:, :8].tolist()}")
    print(f"(q) prefill logits, SDPA path vs plain path (the yardstick): "
          f"relative L2 {lib_rel:.3e}, max |diff| "
          f"{float((lib_logits - want).abs().max()):.4g}")
    del res, plain, lib_logits

    # the routing the two prefills chose: (token, layer) top-6 sets
    sets = {"kernel": [], "plain": []}
    with swapped(moe, "moe_apply", _recording(sets["kernel"])):
        tf.prefill(cfg, params, prompts, max_len)
    with plain_versions(), \
            swapped(moe, "moe_apply", _recording(sets["plain"])):
        tf.prefill(cfg, params, prompts, max_len)
    differ = sum(int((a != b).any(-1).sum())
                 for a, b in zip(sets["kernel"], sets["plain"]))
    total = sum(a.shape[0] for a in sets["kernel"])
    print(f"(q) routing, kernel vs plain path prefill: {differ} of {total} "
          f"(token, layer) top-{cfg.top_k} expert sets differ "
          f"({differ / total:.4g}; not gated: a different set is a "
          "different expert mix, which is where the logits part)")
    del sets

    # where the time goes: one prefill and 8 decode steps under the profiler
    groups = phase_profile("(q) prefill", lambda: tf.prefill(
        cfg, params, prompts, max_len), prefill_s, "prefill", MOE_GROUPS)
    logits, cache = tf.prefill(cfg, params, prompts, max_len)
    n_prof = min(8, steps)

    def decode_steps():
        c, t = cache, torch.argmax(logits, -1)
        for _ in range(n_prof):
            lg, c = tf.decode_step(cfg, params, c, t)
            t = torch.argmax(lg, -1)

    phase_profile("(q) decode", decode_steps, n_prof * decode_s / steps,
                  f"{n_prof} decode steps", MOE_GROUPS)
    del logits, cache, params
    torch.cuda.empty_cache()

    r = _flash_at_shape(tp, dev, 0, b=batch, h=cfg.n_heads, hkv=cfg.n_heads,
                        s=prompt_len, d=cfg.qk_dim, dv=cfg.v_head_dim)
    if not r["ratio"] <= 1:
        raise AssertionError(f"(q) flash_attention at the MLA layer: "
                             f"{r['ratio']:.3f} of its tolerance")
    print(f"(q) flash_attention at the MLA layer ({batch}, {cfg.n_heads}, "
          f"{prompt_len}, D {cfg.qk_dim}, Dv {cfg.v_head_dim}) bfloat16: "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"SDPA {r['library_ms']:.4f} ms (kernel/SDPA "
          f"{r['ms'] / r['library_ms']:.3f}; |SDPA - plain| "
          f"{r['library_err']:.3g}), bound {r['bound_ms']:.4f} ms "
          f"({r['flops']} flops, {r['bytes']} bytes, bound by "
          f"{r['bound_by']}); |kernel - plain| {r['max_abs_err']:.3g}")

    # the smoke config (float32: the CUDA-core kernel at D 24, Dv 16) on the
    # card against this machine's CPU, distinct experts
    smoke = arch.smoke
    p_cpu = tf.init_params(smoke, torch.Generator().manual_seed(0))
    _distinct_experts(smoke, p_cpu, torch.Generator().manual_seed(1))
    p_card = tf.tree_to(p_cpu, dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, smoke.vocab, (2, 64)))
    fed = torch.from_numpy(rng.integers(0, smoke.vocab, (8, 2)))
    cpu = _teacher_forced(smoke, p_cpu, toks, fed, 72)
    card, smoke_launches = _counted(_teacher_forced, smoke, p_card,
                                    toks.to(dev), fed.to(dev), 72)
    err = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
    if smoke_launches.get("flash_attention", 0) != smoke.n_layers or not all(
            torch.allclose(a, b, rtol=2e-4, atol=2e-4)
            for a, b in zip(card, cpu)):
        raise AssertionError(f"(q) smoke config: card vs CPU logits {err}, "
                             f"launches {smoke_launches}")
    print(f"(q) smoke config ({smoke.n_layers} layers, float32, MLA D "
          f"{smoke.qk_dim} Dv {smoke.v_head_dim}, {smoke.n_experts} experts "
          f"top-{smoke.top_k}): card logits == CPU logits within 2e-4 over "
          "prefill and 8 "
          f"decode steps (max |diff| {err:.3g})")
    return {
        "launches": launches["flash_attention"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": {"B": batch, "H": cfg.n_heads, "Hkv": cfg.n_heads,
                  "S": prompt_len, "D": cfg.qk_dim, "Dv": cfg.v_head_dim,
                  "dtype": "bfloat16", "window": 0},
        "device_ms_per_prefill": groups.get("flash_attention"),
    }


# Kernel path against plain path in the GNN phases.  The two differ only in
# the order of each segment's float32 sum (a few ulps a sum); through 15
# residual blocks and a mean over 10^5-10^6 terms that stays near 1e-6 of
# the loss, and gradients, whose small elements move more, near 1e-5.
GNN_LOSS_RTOL = 1e-5  # the loss at every step
GNN_GRAD_RL2 = 1e-4   # step-1 gradients, relative L2 over all parameters
SCATTER_NAMES = ("index_add", "scatter_add", "index_put", "indexfunc",
                 "indexing_backward", "embedding_dense_backward")
GNN_GROUPS = (("segment_reduce", ("splits_pass", "tiles_pass",
                                  "carry_pass")),
              ("matrix product", ("gemm", "gemv", "cutlass", "nvjet",
                                  "xmma")),
              ("row gathers (index_select)", ("gather_kernel",
                                              "indexselect")),
              ("concatenation", ("catarray",)))


@contextlib.contextmanager
def plain_segment_sums():
    """Inside, the GNNs' sums take segment_reduce's plain version on the
    card (``index_add_``): the plain path the kernel path is held to."""
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref

    with swapped(ops, "segment_sum_sorted", segment_sum_sorted_ref):
        yield


def _rel_l2(got, want) -> float:
    """Relative L2 distance of two trees of tensors, in float64."""
    from repro_torch import tree

    a, b = tree.leaves(got), tree.leaves(want)
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    return (num / sum(float((y.double() ** 2).sum()) for y in b)) ** 0.5


def _equal(x, y) -> bool:
    import torch

    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


def _bitwise(a, b) -> bool:
    """Two trees of tensors equal bit for bit."""
    from repro_torch import tree

    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(map(_equal, la, lb))


def _close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * abs(b)


def phase_gnn_training(tp, dev):
    """(r) MeshGraphNet training on a Jet-partitioned mesh (the main
    path of GNN training)."""
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.graph import build_csr_host
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.data import synthetic
    from repro_torch.dist import partition_aware as pa
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref
    from repro_torch.models.gnn import common, meshgraphnet
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = get_arch("meshgraphnet").config
    t0 = time.perf_counter()
    data = synthetic.mesh_batch(512, 512, seed=0, device=dev)
    graph = data["graph"]
    n, e = graph.node_feat.shape[0], graph.senders.shape[0]
    g = build_csr_host(n, torch.stack([graph.senders, graph.receivers],
                                      1).cpu().numpy())
    print(f"(r) mesh_batch(512, 512): N = {n} nodes, E = {e} directed edges "
          f"(host graph m = {int(g.m)}; made in "
          f"{time.perf_counter() - t0:.1f} s); MeshGraphNet {cfg.n_layers} "
          f"blocks, d_hidden {cfg.d_hidden}, {cfg.mlp_layers}-layer MLPs, "
          f"{cfg.param_count()} parameters")

    # 1-2. the Jet partition on the card, and the device layout it plans
    k = 8
    pcfg = PartitionConfig(k=k, lam=0.05, backend="ell")
    res, launches, _ = _run(g, pcfg)
    parts = res.parts.cpu().numpy()[:n]
    sizes = np.bincount(parts, minlength=k)
    if not res.balanced or sizes.max() > int(1.05 * n / k) or \
            launches.get("jet_gain", 0) == 0:
        raise AssertionError(f"(r) partition: balanced {res.balanced}, "
                             f"sizes {sizes.tolist()}, launches {launches}")
    plan, naive = pa.plan_from_partition(g, res.parts, k), pa.naive_plan(g, k)
    print(f"(r) partition() k={k} lam=0.05 ell on the card: cut {res.cut}, "
          f"imbalance {res.imbalance:.6f}, {res.times['total_s']:.3f} s, "
          f"jet_gain {launches['jet_gain']} launches")
    for name, p in (("naive", naive), ("jet", plan)):
        cb = pa.comm_bytes_per_layer(p, cfg.d_hidden)
        print(f"(r) {name} plan: local edges {p.local_edge_frac:.4f}, halo "
              f"{p.halo_fraction:.4f}, per layer at d {cfg.d_hidden}: "
              f"all-gather {cb['naive_allgather']} B, halo "
              f"{cb['partition_halo']} B ({cb['reduction']:.1f}x)")

    # 3. the batch in the plan's device-block order
    perm = torch.from_numpy(plan.perm).to(dev)
    e_new = torch.from_numpy(plan.edges_new.astype(np.int32)).to(dev)
    batch = {"graph": common.with_plan(graph._replace(
        node_feat=graph.node_feat[perm], pos=graph.pos[perm],
        senders=e_new[:, 0].contiguous(), receivers=e_new[:, 1].contiguous(),
        graph_id=graph.graph_id[perm], plan=None)),
        "target": data["target"][perm]}
    params = meshgraphnet.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))

    def loss_fn(p, b):
        return meshgraphnet.loss_fn(cfg, p, b)

    with torch.no_grad():
        l_input = float(loss_fn(params, data)[0])
        l_jet = float(loss_fn(params, batch)[0])
    del data, graph
    if not _close(l_jet, l_input, GNN_LOSS_RTOL):
        raise AssertionError(f"(r) loss on the reordered mesh {l_jet} != "
                             f"input order {l_input}")
    print(f"(r) loss in the Jet order {l_jet:.9g} == input order "
          f"{l_input:.9g} within {GNN_LOSS_RTOL}")

    # step 1 on both paths: loss and gradients; twice on the kernel path
    (l_k, _), g_k = loop.value_and_grad(loss_fn, params, batch)
    with plain_segment_sums():
        (l_p, _), g_p = loop.value_and_grad(loss_fn, params, batch)
    grad_l2 = _rel_l2(g_k, g_p)
    del g_k, g_p
    if not (_close(float(l_k), float(l_p), GNN_LOSS_RTOL)
            and grad_l2 <= GNN_GRAD_RL2):
        raise AssertionError(f"(r) step 1: loss {float(l_k)} vs plain "
                             f"{float(l_p)}, gradients' relative L2 "
                             f"{grad_l2:.3g}")
    opt_cfg = adamw.AdamWConfig()
    step = loop.build_train_step(loss_fn, opt_cfg)
    zero = torch.zeros((), device=dev)
    opt0 = adamw.init_state(params)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    first = step(params, opt0, zero, batch)
    torch.cuda.synchronize()
    per_step = kernels.launch_counts["segment_reduce"]
    again = step(params, opt0, zero, batch)
    want = gnn_segment_sums("meshgraphnet", cfg)
    if per_step != want or per_step == 0:
        raise AssertionError(f"(r) segment_reduce launches per step "
                             f"{per_step} != {want}")
    if not (_bitwise(first[0], again[0]) and _bitwise(first[1], again[1])
            and _equal(first[3]["loss"], again[3]["loss"])):
        raise AssertionError("(r) two runs of step 1 differ")
    del first, again
    print(f"(r) step 1: loss {float(l_k):.9g}, plain path {float(l_p):.9g}; "
          f"gradients' relative L2 to plain {grad_l2:.3g} (gate "
          f"{GNN_GRAD_RL2}); segment_reduce {per_step} launches a step "
          f"(= 4 x {cfg.n_layers}: forward, recompute, 2 gather backwards); "
          "two runs of the step equal bit for bit")

    # 4. five AdamW steps through the loop on the kernel path, two plain
    def recording(losses):
        def run_step(*a):
            out = step(*a)
            losses.append(float(out[3]["loss"]))
            times.append(time.perf_counter())
            return out
        return run_step

    def stream():
        while True:
            yield batch

    times, kernel_losses, plain_losses = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        times.append(t1)
        loop.run(loop.TrainLoopConfig(total_steps=5, ckpt_every=5,
                                      ckpt_dir=d, resume=False),
                 loop.TrainState(params, opt0, 0), recording(kernel_losses),
                 stream(), log=lambda *a: None)
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip(times, times[1:])]
    with tempfile.TemporaryDirectory() as d, plain_segment_sums():
        loop.run(loop.TrainLoopConfig(total_steps=2, ckpt_every=5,
                                      ckpt_dir=d, resume=False),
                 loop.TrainState(params, opt0, 0), recording(plain_losses),
                 stream(), log=lambda *a: None)
    if not all(_close(a, b, GNN_LOSS_RTOL)
               for a, b in zip(kernel_losses, plain_losses)) or \
            not all(np.isfinite(kernel_losses)):
        raise AssertionError(f"(r) losses {kernel_losses} vs plain "
                             f"{plain_losses}")
    total = torch.cuda.get_device_properties(0).total_memory
    fwd = _mgn_forward_flops(cfg, n, e)
    best = min(step_s[1:])
    print(f"(r) 5 AdamW steps through loop.run: losses {kernel_losses}; "
          f"plain path {plain_losses} (within {GNN_LOSS_RTOL})")
    print(f"(r) step time {best:.4f} s (steps 2-5: "
          f"{', '.join(f'{t:.4f}' for t in step_s[1:])}; step 1 "
          f"{step_s[0]:.4f}); {4 * fwd / best / 1e12:.2f} TFLOP/s of "
          f"{4 * fwd / 1e12:.2f} TFLOP a step (forward {fwd / 1e12:.3f} x 4: "
          f"recompute, backward); peak memory {peak} B "
          f"({peak / total:.3f} of the card)")
    # the step holds every block's input (h, e) for the backward pass and
    # recomputes one block at a time: 15 x 937,427,968 B saved plus one
    # block's activations and gradients, 20-30 GB by the shapes
    if not 20e9 <= peak <= 30e9:
        raise AssertionError(f"(r) peak memory {peak} B is outside the "
                             "20-30 GB that the checkpointed step needs")

    # the step under the profiler: idle share, top operations, and no
    # PyTorch scatter-add kernel
    keys: list = []
    groups = phase_profile("(r)", lambda: step(params, opt0, zero, batch),
                           best, "train step", GNN_GROUPS, keys=keys)
    bad = sorted({k_ for k_ in keys
                  if any(w in k_.lower() for w in SCATTER_NAMES)})
    if bad:
        raise AssertionError(f"(r) the kernel path's step ran {bad[:5]}")
    print(f"(r) no index_add / scatter_add / index_put operation or kernel "
          f"in the step's {len(keys)} profiled names")

    # segment_reduce at the step's shape: the edge latents (E, 128) by the
    # sorted receivers into N rows
    rcv = batch["graph"].plan.receivers
    data_e = torch.randn(e, cfg.d_hidden, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    data_e = data_e.index_select(0, rcv.order)
    got = ops.segment_sum_sorted(data_e, rcv.ids, n)
    want_ = segment_sum_sorted_ref(data_e, rcv.ids, n)
    ratio = tp.segment_error_ratio(got, want_, data_e, rcv.ids, n)
    if not ratio <= 1:
        raise AssertionError(f"(r) segment_reduce at the step's shape: "
                             f"{ratio:.3f} of its tolerance")
    err = float((got - want_).abs().max())
    ms = _time_ms(lambda: ops.segment_sum_sorted(data_e, rcv.ids, n), 20)
    plain_ms = _time_ms(lambda: segment_sum_sorted_ref(data_e, rcv.ids, n), 5)
    idx = rcv.ids.long()
    library_ms = _time_ms(lambda: torch.zeros(
        n, cfg.d_hidden, device=dev).index_add_(0, idx, data_e), 20)
    nbytes = ops.segment_reduce_cost(data_e, rcv.ids, n)["bytes"]
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"(r) segment_reduce at M={e}, F={cfg.d_hidden}, S={n}: {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, zeros + index_add_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes); "
          f"{ratio:.4f} of the float32 tolerance")
    dev_ms = groups.get("segment_reduce")
    print("(r) segment_reduce device time per step: " + (
        "not measured" if dev_ms is None else f"{dev_ms:.2f} ms in "
        f"{groups['segment_reduce calls']} kernels (3 a launch)"))
    return {
        "launches": per_step, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms,
        "shape": {"M": e, "F": cfg.d_hidden, "S": n, "dtype": "float32"},
        "device_ms_per_step": groups.get("segment_reduce"),
        "step_s": best, "peak_bytes": peak,
    }


def _mgn_forward_flops(cfg, n: int, e: int) -> int:
    """The forward pass's matrix-product flops: the encoders, each block's
    edge MLP over E rows and node MLP over N rows, the decoder."""
    from repro_torch.models.gnn.meshgraphnet import _mlp_dims

    def mlp(rows, d_in, d_out=None):
        dims = _mlp_dims(cfg, d_in, d_out)
        return 2 * rows * sum(a * b for a, b in zip(dims, dims[1:]))

    block = mlp(e, 3 * cfg.d_hidden) + mlp(n, 2 * cfg.d_hidden)
    return (cfg.n_layers * block + mlp(n, cfg.d_in) + mlp(e, cfg.d_edge_in)
            + mlp(n, cfg.d_hidden, cfg.d_out))


def _train_both_paths(tag, loss_fn, params, batch, steps_n: int):
    """Step 1 twice on the kernel path (bitwise equal), then ``steps_n``
    AdamW steps on the kernel path (segment_reduce launches counted per
    step) and on the plain path, from the same parameters: (kernel losses,
    plain losses, launches per step)."""
    import torch

    from repro_torch import kernels
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    step = loop.build_train_step(loss_fn, adamw.AdamWConfig())
    zero = torch.zeros((), device=batch["graph"].node_feat.device)
    first, again = (step(params, adamw.init_state(params), zero, batch)
                    for _ in range(2))
    if not (_bitwise(first[:2], again[:2])
            and _equal(first[3]["loss"], again[3]["loss"])):
        raise AssertionError(f"{tag} two runs of step 1 differ")
    del first, again

    def run(n_steps):
        p, o, losses, counts = params, adamw.init_state(params), [], []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            p, o, _, m = step(p, o, zero, batch)
            torch.cuda.synchronize()
            counts.append(kernels.launch_counts["segment_reduce"])
            losses.append(float(m["loss"]))
        return losses, counts

    kl, counts = run(steps_n)
    with plain_segment_sums():
        pl, _ = run(steps_n)
    if not all(_close(a, b, GNN_LOSS_RTOL) for a, b in zip(kl, pl)) or \
            not all(np.isfinite(kl)):
        raise AssertionError(f"{tag} losses {kl} vs plain {pl}")
    return kl, pl, counts


def phase_gnn_archs(tp, dev):
    """(s) GraphSAGE-Reddit, SchNet and NequIP at their published configs
    on the repo's shapes; train.main, resume and the smoke configs."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data import graphs as gen
    from repro_torch.data import synthetic
    from repro_torch.launch import steps, train
    from repro_torch.models.gnn import graphsage, nequip, schnet
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    launches = {}
    # GraphSAGE-Reddit on minibatch_lg: a Reddit-sized planted-partition
    # graph, sampled with the fanouts (15, 10) around 1024 seeds
    arch = get_arch("graphsage-reddit")
    shape = arch.shapes["minibatch_lg"]
    cfg = dataclasses.replace(arch.config, d_in=shape["d_feat"])
    t0 = time.perf_counter()
    edges, labels = gen.planted_partition(shape["full_nodes"], cfg.n_classes,
                                          50, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((shape["full_nodes"], shape["d_feat"]),
                                dtype=np.float32)
    sampler = synthetic.NeighborSampler(edges, shape["full_nodes"],
                                        shape["fanout"], seed=0)
    seeds = rng.choice(shape["full_nodes"], shape["batch_nodes"],
                       replace=False)
    sage_batch = sampler.sample(seeds, feats, labels, shape["pad_nodes"],
                                shape["pad_edges"], device=dev)
    sg = sage_batch["graph"]
    n_nodes = int((sg.node_feat.abs().sum(1) > 0).sum())
    n_edges = int((sg.senders < shape["pad_nodes"]).sum())
    print(f"(s) graphsage-reddit: planted_partition({shape['full_nodes']}, "
          f"{cfg.n_classes} blocks, degree 50) with {edges.shape[0]} "
          f"directed edges, sampled with fanouts {shape['fanout']} around "
          f"{shape['batch_nodes']} seeds: {n_nodes} of {shape['pad_nodes']} "
          f"pad nodes, {n_edges} of {shape['pad_edges']} pad edges (in "
          f"{time.perf_counter() - t0:.1f} s)")
    del edges, feats, sampler
    cases = [("graphsage-reddit", graphsage, cfg, sage_batch)]
    for arch_id, mod in (("schnet", schnet), ("nequip", nequip)):
        mol = get_arch(arch_id).shapes["molecule"]
        cases.append((arch_id, mod, get_arch(arch_id).config,
                      synthetic.molecule_batch(
                          mol["n_graphs"], atoms=mol["atoms"],
                          edges_per_graph=mol["n_edges"] // mol["n_graphs"],
                          seed=0, device=dev)))
    for arch_id, mod, cfg, batch in cases:
        params = mod.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
        kl, pl, counts = _train_both_paths(
            "(s) " + arch_id, lambda p, b, c=cfg, m=mod: m.loss_fn(c, p, b),
            params, batch, 3)
        want = gnn_segment_sums(arch_id, cfg)
        if any(c != want for c in counts) or want == 0:
            raise AssertionError(f"(s) {arch_id}: segment_reduce launches "
                                 f"{counts} != {want} a step")
        launches[arch_id] = want
        print(f"(s) {arch_id} ({cfg.param_count()} parameters): 3 AdamW "
              f"steps, losses {kl}, plain path {pl} (within "
              f"{GNN_LOSS_RTOL}); segment_reduce {want} launches a step; "
              "step 1 bitwise equal across two runs")
        if arch_id == "nequip":
            qm, _ = np.linalg.qr(np.random.default_rng(7).standard_normal(
                (3, 3)))
            if np.linalg.det(qm) < 0:
                qm[:, 0] *= -1
            g_ = batch["graph"]
            with torch.no_grad():
                e0 = nequip.forward(cfg, params, g_)
                e1 = nequip.forward(cfg, params, g_._replace(
                    pos=g_.pos @ torch.from_numpy(qm.astype(np.float32)).to(
                        dev) + 1.5))
            rel = float(((e1 - e0).abs() / e0.abs()).max())
            if not torch.allclose(e1, e0, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"(s) nequip rotation: {rel}")
            print(f"(s) nequip energies of {e0.numel()} molecules under a "
                  f"rotation and a translation: within rtol = atol = 1e-4 "
                  f"(max relative change {rel:.3g})")
    # a run killed at step 2 and resumed equals one that was not (SchNet)
    arch_id, mod, cfg, batch = cases[1]
    params = mod.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    step = loop.build_train_step(lambda p, b: mod.loss_fn(cfg, p, b),
                                 adamw.AdamWConfig())

    def stream():
        while True:
            yield batch

    def state():
        return loop.TrainState(params, adamw.init_state(params), 0)

    with tempfile.TemporaryDirectory() as d:
        quiet = lambda *a: None  # noqa: E731
        whole = loop.run(loop.TrainLoopConfig(
            total_steps=4, ckpt_every=2, ckpt_dir=f"{d}/a", resume=False),
            state(), step, stream(), log=quiet)
        try:
            loop.run(loop.TrainLoopConfig(total_steps=4, ckpt_every=2,
                                          ckpt_dir=f"{d}/b", fail_at_step=2),
                     state(), step, stream(), log=quiet)
            raise AssertionError("(s) the injected failure did not fire")
        except loop.SimulatedFailure:
            pass
        resumed = loop.run(loop.TrainLoopConfig(
            total_steps=4, ckpt_every=2, ckpt_dir=f"{d}/b"), state(), step,
            stream(), log=quiet)
        if not _bitwise({"p": whole.params, "o": whole.opt_state},
                        {"p": resumed.params, "o": resumed.opt_state}):
            raise AssertionError("(s) resumed run differs from the whole one")
        print("(s) schnet: a run killed by fail_at_step=2 and resumed from "
              "its step-2 checkpoint ends bit for bit equal to a whole run")
        # the CLI on the card
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = train.main(["--arch", "meshgraphnet", "--steps", "4",
                             "--ckpt-every", "2", "--ckpt-dir", f"{d}/cli"])
        if rc != 0 or "[train] finished at step 4" not in out.getvalue():
            raise AssertionError(f"(s) train.main: {rc} {out.getvalue()}")
        print("(s) launch/train.main --arch meshgraphnet --steps 4 on the "
              "card: finished at step 4")
    # each smoke config on the card against the CPU
    worst = 0.0
    for arch_id in tp.GNN_ARCHS:
        arch = get_arch(arch_id)
        cfg = arch.smoke
        b_np = tp.gnn_batch(arch_id, cfg, seed=0)
        params = steps.GNN_MODULES[arch_id].init_params(
            cfg, torch.Generator().manual_seed(0))
        loss = steps.gnn_loss(arch_id, cfg, 3)
        out = []
        for device in ("cpu", dev):
            b = steps.with_edge_plan({k: torch.from_numpy(v).to(device)
                                      for k, v in b_np.items()}, 3)
            p = tree.tree_map(lambda x: x.to(device), params)
            (lv, _), g_ = loop.value_and_grad(loss, p, b)
            out.append((float(lv), tree.tree_map(lambda x: x.cpu(), g_)))
        (l_cpu, g_cpu), (l_card, g_card) = out
        rl2 = _rel_l2(g_card, g_cpu)
        worst = max(worst, abs(l_card - l_cpu) / max(abs(l_cpu), 1.0), rl2)
        if not (abs(l_card - l_cpu) <= 2e-4 * max(abs(l_cpu), 1.0)
                and rl2 <= 2e-4):
            raise AssertionError(f"(s) {arch_id} smoke: card loss {l_card} "
                                 f"vs CPU {l_cpu}, gradients {rl2}")
    print(f"(s) the four smoke configs: card loss and gradients == CPU "
          f"within 2e-4 (worst {worst:.3g})")
    return launches


# ---------------------------------------------------------------------------
# LM and FM training: the backward kernels, FM and Gemma-3 1B at full width
# ---------------------------------------------------------------------------

# kernels that would add a gradient's rows with atomics: the embedding
# tables' gradients must come from segment_reduce instead (CE's one-hot
# ``gather`` backward, a scatter of one element a row, is order-free)
INDEX_ADD_NAMES = ("index_add", "index_put", "indexing_backward",
                   "embedding_dense_backward")
SEGMENT_KERNELS = ("splits_pass", "tiles_pass", "carry_pass")
LM_TRAIN_GROUPS = (("flash_attention", ("flash_kernel",)),
                   ("flash_attention backward", ("dkdv_tc", "dq_tc",
                                                 "dkdv_kernel", "dq_kernel",
                                                 "delta_kernel")),
                   ("segment_reduce", SEGMENT_KERNELS),
                   ("matrix product", ("gemm", "gemv", "cutlass", "nvjet",
                                       "xmma")))
FM_TRAIN_GROUPS = (("fm_interaction", ("fm_kernel",)),
                   ("fm_interaction backward", ("fm_bwd_kernel",)),
                   ("segment_reduce", SEGMENT_KERNELS),
                   ("row gathers (index_select)", ("gather_kernel",
                                                   "indexselect")),
                   ("sort", ("sort",)))
FLASH_BWD_WIDTHS = ((16, 16), (36, 8), (64, 64), (128, 128), (192, 128),
                    (256, 256))


def _grad_rel(got, want) -> float:
    """The largest relative L2 distance of dq, dk and dv."""
    return max(_rel_l2(g.float(), w.float()) for g, w in zip(got, want))


def _kernel_ms(call, names, reps: int = 20) -> dict:
    """Each named kernel's mean device time (ms) over the launches that
    torch.profiler saw in ``reps`` calls of ``call`` (late in a long run it
    may miss the first few); empty if it saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key and e.count:
                out[name] = out.get(name, 0.0) + \
                    e.self_device_time_total / 1e3 / e.count
    return out


def _flash_bwd_at_shape(dev, window: int, b=8, h=4, hkv=1, s=4096, d=256,
                        dv=256):
    """The backward kernel, its plain version and SDPA's backward at one
    causal bfloat16 layer; the default is Gemma-3 1B's training layer
    (B=8, H=4, Hkv=1, S=4096, D=Dv=256)."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(window + 1)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for shape in (
                       (b, h, s, d), (b, hkv, s, d), (b, hkv, s, dv),
                       (b, h, s, dv)))
    o, lse = ops._flash_attention_cuda(q, k, v, True, window, 0,
                                       with_lse=True)
    o_ref, lse_ref = flash_attention_ref(q, k, v, True, window,
                                         return_lse=True)
    before = ops.bwd_launches["flash_attention_bwd_tc"]
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, True, window)
    if ops.bwd_launches["flash_attention_bwd_tc"] != before + 1:
        raise AssertionError("(t) the bfloat16 backward did not take the "
                             "tensor cores' kernels")
    want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, True, window)
    # the library yardstick: PyTorch's fused attention and its backward
    lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = sdpa_attention(lq, lk, lv, True, window, 0)
    lib = torch.autograd.grad(out, (lq, lk, lv), do, retain_graph=True)
    rel, lib_rel = _grad_rel(got, want), _grad_rel(lib, want)
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(got, want))
    del want, lib, o_ref, lse_ref
    ms = _time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, True,
                                                  window), 3)
    plain_ms = _time_ms(lambda: flash_attention_bwd_ref(
        q, k, v, o, lse, do, True, window), 2)
    library_ms = _time_ms(lambda: torch.autograd.grad(
        out, (lq, lk, lv), do, retain_graph=True), 3)
    split = _kernel_ms(lambda: ops.flash_attention_bwd(
        q, k, v, o, lse, do, True, window), ("delta_kernel", "dkdv_tc",
                                             "dq_tc"))
    # q, k, v, o, do in and dq, dk, dv out (2 bytes each), lse in (4); the
    # gradient's products: S = q k^T (2 D), dP = do v^T (2 Dv), dV = P^T do
    # (2 Dv), dQ = dS k (2 D), dK = dS^T q (2 D) a visible pair
    cost = ops.flash_attention_bwd_cost(q, k, v, o, lse, do, True, window)
    nbytes, flops = cost["bytes"], cost["flops"]
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bytes": nbytes, "flops": flops,
            "max_abs_err": err, "rel_l2": rel, "library_rel_l2": lib_rel,
            "source": "flash_attention_bwd_tc", "kernel_ms": split,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / BF16_FLOPS_PER_S else "operations"}


def phase_train_kernels(tp, dev):
    """(t) the two backward kernels against their plain versions, and the
    flash forward with its log-sum-exp against the forward without it."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.kernels.fm_interaction import ops as fm_ops
    from repro_torch.kernels.fm_interaction.ref import fm_interaction_bwd_ref

    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    # fm_interaction's backward: float32 within 1e-6 relative L2, 16-bit
    # within one step of the output's rounding; bitwise across launches
    t_fm = time.perf_counter()
    n_fm, worst_fm = 0, {}
    for d in (1, 8, 10, fm_ops.MAX_DIM):
        for f in (0, 1, 39):
            for b in ((1, 257, 65536) if d <= 10 else (1, 3)):
                gen = torch.Generator(device=dev).manual_seed(b * 64 + f + d)
                e32 = torch.randn(b, f, d, generator=gen, device=dev)
                g = torch.randn(b, generator=gen, device=dev)
                for dtype in dtypes:
                    e = e32.to(dtype)
                    got = fm_ops.fm_interaction_bwd(e, g)
                    again = fm_ops.fm_interaction_bwd(e, g)
                    want = fm_interaction_bwd_ref(e, g)
                    torch.cuda.synchronize()
                    where = f"(t) fm_interaction backward B={b} F={f} D={d} "\
                        f"{dtype}"
                    if not _equal(got, again) or got.shape != e.shape:
                        raise AssertionError(f"{where}: two launches differ")
                    if got.numel() == 0 or not bool(want.any()):
                        # F = 1: every gradient is s - e = 0 exactly
                        ratio = 0.0 if torch.equal(got, want) else np.inf
                    elif dtype == torch.float32:
                        ratio = _rel_l2(got, want) / 1e-6
                    else:
                        w = want.float()
                        step = torch.finfo(dtype).eps * w.abs() + \
                            torch.finfo(dtype).tiny
                        ratio = float(((got.float() - w).abs() / step).max())
                    if not ratio <= 1:
                        raise AssertionError(f"{where}: {ratio:.3f} of its "
                                             "tolerance")
                    worst_fm[dtype] = max(worst_fm.get(dtype, 0.0), ratio)
                    n_fm += 1
    gen = torch.Generator(device=dev).manual_seed(7)
    e = torch.randn(4099, 40, 24, generator=gen, device=dev)[:, 1:, ::2]
    g = torch.randn(4099, generator=gen, device=dev)
    got = _one_launch("fm_interaction_bwd", fm_ops.fm_interaction_bwd, e, g)
    rel = _rel_l2(got, fm_interaction_bwd_ref(e.contiguous(), g))
    if e.is_contiguous() or not rel <= 1e-6:
        raise AssertionError(f"(t) fm_interaction backward on a strided "
                             f"view: relative L2 {rel:.3g}")
    # contiguous views whose base is 4 (2) bytes past 16-byte alignment:
    # the staged copies' unaligned heads and tails
    unaligned = []
    for dtype in dtypes:
        flat = torch.randn(257 * 39 * 10 + 1, generator=gen,
                           device=dev).to(dtype)
        e = flat[1:].view(257, 39, 10)
        got = _one_launch("fm_interaction_bwd", fm_ops.fm_interaction_bwd, e,
                          g[:257])
        want = fm_interaction_bwd_ref(e, g[:257])
        ok = e.data_ptr() % 16 != 0 and (
            _rel_l2(got, want) <= 1e-6 if dtype == torch.float32 else bool(
                ((got.float() - want.float()).abs()
                 <= torch.finfo(dtype).eps * want.float().abs()
                 + torch.finfo(dtype).tiny).all()))
        if not ok:
            raise AssertionError(f"(t) fm_interaction backward on an "
                                 f"unaligned {dtype} view")
        unaligned.append(str(dtype)[6:])
    print(f"(t) fm_interaction backward == plain on {n_fm} panels (D in "
          f"{{1, 8, 10, {fm_ops.MAX_DIM}}}, F in {{0, 1, 39}}, B up to "
          "65,536): worst " + ", ".join(
              f"{str(k_)[6:]} {v_:.4f}" for k_, v_ in worst_fm.items())
          + " of the tolerance (float32 1e-6 relative L2, 16-bit one "
          f"rounding step); bitwise equal across launches; a strided view "
          f"at {rel:.3g}; unaligned views ({', '.join(unaligned)}) within "
          "the tolerance")

    # flash_attention: the forward with lse bitwise equal to the forward
    # without; the backward kernel within 1e-4 relative L2 (float32) or
    # max(2e-2, 2 x SDPA's backward) (16-bit) of plain, bitwise repeatable
    # (16-bit: 2e-2, the floor of the gate max(2e-2, 2 x SDPA's distance);
    # SDPA's backward is run at the three timed layers below, as one call
    # per case would build a library plan for each of the 126 cases)
    t_fm = time.perf_counter() - t_fm
    t_fa = time.perf_counter()
    n_fa, worst_fa, sources = 0, {}, {}
    for shape in tp.FLASH_SHAPES:
        h, hkv, sq, skv, causal, window, off = shape
        for d, dv in FLASH_BWD_WIDTHS:
            for dtype in dtypes:
                q, k, v = tp.qkv(2, h, hkv, sq, skv, d, dtype,
                                 seed=sq * skv + d + dv, device=dev, dv=dv)
                do = torch.randn(2, h, sq, dv, device=dev,
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(d)).to(dtype)
                where = f"(t) flash_attention backward {shape} D={d} " \
                    f"Dv={dv} {dtype}"
                o0 = fa_ops._flash_attention_cuda(q, k, v, causal, window,
                                                  off)
                o, lse = fa_ops._flash_attention_cuda(q, k, v, causal, window,
                                                      off, with_lse=True)
                o_ref, lse_ref = flash_attention_ref(q, k, v, causal, window,
                                                     off, return_lse=True)
                before = dict(fa_ops.bwd_launches)
                got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                                 window, off)
                took = [r for r, n in fa_ops.bwd_launches.items()
                        if n != before.get(r, 0)]
                if took != [fa_ops.BWD_SOURCES[dtype]]:
                    raise AssertionError(f"{where}: took {took}")
                sources[str(dtype)[6:]] = took[0]
                again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal, window, off)
                want = flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                               causal, window, off)
                torch.cuda.synchronize()
                if not _equal(o0, o):
                    raise AssertionError(f"{where}: the forward's output "
                                         "moves when it writes lse")
                fin = torch.isfinite(lse_ref)
                if not torch.equal(fin, torch.isfinite(lse)) or not bool(
                        torch.allclose(lse[fin], lse_ref[fin], rtol=1e-5,
                                       atol=1e-5)):
                    raise AssertionError(f"{where}: lse differs from plain")
                if not _bitwise(got, again):
                    raise AssertionError(f"{where}: two launches differ")
                if not bool((got[0][~fin] == 0).all()):
                    raise AssertionError(f"{where}: dq of a row that sees "
                                         "no key is not 0")
                rel = _grad_rel(got, want)
                tol = 1e-4 if dtype == torch.float32 else 2e-2
                if not rel <= tol:
                    raise AssertionError(f"{where}: relative L2 {rel:.3g} > "
                                         f"{tol:.3g}")
                worst_fa[dtype] = max(worst_fa.get(dtype, 0.0), rel)
                n_fa += 1
    print(f"(t) flash_attention backward == plain on {n_fa} cases (groups 1 "
          f"and 4, (D, Dv) in {FLASH_BWD_WIDTHS}, causal and not, windows "
          "16/512, offsets, ragged tiles, rows that see no key: dq = 0): "
          "worst relative L2 " + ", ".join(
              f"{str(k_)[6:]} {v_:.3g}" for k_, v_ in worst_fa.items())
          + " (float32 <= 1e-4, 16-bit <= 2e-2); bitwise equal across "
          "launches; the forward's output bitwise equal with and without "
          "lse; kernels " + ", ".join(f"{k_} {v_}" for k_, v_ in
                                       sources.items()))

    # times at Gemma-3 1B's training layers (B = 8) and the MLA layer
    t_fa = time.perf_counter() - t_fa
    t_at = time.perf_counter()
    at = {"global": _flash_bwd_at_shape(dev, 0),
          "local": _flash_bwd_at_shape(dev, 512),
          "mla_layer": _flash_bwd_at_shape(dev, 0, b=4, h=16, hkv=16, d=192,
                                           dv=128)}
    print(f"(t) fm_interaction cases {t_fm:.1f} s, flash cases {t_fa:.1f} "
          f"s, the three timed layers {time.perf_counter() - t_at:.1f} s")
    for name, r in at.items():
        if not r["rel_l2"] <= max(2e-2, 2 * r["library_rel_l2"]):
            raise AssertionError(f"(t) flash backward at the {name} layer: "
                                 f"relative L2 {r['rel_l2']:.3g}")
        print(f"(t) flash_attention backward at the {name} layer "
              f"({r['source']}): "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA's "
              f"backward {r['library_ms']:.4f} ms (kernel/SDPA "
              f"{r['ms'] / r['library_ms']:.2f}), bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}: {r['flops'] / 1e9:.2f} GFLOP, "
              f"{r['bytes']} B); relative L2 to plain {r['rel_l2']:.3g} "
              f"(SDPA {r['library_rel_l2']:.3g}); device ms a launch by "
              "kernel: " + (", ".join(f"{k_} {v_:.4f}" for k_, v_ in
                                       r["kernel_ms"].items())
                            or "not measured"))
    return at


def _profile_names(keys, names) -> list:
    return sorted({k_ for k_ in keys if any(w in k_.lower() for w in names)})


def _recording_steps(step, step_s: list, losses: list):
    """A loop step (params, opt_state, err, batch) around ``step`` (a cell's
    step_fn) that records each step's time (host clock, ending in a device
    sync; the loop's batch making and checkpoints fall outside) and loss."""
    import torch

    def run(params, opt_state, err, batch):
        t1 = time.perf_counter()
        p, o, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(m["loss"]))
        return p, o, err, m
    return run


def phase_fm_training(tp, dev):
    """(u) FM training at its published config (39 fields, D = 10, 262,144
    rows per field) on train_batch (B = 65,536): the FM training path."""
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels.fm_interaction import ops as fm_ops
    from repro_torch.kernels.fm_interaction.ref import fm_interaction_bwd_ref
    from repro_torch.launch import steps
    from repro_torch.models.recsys import fm
    from repro_torch.train import loop

    arch = get_arch("fm")
    cfg = arch.config
    cell = steps.build_cell(arch, "train_batch", dev)
    params, opt0, batch = cell.args
    b = batch["ids"].shape[0]

    def loss(p, bb):
        return fm.loss_fn(cfg, p, bb)

    (l_k, _), g_k = loop.value_and_grad(loss, params, batch)  # warm-up
    ((l_k, _), g_k), launches = _counted(loop.value_and_grad, loss, params,
                                         batch)
    want = {"fm_interaction": 1, "fm_interaction_bwd": 1,
            "segment_reduce": EMBED_SEGMENT_SUMS["recsys"]}
    if {k_: launches.get(k_, 0) for k_ in want} != want:
        raise AssertionError(f"(u) launches {launches} != {want} a step")
    with plain_versions(), plain_segment_sums():
        ((l_p, _), g_p), plain_launches = _counted(loop.value_and_grad, loss,
                                                   params, batch)
    if any(plain_launches.get(k_, 0) for k_ in want):
        raise AssertionError(f"(u) the plain path launched {plain_launches}")
    rel = _rel_l2(g_k, g_p)
    if not (_close(float(l_k), float(l_p), 1e-6) and rel <= 1e-5):
        raise AssertionError(f"(u) step 1: loss {float(l_k)} vs plain "
                             f"{float(l_p)}, gradients relative L2 {rel:.3g}")
    del g_p
    one, two = (cell.step_fn(params, opt0, batch) for _ in range(2))
    if not (_bitwise(one[:2], two[:2])
            and _equal(one[2]["loss"], two[2]["loss"])):
        raise AssertionError("(u) two runs of step 1 differ")
    del one, two
    print(f"(u) fm at its published config ({cfg.param_count()} "
          f"parameters), train_batch B={b}: step 1 loss {float(l_k):.9g}, "
          f"plain path {float(l_p):.9g}; gradients relative L2 {rel:.3g} "
          "(gates 1e-6, 1e-5); step 1 bit for bit across two runs; launches "
          f"a step {want}")

    # 5 AdamW steps through the loop on fresh click batches
    step_s, losses = [], []
    data = synthetic.recsys_batches(cfg.n_fields, cfg.rows_per_field, b,
                                    seed=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        loop.run(loop.TrainLoopConfig(total_steps=5, ckpt_every=5,
                                      ckpt_dir=d, resume=False),
                 loop.TrainState(params, opt0, 0),
                 _recording_steps(cell.step_fn, step_s, losses), data,
                 log=lambda *a: None)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(u) losses {losses}")
    best = min(step_s[1:])
    print(f"(u) 5 AdamW steps through loop.run: losses {losses}; step time "
          f"{best:.5f} s (steps 2-5: "
          f"{', '.join(f'{t:.5f}' for t in step_s[1:])}; step 1 "
          f"{step_s[0]:.5f}), {b / best:.6g} examples/s; peak memory "
          f"{peak} B")
    keys: list = []   # 3 steps: the profiler may miss a window's first
    groups = phase_profile("(u)", lambda: [cell.step_fn(params, opt0, batch)
                                           for _ in range(3)],
                           3 * best, "3 train steps", FM_TRAIN_GROUPS,
                           keys=keys)
    bad = _profile_names(keys, SCATTER_NAMES)
    if bad:
        raise AssertionError(f"(u) the kernel path's step ran {bad[:5]}")
    print(f"(u) no index_add / scatter_add / index_put operation or kernel "
          f"in the step's {len(keys)} profiled names")

    # the backward kernel at the step's shape
    flat = (batch["ids"].long() % cfg.rows_per_field) + torch.arange(
        cfg.n_fields, device=dev) * cfg.rows_per_field
    emb = params["table"][flat]
    g = torch.randn(b, device=dev, generator=torch.Generator(device=dev)
                    .manual_seed(3))
    got, want_ = fm_ops.fm_interaction_bwd(emb, g), \
        fm_interaction_bwd_ref(emb, g)
    err = float((got - want_).abs().max())
    ms = _time_ms(lambda: fm_ops.fm_interaction_bwd(emb, g), 50)
    plain_ms = _time_ms(lambda: fm_interaction_bwd_ref(emb, g), 10)
    cost = fm_ops.fm_interaction_bwd_cost(emb, g)  # e, g in; grad out
    nbytes, flops = cost["bytes"], cost["flops"]
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    print(f"(u) fm_interaction backward at train_batch (B={b}, "
          f"F={cfg.n_fields}, D={cfg.embed_dim}, float32): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes); no "
          "single PyTorch call computes it")
    calls = groups.get("fm_interaction backward calls", 0)
    dev_ms = groups["fm_interaction backward"] / calls if calls else None
    return {
        "name": "fm_interaction_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/fm_interaction/fm_interaction.cu",
        "replaces": "src/repro/kernels/fm_interaction/ref.py:12",
        "launches": launches["fm_interaction_bwd"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / F32_FLOPS_PER_S else "operations",
        "library_ms": None,
        "note": "no backward Pallas kernel: the reference differentiates "
                "fm_interaction_ref with XLA off the TPU",
        "check": "float32 within 1e-6 relative L2 of plain, 16-bit within "
                 "one rounding step (phase t); the FM step's gradients "
                 "within 1e-5 (phase u)",
        "shape": {"B": b, "F": cfg.n_fields, "D": cfg.embed_dim,
                  "dtype": "float32"},
        "device_ms_per_step": dev_ms, "step_s": best, "peak_bytes": peak,
        "launches_per_step": want,
    }


GEMMA_TRAIN_BATCH = 8        # train_4k's batch of 256 cut to one card's
GEMMA_PEAK_RANGE = (20e9, 45e9)  # (v)'s gate, from PERF.md's prediction


def phase_gemma_training(tp, dev):
    """(v) Gemma-3 1B training at full width and depth (26 layers, d 1152,
    bfloat16, remat) on train_4k's sequence of 4096, batch cut to 8: the LM
    training path."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop

    arch = get_arch("gemma3-1b")
    shape = dict(arch.shapes["train_4k"], batch=GEMMA_TRAIN_BATCH)
    arch = dataclasses.replace(arch, shapes=dict(arch.shapes, train_4k=shape))
    cfg = arch.config
    t0 = time.perf_counter()
    cell = steps.build_cell(arch, "train_4k", dev)
    params, opt0, batch = cell.args
    step_fn, cell = cell.step_fn, cell._replace(args=())
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree.leaves(params))
    if n_params != cfg.param_count() or not cfg.remat or \
            cell.meta["microbatches"] != 1:
        raise AssertionError(f"(v) {n_params} parameters (param_count "
                             f"{cfg.param_count()}), remat {cfg.remat}, "
                             f"microbatches {cell.meta['microbatches']}")
    tokens = shape["batch"] * shape["seq"]
    flops = cell.meta["model_flops"]
    print(f"(v) gemma3-1b: {n_params} parameters, remat, {shape['batch']} x "
          f"{shape['seq']} tokens a step ({flops:.4g} model flops, "
          f"microbatches {cell.meta['microbatches']}); cell made in "
          f"{time.perf_counter() - t0:.1f} s")

    def loss(p, bb):
        return tf.loss_fn(cfg, p, bb)

    ((l_k, _), g_k), launches = _counted(loop.value_and_grad, loss, params,
                                         batch)
    fwd_n, bwd_n = lm_flash_launches(cfg)
    want = {"flash_attention": fwd_n, "flash_attention_bwd": bwd_n,
            "segment_reduce": EMBED_SEGMENT_SUMS["lm"]}
    if {k_: launches.get(k_, 0) for k_ in want} != want:
        raise AssertionError(f"(v) launches {launches} != {want} a step")
    with plain_versions(), plain_segment_sums():
        ((l_p, _), g_p), plain_launches = _counted(loop.value_and_grad, loss,
                                                   params, batch)
    if any(plain_launches.get(k_, 0) for k_ in want):
        raise AssertionError(f"(v) the plain path launched {plain_launches}")
    rel = _rel_l2(g_k, g_p)
    del g_k
    with swapped(fa_ops, "flash_attention", sdpa_attention):
        (l_s, _), g_s = loop.value_and_grad(loss, params, batch)
    lib_rel = _rel_l2(g_s, g_p)
    del g_s, g_p
    if not (_close(float(l_k), float(l_p), 1e-3)
            and rel <= max(2e-2, 2 * lib_rel)):
        raise AssertionError(f"(v) step 1: loss {float(l_k)} vs plain "
                             f"{float(l_p)}, gradients relative L2 {rel:.3g} "
                             f"> max(2e-2, 2 x the SDPA path's {lib_rel:.3g})")
    print(f"(v) step 1: loss {float(l_k):.7g}, plain path {float(l_p):.7g}, "
          f"SDPA path {float(l_s):.7g}; gradients relative L2 to plain "
          f"{rel:.4g} (the SDPA path's {lib_rel:.4g}; gate max(2e-2, 2 x "
          f"that)); launches a step {want}")
    one, two = (step_fn(params, opt0, batch) for _ in range(2))
    if not (_bitwise(one[:2], two[:2])
            and _equal(one[2]["loss"], two[2]["loss"])):
        raise AssertionError("(v) two runs of step 1 differ")
    del one, two
    print("(v) step 1 (gradient and AdamW update) bit for bit across two "
          "runs")

    # 3 AdamW steps through the loop, a bfloat16 checkpoint at step 3; the
    # loop is handed the only reference to the state, so one copy of the
    # parameters and AdamW state lives, as in a training job
    step_s, losses = [], []
    data = synthetic.lm_batches(cfg.vocab, shape["batch"], shape["seq"],
                                seed=1, device=dev)
    start = [loop.TrainState(params, opt0, 0)]
    del params, opt0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        t_loop = time.perf_counter()
        final = loop.run(loop.TrainLoopConfig(total_steps=3, ckpt_every=3,
                                              ckpt_dir=d, resume=False),
                         start.pop(),
                         _recording_steps(step_fn, step_s, losses), data,
                         log=lambda *a: None)
        loop_s = time.perf_counter() - t_loop
        peak = torch.cuda.max_memory_allocated()
        # the bfloat16 parameters back from the checkpoint (its float32
        # AdamW state takes the path the GNN checkpoints of (s) exercise)
        t_ck = time.perf_counter()
        target = {"params": final.params}
        back = ckpt.restore(d, 3, target)
        restore_s = time.perf_counter() - t_ck
        dtype = ckpt.read_manifest(d, 3)["arrays"]["['params']/['embed']"][
            "dtype"]
        if dtype != "bfloat16" or not _bitwise(back, target):
            raise AssertionError(f"(v) the step-3 checkpoint ({dtype}) does "
                                 "not restore bit for bit")
    del back, target
    best = min(step_s)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(v) losses {losses}")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"(v) 3 AdamW steps through loop.run: losses {losses}; step time "
          f"{best:.4f} s (steps: {', '.join(f'{t:.4f}' for t in step_s)}), "
          f"{tokens / best:.6g} tokens/s, {flops / best / 1e12:.2f} TFLOP/s "
          f"of model flops; the loop with its step-3 checkpoint "
          f"{loop_s:.1f} s, the checkpoint's bfloat16 parameters restored "
          f"bit for bit in {restore_s:.1f} s; peak memory {peak} B "
          f"({peak / total:.3f} of the card)")
    lo, hi = GEMMA_PEAK_RANGE
    if not lo <= peak <= hi:
        raise AssertionError(f"(v) peak memory {peak} B outside "
                             f"{lo:.3g}-{hi:.3g}")
    keys: list = []
    groups = phase_profile("(v)", lambda: step_fn(
        final.params, final.opt_state, batch), best, "train step",
        LM_TRAIN_GROUPS, keys=keys)
    bwd_ms = groups.get("flash_attention backward")
    if bwd_ms is not None:
        print(f"(v) flash_attention's backward (tensor cores): {bwd_ms:.2f} "
              f"ms of device time a step, {bwd_ms / 1e3 / best:.4f} of the "
              f"{best:.4f} s step")
    bad = _profile_names(keys, INDEX_ADD_NAMES)
    if bad:
        raise AssertionError(f"(v) the kernel path's step ran {bad[:5]}")
    print(f"(v) no index_add / index_put / embedding backward operation or "
          f"kernel in the step's {len(keys)} profiled names (scatter_add: "
          f"{_profile_names(keys, ('scatter_add',))[:3]}, CE's one-hot "
          "gather backward)")
    return {"launches": want, "step_s": best, "peak_bytes": peak,
            "loss": float(l_k), "rel_l2": rel, "library_rel_l2": lib_rel,
            "device_ms_per_step": {k_: groups.get(k_) for k_ in (
                "flash_attention", "flash_attention backward",
                "segment_reduce")}}


SMOKE_TRAIN_ARCHS = ("gemma3-1b", "deepseek-v2-lite-16b",
                     "moonshot-v1-16b-a3b", "fm")


def phase_smoke_training(tp, dev):
    """(w) the LM and FM smoke configs' loss and gradients on the card
    against the CPU; launch/train.main --arch gemma3-1b and fm."""
    import tempfile

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import fm
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    worst, repeated = 0.0, []
    for arch_id in SMOKE_TRAIN_ARCHS:
        arch = get_arch(arch_id)
        cfg = arch.smoke
        gen = torch.Generator().manual_seed(0)
        if arch.family == "lm":
            params = tf.init_params(cfg, gen)
            if cfg.moe:
                _distinct_experts(cfg, params, gen)
            b = next(synthetic.lm_batches(cfg.vocab, 2, 64, seed=0))

            def loss(p, bb, cfg=cfg):
                return tf.loss_fn(cfg, p, bb)
        else:
            params = fm.init_params(cfg, gen)
            b = next(synthetic.recsys_batches(cfg.n_fields,
                                              cfg.rows_per_field, 64, seed=0))

            def loss(p, bb, cfg=cfg):
                return fm.loss_fn(cfg, p, bb)
        out = []
        for device in ("cpu", dev):
            p = tree.tree_map(lambda x: x.to(device), params)
            bb = {k_: v_.to(device) for k_, v_ in b.items()}
            (lv, _), g_ = loop.value_and_grad(loss, p, bb)
            out.append((float(lv), tree.tree_map(lambda x: x.cpu(), g_)))
        (l_cpu, g_cpu), (l_card, g_card) = out
        if arch.family == "lm" and cfg.moe:
            # the MoE dispatch's sums run on segment_reduce in a fixed
            # order: a step (gradient and AdamW update) repeats bit for bit
            step = steps.make_train_step(loss)
            (one, two), launches = _counted(lambda: [
                step(p, adamw.init_state(p), bb) for _ in range(2)])
            want = 2 * lm_segment_sums(cfg)
            if not (_bitwise(one[:2], two[:2])
                    and _equal(one[2]["loss"], two[2]["loss"])):
                raise AssertionError(f"(w) {arch_id} smoke: two runs of a "
                                     "MoE train step differ")
            if launches.get("segment_reduce", 0) != want:
                raise AssertionError(f"(w) {arch_id} smoke: segment_reduce "
                                     f"launches {launches} != {want}")
            repeated.append(arch_id)
        rl2 = _rel_l2(g_card, g_cpu)
        worst = max(worst, abs(l_card - l_cpu) / max(abs(l_cpu), 1.0), rl2)
        if not (abs(l_card - l_cpu) <= 2e-4 * max(abs(l_cpu), 1.0)
                and rl2 <= 2e-4):
            raise AssertionError(f"(w) {arch_id} smoke: card loss {l_card} "
                                 f"vs CPU {l_cpu}, gradients {rl2}")
    print(f"(w) the smoke configs of {', '.join(SMOKE_TRAIN_ARCHS)}: card "
          f"loss and gradients == CPU within 2e-4 (worst {worst:.3g}); two "
          "MoE train steps bit for bit equal on the card "
          f"({', '.join(repeated)}; segment_reduce launched lm_segment_sums "
          "times a step)")
    with tempfile.TemporaryDirectory() as d:
        for arch_id in ("gemma3-1b", "fm"):
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = train.main(["--arch", arch_id, "--steps", "4",
                                 "--ckpt-every", "2", "--ckpt-dir",
                                 f"{d}/{arch_id}"])
            if rc != 0 or "[train] finished at step 4" not in out.getvalue():
                raise AssertionError(f"(w) train.main --arch {arch_id}: {rc} "
                                     f"{out.getvalue()}")
            print(f"(w) launch/train.main --arch {arch_id} --steps 4 on the "
                  "card: finished at step 4")


PARTITIONED_RTOL = 1e-4  # (x): partitioned loss and grad_norm against dense
PARTITIONED_RANKS = 8
PARTITIONED_GROUPS = GNN_GROUPS + (("nccl", ("nccl",)),)


def phase_partitioned(tp, dev):
    """(x) partition-aware MeshGraphNet training (launch/gnn_partitioned.py)
    at full width on (r)'s mesh: world size 1 on NCCL against the dense
    path, then 8 ranks as 8 processes on the card over gloo."""
    import dataclasses
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.graph import build_csr_host
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.data import synthetic
    from repro_torch.dist import partition_aware as pa
    from repro_torch.launch import gnn_partitioned as gp
    from repro_torch.launch import steps
    from repro_torch.models.gnn import meshgraphnet
    from repro_torch.train import loop

    arch = get_arch("meshgraphnet")
    cfg = dataclasses.replace(arch.config, d_in=4)
    data = synthetic.mesh_batch(512, 512, seed=0)
    graph = data["graph"]
    n, e = graph.node_feat.shape[0], graph.senders.shape[0]
    edges = torch.stack([graph.senders, graph.receivers], 1).numpy()
    host = (graph.node_feat.numpy(), graph.pos.numpy(),
            data["target"].numpy())
    g = build_csr_host(n, edges)

    # the Jet partition on the card (jet_gain), counted from zero
    k = PARTITIONED_RANKS
    res, launches, _ = _run(g, PartitionConfig(k=k, lam=0.05, backend="ell"))
    parts = res.parts.cpu().numpy()[:n]
    if not res.balanced or launches.get("jet_gain", 0) == 0:
        raise AssertionError(f"(x) partition: balanced {res.balanced}, "
                             f"launches {launches}")
    print(f"(x) partition() k={k} lam=0.05 ell on the card: cut {res.cut}, "
          f"imbalance {res.imbalance:.6f}, jet_gain {launches['jet_gain']} "
          "launches")

    # (x1) world size 1 on NCCL: the layout of one rank (input order)
    t0 = time.perf_counter()
    batch1, stats1 = gp.build_partitioned_batch(
        n, *host, edges, np.zeros(n, np.int64), 1, steps._pad512(n),
        steps._pad512(e), 8)
    layout_s = time.perf_counter() - t0
    shape = {"kind": "train", "n_nodes": n, "n_edges": e, "d_feat": 4,
             "n_graphs": 1}
    arch_x = dataclasses.replace(arch, config=cfg, shapes={"mesh": shape})
    dense = {"graph": graph._replace(
        **{f: getattr(graph, f).to(dev) for f in (
            "node_feat", "senders", "receivers", "pos", "graph_id")},
        plan=None), "target": data["target"].to(dev)}
    gp.init_rank(0, 1, gp.free_port(), dev)
    try:
        cell = steps.build_cell(arch_x, "mesh", dev, tuning={
            "mode": "partitioned", "halo_frac": 0.0})
        params, opt0 = cell.args[:2]
        block = gp.with_local_plan(gp.rank_block(batch1, 0, 1, dev), 1)
        ex = gp.Exchange()
        loss_p, grads_p = gp.value_and_grad(cfg, params, block, ex)
        (loss_d, _), grads_d = loop.value_and_grad(
            lambda p, b: meshgraphnet.loss_fn(cfg, p, b), params, dense)
        grad_l2 = _rel_l2(grads_p, grads_d)
        del grads_p, grads_d, dense
        if not (_close(float(loss_p), float(loss_d), PARTITIONED_RTOL)
                and grad_l2 <= GNN_GRAD_RL2):
            raise AssertionError(f"(x1) loss {float(loss_p)} vs dense "
                                 f"{float(loss_d)}, gradients' relative L2 "
                                 f"{grad_l2:.3g}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        first = cell.step_fn(params, opt0, block)
        torch.cuda.synchronize()
        per_step = kernels.launch_counts["segment_reduce"]
        again = cell.step_fn(params, opt0, block)
        want = partitioned_segment_sums(cfg)
        if per_step != want:
            raise AssertionError(f"(x1) segment_reduce launches per step "
                                 f"{per_step} != {want}")
        if not (_bitwise(first[:2], again[:2])
                and _equal(first[2]["loss"], again[2]["loss"])):
            raise AssertionError("(x1) two runs of step 1 differ")
        x1_loss = float(first[2]["loss"])
        x1_gn = float(first[2]["grad_norm"])
        del again
        print(f"(x1) world size 1, backend {ex.backend}: layout built in "
              f"{layout_s:.2f} s (n_l {steps._pad512(n)}, e_cap "
              f"{steps._pad512(e)}, h_cap "
              f"{cell.meta['h_cap']}, dropped {stats1}); loss "
              f"{float(loss_p):.9g}, dense {float(loss_d):.9g} (gate "
              f"{PARTITIONED_RTOL}); gradients' relative L2 to dense "
              f"{grad_l2:.3g} (gate {GNN_GRAD_RL2}); segment_reduce "
              f"{per_step} launches a step (= 5 x {cfg.n_layers}); two runs "
              f"of step 1 equal bit for bit; grad_norm {x1_gn:.9g}")
        step_s = []
        p, o = first[:2]
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p, o, _ = cell.step_fn(p, o, block)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        best = min(step_s)
        print(f"(x1) step time {best:.4f} s (steps 2-4: "
              f"{', '.join(f'{t:.4f}' for t in step_s)}); peak memory "
              f"{peak} B; (r)'s dense step on the same mesh is printed "
              "above")
        keys: list = []
        groups = phase_profile("(x1)", lambda: cell.step_fn(p, o, block),
                               best, "train step", PARTITIONED_GROUPS,
                               keys=keys)
        bad = sorted({k_ for k_ in keys
                      if any(w in k_.lower() for w in SCATTER_NAMES)})
        if bad:
            raise AssertionError(f"(x1) the step ran {bad[:5]}")
        print(f"(x1) no index_add / scatter_add / index_put operation or "
              f"kernel in the step's {len(keys)} profiled names")
        del first, p, o, block, cell, params, opt0
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (x2) 8 ranks, 8 processes on the one card, gloo on CUDA tensors
    sz = gp.layout_sizes(n, edges, parts, k)
    batch8, stats8 = gp.build_partitioned_batch(
        n, *host, edges, parts, k, sz["n_l"], k * sz["e_cap"], sz["h_cap"])
    if stats8 != {"dropped_edges": 0, "dropped_halo": 0}:
        raise AssertionError(f"(x2) the layout dropped {stats8}")
    cb = pa.comm_bytes_per_layer(pa.plan_from_partition(g, parts, k),
                                 cfg.d_hidden)
    gathered = k * sz["h_cap"] * cfg.d_hidden * 4
    print(f"(x2) layout of {k} ranks: n_l {sz['n_l']}, e_cap {sz['e_cap']}, "
          f"h_cap {sz['h_cap']}; halo rows a rank {sz['halo_rows']} "
          f"({sum(sz['halo_rows'])} in all); dropped {stats8}")
    print(f"(x2) collective bytes a layer at d {cfg.d_hidden}: the exchange "
          f"gathers {k} x {sz['h_cap']} x {cfg.d_hidden} x 4 = {gathered} B "
          f"on every rank ({k * gathered} B over the {k} ranks); the real "
          f"halo rows are {cb['partition_halo']} B "
          f"(pa.comm_bytes_per_layer), the naive 2*N*F "
          f"{cb['naive_allgather']} B ({cb['reduction']:.1f}x)")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "layout.npz")
        np.savez(path, **batch8)
        del batch8
        t0 = time.perf_counter()
        out = gp.spawn_ranks(gp.train_job, k, ({
            "layout": path, "cfg": cfg, "halo_frac": sz["halo_frac"],
            "steps": 1, "repeat": True},), device="cuda", backend="gloo",
            timeout_s=240)
        wall = time.perf_counter() - t0
    losses = {r["loss"][0] for r in out}
    norms = {r["grad_norm"][0] for r in out}
    loss8, gn8 = out[0]["loss"][0], out[0]["grad_norm"][0]
    counts = [r["segment_reduce"][0] for r in out]
    if len(losses) != 1 or len(norms) != 1 or \
            not _close(loss8, x1_loss, PARTITIONED_RTOL) or \
            not _close(gn8, x1_gn, PARTITIONED_RTOL) or \
            any(c != partitioned_segment_sums(cfg) for c in counts):
        raise AssertionError(f"(x2) losses {losses} vs (x1) {x1_loss}, "
                             f"grad_norm {norms} vs {x1_gn}, segment_reduce "
                             f"{counts}")
    meta = out[0]["meta"]
    print(f"(x2) {k} ranks over {meta['backend']} on CUDA tensors (gloo "
          "copies them through host memory itself): "
          f"loss {loss8:.9g} vs (x1) {x1_loss:.9g}, grad_norm {gn8:.9g} vs "
          f"{x1_gn:.9g} (gate {PARTITIONED_RTOL}); segment_reduce "
          f"{counts[0]} launches a step on every rank; step 1 repeats bit "
          f"for bit on {sum(r['repeats'] for r in out)} of {k} ranks "
          f"(recorded, not gated); step times "
          f"{[round(r['step_s'][0], 4) for r in out]} s (gloo on one card: "
          f"a check of correctness, not of exchange speed); peak memory a "
          f"rank {max(r.get('peak_bytes', 0) for r in out)} B; {wall:.1f} s with "
          "the processes' start")
    return {"launches": per_step, "jet_gain": launches["jet_gain"],
            "step_s": best, "peak_bytes": peak,
            "device_ms_per_step": groups.get("segment_reduce"),
            "ranks": k, "loss": x1_loss, "loss_8_ranks": loss8,
            "h_cap": sz["h_cap"], "gathered_bytes_per_layer": gathered,
            "halo_bytes_per_layer": cb["partition_halo"],
            "naive_bytes_per_layer": cb["naive_allgather"]}


# ---------------------------------------------------------------------------
# (y) the dry run and op_cost against real steps
# ---------------------------------------------------------------------------

# measured peak over the fake run's predicted peak.  The fake run sees
# every storage the step's ops make, from the step's inputs on; it does not
# see what runs inside a kernel's custom op (the flash backward's
# contiguous copies and delta, segment_reduce's scratch), cuBLAS's
# workspaces, or the caching allocator's rounding of each block to 512
# bytes, all of which raise the measured peak.  On these three cells they
# came to under 0.03% of it (ratios 1.0000-1.0002 on an NVIDIA H100 80GB
# HBM3 at 700 W), so the band is wide enough for far more than that and
# narrow enough to catch a step that holds a tensor the fake run frees, or
# frees one it holds (5% of these peaks: 0.26-1.8 GB).
PEAK_RATIO = (0.95, 1.10)


def _unique_bytes(tree_) -> int:
    """Bytes of the distinct storages of ``tree_``'s tensors."""
    from repro_torch.launch.op_cost import _tensors

    seen = {}
    for t in _tensors(tree_):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _step_against_record(tag: str, arch, shape_name: str, dev) -> dict:
    """One cell's fake ``card`` record, then the cell on the card: a step
    timed (peak memory reset), a step under op_cost (flops, bytes and
    transcendentals equal the record's, each kernel launched as often as
    the record counts its calls)."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.op_cost import OpCost

    t0 = time.perf_counter()
    rec = dryrun.record(arch, shape_name, "card")
    if rec["status"] != "ok":
        raise AssertionError(f"{tag} the fake record: {rec.get('error')}\n"
                             f"{rec.get('traceback')}")
    fake_s = time.perf_counter() - t0
    want, meta = rec["cost"], rec["meta"]
    cell = steps.build_cell(arch, shape_name, dev)
    step, args = cell.step_fn, cell.args
    out = step(*args)          # warm-up (caches the rope frequencies)
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - _unique_bytes(args)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    del out
    before = dict(kernels.launch_counts)
    mode = OpCost()
    with mode:
        out = step(*args)
        torch.cuda.synchronize()
    del out
    got = mode.result()
    launched = {k: kernels.launch_counts[k] - before.get(k, 0)
                for k in kernels.launch_counts}
    diff = {k: (got[k], want[k]) for k in ("flops", "bytes",
                                            "transcendentals")
            if got[k] != want[k]}
    calls = {k: v["calls"] for k, v in want["by_kernel"].items()}
    if diff or got["by_kernel"] != want["by_kernel"]:
        raise AssertionError(f"{tag} counted on the card {diff}, kernels "
                             f"{got['by_kernel']} != the fake record's "
                             f"{want['by_kernel']}")
    if not calls or any(launched.get(k, 0) != n for k, n in calls.items()):
        raise AssertionError(f"{tag} launches {launched} != the record's "
                             f"calls {calls}")
    predicted = rec["memory"]["peak_bytes"]
    ratio = peak / predicted
    if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
        raise AssertionError(f"{tag} peak {peak} B / predicted {predicted} B "
                             f"= {ratio:.4f}, outside {PEAK_RATIO}")
    bound = rec["bound"]
    print(f"{tag} {arch.id} {shape_name}: the fake record in {fake_s:.1f} s; "
          f"on the card flops {got['flops']}, bytes {got['bytes']}, "
          f"transcendentals {got['transcendentals']}: equal to the record; "
          f"launches {launched} equal its calls")
    print(f"{tag} peak {peak} B against the predicted {predicted} B (ratio "
          f"{ratio:.4f}); counted / model flops "
          f"{got['flops'] / meta['model_flops']:.4f}; a step {step_s:.4f} s "
          f"without the counter: {got['flops'] / step_s / 1e12:.2f} TFLOP/s "
          f"counted, {meta['model_flops'] / step_s / 1e12:.2f} of model "
          f"flops; one-card bound {bound['s']:.4f} s ({bound['by']}; step / "
          f"bound {step_s / bound['s']:.2f})")
    return {"flops": got["flops"], "bytes": got["bytes"],
            "transcendentals": got["transcendentals"],
            "model_flops": meta["model_flops"], "launches": launched,
            "peak_bytes": peak, "predicted_peak_bytes": predicted,
            "peak_ratio": ratio, "step_s": step_s, "bound_s": bound["s"],
            "fake_s": fake_s}


def _dispatch_overhead(dev, calls: int = 2000, rounds: int = 5) -> dict:
    """Host microseconds a call of segment_reduce's and jet_gain's wrappers
    (the checks, the custom op's dispatch, the launch) and of their launch
    alone (the checks and the ctypes launch, no dispatch), at small shapes
    where the host's time is the call's: the cost of the custom ops on the
    host-bound paths, (o)'s thousands of jet_gain and segment_reduce calls
    and (q)'s decode.  The median of ``rounds`` alternating rounds."""
    import torch

    from repro_torch.kernels.jet_gain import ops as jg
    from repro_torch.kernels.segment_reduce import ops as sr

    g = torch.Generator(device="cpu").manual_seed(0)
    data = torch.rand(4096, 1, generator=g).to(dev)
    ids = torch.sort(torch.randint(0, 512, (4096,), generator=g,
                                   dtype=torch.int32))[0].to(dev)
    nbr_parts = torch.randint(0, 17, (4, 1024, 8), generator=g,
                              dtype=torch.int32).to(dev)
    wgt = torch.randint(1, 9, (1024, 8), generator=g,
                        dtype=torch.int32).to(dev)
    parts = torch.randint(0, 16, (4, 1024), generator=g,
                          dtype=torch.int32).to(dev)

    def seg_direct():
        sr._check(data, ids, 512)
        return sr._segment_sum_cuda(data, ids, 512)

    def jet_direct():
        jg._check(nbr_parts, wgt, parts)
        return jg._jet_gain_cuda(nbr_parts, wgt, parts, 16)

    pairs = {"segment_reduce": (lambda: sr.segment_sum_sorted(data, ids, 512),
                                seg_direct),
             "jet_gain": (lambda: jg.jet_gain_from_parts(nbr_parts, wgt,
                                                          parts, 16),
                          jet_direct)}
    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    for name, (op, direct) in pairs.items():  # equal answers; a warm-up
        if not all(torch.equal(x, y) for x, y in zip(as_tuple(op()),
                                                      as_tuple(direct()))):
            raise AssertionError(f"(y) {name}: the custom op and the "
                                 "launch alone disagree")

    def per_call(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    out = {}
    for name, (op, direct) in pairs.items():
        times = [(per_call(op), per_call(direct)) for _ in range(rounds)]
        op_us = float(np.median([t[0] for t in times]))
        direct_us = float(np.median([t[1] for t in times]))
        out[name] = {"op_us": op_us, "direct_us": direct_us,
                     "dispatch_us": op_us - direct_us}
        print(f"(y) {name} at a small shape, host time a call: through the "
              f"custom op {op_us:.2f} us, the launch alone "
              f"{direct_us:.2f} us: dispatch {op_us - direct_us:.2f} us a "
              f"call (median of {rounds} rounds of {calls})")
    return out


def phase_dryrun(tp, dev):
    """(y) the cost-counting dry run against the card: three training
    cells' fake records against real steps, and the custom ops' host
    cost."""
    import dataclasses

    from repro_torch.configs import get_arch

    gemma = get_arch("gemma3-1b")
    gemma = dataclasses.replace(gemma, shapes={"train_4k": dict(
        gemma.shapes["train_4k"], batch=GEMMA_TRAIN_BATCH)})
    mgn = get_arch("meshgraphnet")
    mgn = dataclasses.replace(mgn, shapes={"mesh_512": {
        "kind": "train", "n_nodes": 512 * 512, "n_edges": 1_568_770,
        "d_feat": mgn.config.d_in, "n_graphs": 1}})
    out = {}
    for arch, name in ((gemma, "train_4k"), (mgn, "mesh_512"),
                       (get_arch("fm"), "train_batch")):
        out[arch.id] = _step_against_record("(y)", arch, name, dev)
    out["dispatch_us"] = _dispatch_overhead(dev)
    return out


# (z2): a train step of 4 ranks on the one card (``gloo_host``: every
# collective staged through host memory) on a (2, 2) mesh against the
# one-device step of the same config: the loss's relative difference and
# each gradient leaf's relative L2, bfloat16 for Gemma at full width,
# float32 for the rest
SHARDED_GATES = {"bfloat16": (1e-3, 2e-2), "float32": (1e-3, 1e-4)}
MGN_SHARDED_SIDE = 256   # (r)'s mesh_batch(512, 512) cut to the time limit
SHARDED_JOBS = (
    # Gemma-3 1B at full width, depth 6 (five local layers, one global)
    {"arch": "gemma3-1b", "shape": "train_4k", "smoke": False,
     "config": {"n_layers": 6}, "cell_shape": {"batch": 4, "seq": 1024},
     "dtype": "bfloat16",
     "kernels": ("flash_attention", "flash_attention_bwd", "segment_reduce")},
    # DeepSeek-V2-Lite's smoke config: MLA, 8 experts over "model"
    {"arch": "deepseek-v2-lite-16b", "shape": "train_4k", "smoke": True,
     "dtype": "float32",
     "kernels": ("flash_attention", "flash_attention_bwd", "segment_reduce")},
    # FM at its published width: train_batch, B = 65,536
    {"arch": "fm", "shape": "train_batch", "smoke": False,
     "dtype": "float32",
     "kernels": ("fm_interaction", "fm_interaction_bwd", "segment_reduce")},
    # MeshGraphNet 15 x 128 on mesh_batch(256, 256): 65,536 nodes, 391,170
    # edges (the cell's 391,680 edge slots, the rest to the ghost node)
    {"arch": "meshgraphnet", "shape": "full_graph_sm", "smoke": False,
     "cell_shape": {"n_nodes": MGN_SHARDED_SIDE ** 2,
                    "n_edges": 2 * (3 * MGN_SHARDED_SIDE ** 2
                                    - 4 * MGN_SHARDED_SIDE + 1),
                    "d_feat": 4, "n_graphs": 1},
     "mesh_batch": MGN_SHARDED_SIDE, "dtype": "float32",
     "kernels": ("segment_reduce",)},
)


def _full(tree_):
    from repro_torch.launch import sharding as sh

    return sh.full(tree_)


def _train_steps(step, args, n: int):
    """``n`` runs of the train ``step`` from ``args`` (params, opt_state,
    batch), each on the last one's parameters and state: the step times,
    the losses and the final (params, opt_state)."""
    import torch

    times, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        p, o, m = step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(_full(m["loss"]))
        args = (p, o, args[2])
    return times, losses, args[:2]


def _sharded_one_rank(dev, v_result) -> dict:
    """(z1) Gemma-3 1B at full width on a one-rank NCCL mesh: two train_4k
    steps at (v)'s batch, a prefill of 4 x 4096 and 8 greedy decode steps
    through ``steps.sharded_step``, each bit for bit the unsharded cell's."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import kernels, tree
    from repro_torch.configs import get_arch
    from repro_torch.launch import gnn_partitioned as gp
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tf

    arch = get_arch("gemma3-1b")
    cfg = arch.config
    s_len, gen = 4096, 8
    arch = dataclasses.replace(arch, shapes=dict(
        arch.shapes,
        train_4k=dict(arch.shapes["train_4k"], batch=GEMMA_TRAIN_BATCH),
        prefill_32k={"kind": "prefill", "seq": s_len, "batch": 4},
        decode_32k={"kind": "decode", "seq": s_len + gen, "batch": 4}))
    gp.init_rank(0, 1, gp.free_port(), dev)
    try:
        mesh = compat_make_mesh((1, 1), ("data", "model"), dev.type)
        # two unsharded steps: their losses and the parameters after them
        cell = steps.build_cell(arch, "train_4k", dev)
        params, opt, batch = cell.args
        cell = cell._replace(args=())
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        losses = []
        for _ in range(2):
            params, opt, m = cell.step_fn(params, opt, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        want_launches = dict(kernels.launch_counts)
        del opt
        # the same two steps sharded
        scell = steps.build_cell(arch, "train_4k", dev, mesh=mesh)
        args = steps.sharded_args(scell, mesh)
        step = steps.sharded_step(scell, mesh)
        scell = scell._replace(args=())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times, got_losses, (p2, o2) = _train_steps(step, args, 2)
        args = (p2, o2, args[2])
        # besides (v)'s step: the unsharded parameters kept for the
        # comparison, and each step's inputs alive beside its outputs
        peak = torch.cuda.max_memory_allocated()
        launches = dict(kernels.launch_counts)
        fwd_n, bwd_n = lm_flash_launches(cfg)
        per_step = {"flash_attention": fwd_n, "flash_attention_bwd": bwd_n,
                    "segment_reduce": EMBED_SEGMENT_SUMS["lm"]}
        want = {k: 2 * n for k, n in per_step.items()}
        if {k: launches.get(k, 0) for k in want} != want or \
                {k: want_launches.get(k, 0) for k in want} != want:
            raise AssertionError(f"(z1) launches {launches} (unsharded "
                                 f"{want_launches}) != {want} in two steps")
        if not (all(map(_equal, got_losses, losses))
                and _bitwise(_full(args[0]), params)):
            raise AssertionError("(z1) the sharded steps' losses or "
                                 "parameters differ from the unsharded ones")
        del args, p2, o2
        v_step = v_result.get("step_s") if v_result else None
        v_peak = v_result.get("peak_bytes") if v_result else None
        print(f"(z1) gemma3-1b train_4k at batch {GEMMA_TRAIN_BATCH} on a "
              f"one-rank NCCL mesh: losses {[float(x) for x in losses]} and "
              f"the parameters after 2 steps bit for bit the unsharded "
              f"cell's; launches {launches} (the unsharded cell's "
              f"{want_launches}); steps {', '.join(f'{t:.4f}' for t in times)}"
              f" s ((v): {v_step}), peak {peak} B ((v): {v_peak})")
        # prefill 4 x 4096 and 8 greedy decode steps
        pcell = steps.build_cell(arch, "prefill_32k", dev, params=params,
                                 mesh=mesh)
        dcell = steps.build_cell(arch, "decode_32k", dev, params=params,
                                 mesh=mesh)
        tokens = pcell.args[1]

        def prefill(p, t):
            return tf.prefill(cfg, p, t, max_len=s_len + gen)

        def decode(p, c, t):
            return tf.decode_step(cfg, p, c, t)

        pstep = steps.sharded_step(pcell._replace(step_fn=prefill), mesh)
        dstep = steps.sharded_step(dcell._replace(step_fn=decode), mesh)
        dparams = sh.distribute(params, pcell.in_specs[0], mesh)
        with torch.no_grad():
            logits, cache = prefill(params, tokens)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            slogits, scache = pstep(dparams, sh.distribute(
                tokens, pcell.in_specs[1], mesh))
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            prefill_launches = dict(kernels.launch_counts)
            same = _equal(_full(slogits), logits) and _bitwise(
                {k: _full(v) for k, v in scache.items() if k != "len"},
                {k: v for k, v in cache.items() if k != "len"})
            t_dec = 0.0
            for _ in range(gen):
                tok = logits.argmax(-1).to(torch.int32)
                logits, cache = decode(params, cache, tok)
                t0 = time.perf_counter()
                slogits, scache = dstep(dparams, scache, sh.distribute(
                    tok, dcell.in_specs[2], mesh))
                torch.cuda.synchronize()
                t_dec += time.perf_counter() - t0
                same = same and _equal(_full(slogits), logits)
        if not same or prefill_launches.get("flash_attention") != \
                cfg.n_layers:
            raise AssertionError(f"(z1) the sharded prefill or decode differ "
                                 f"from the unsharded ones (prefill launches "
                                 f"{prefill_launches})")
        print(f"(z1) prefill 4 x {s_len} and {gen} greedy decode steps "
              f"through sharded_step: logits and cache bit for bit the "
              f"unsharded ones; prefill {prefill_s:.4f} s "
              f"({prefill_launches.get('flash_attention')} flash launches), "
              f"decode {t_dec / gen * 1e3:.2f} ms a step")
        return {"launches_two_steps": launches, "step_s": times,
                "peak_bytes": peak, "prefill_s": prefill_s,
                "decode_ms": t_dec / gen * 1e3, "bitwise": True,
                "losses": [float(x) for x in losses]}
    finally:
        dist.destroy_process_group()


def _sharded_four_ranks(dev) -> dict:
    """(z2) 4 ranks as 4 processes on the one card, a (2, 2) mesh, over
    ``gloo_host`` (``dist/host_group.py``).  First the record of plain
    gloo on CUDA tensors (``lm_sharded.probe``, each collective in
    processes of its own, until the first refusal); then the dry run's
    prediction of each of SHARDED_JOBS on a fake (2, 2) world, and one
    world of gloo_host ranks: the four probes, then one train step of
    each job against the one-device step, the ranks' peaks against the
    prediction, their collectives against its count and their kernels'
    launches."""
    from repro_torch.dist import host_group
    from repro_torch.kernels import _build
    from repro_torch.launch import lm_sharded

    _build.build(_build.KERNELS)   # the ranks load them, none compiles
    t0 = time.perf_counter()
    refused = lm_sharded.probe(4, "cuda", "gloo", timeout_s=120,
                               until_refused=True)
    print(f"(z2) plain gloo on CUDA tensors, 4 ranks on one card: "
          f"{refused} ({time.perf_counter() - t0:.1f} s)")
    jobs = [dict(job, mesh=(2, 2), axes=("data", "model"), grads=True)
            for job in SHARDED_JOBS]
    preds = []
    for job in jobs:
        t0 = time.perf_counter()
        pred = lm_sharded.predict(job, 4)
        preds.append(pred)
        print(f"(z2) {job['arch']}: the dry run's rank 0 on a fake (2, 2) "
              f"world: peak {pred['peak_bytes']} B, collectives "
              f"{pred['collectives']} ({pred['collective_bytes']} B) "
              f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    world = lm_sharded.run_all(jobs, 4, device="cuda",
                               backend=host_group.BACKEND, probe=True,
                               timeout_s=600)
    run_s = time.perf_counter() - t0
    print(f"(z2) {host_group.BACKEND}, 4 ranks on one card: probes "
          f"{world['probes']}; the spawn, probes and {len(jobs)} steps "
          f"{run_s:.1f} s")
    if world["probes"] != {k: True for k in lm_sharded.PROBES}:
        raise AssertionError(f"(z2) {host_group.BACKEND} does not carry "
                             f"every probe: {world['probes']}")
    out = {"gloo_cuda": refused, "gloo_host": world["probes"],
           "run_s": run_s}
    for job, pred, res in zip(jobs, preds, world["jobs"]):
        tag = f"(z2) {job['arch']}"
        a = res[0]["against_one_device"]
        dtype = job["dtype"]
        loss_tol, grad_tol = SHARDED_GATES[dtype]
        ratios = [r["peak_bytes"] / pred["peak_bytes"] for r in res]
        launches = [{k: r["launches"].get(k, 0) for k in job["kernels"]}
                    for r in res]
        print(f"{tag} ({dtype}), 4 ranks on one card, host-staged "
              f"collectives: loss {a['loss']:.7g} against the one-device "
              f"{a['one_device_loss']:.7g} (relative {a['loss_rel']:.3g}, "
              f"gate {loss_tol}); gradients' largest leaf relative L2 "
              f"{a['grad_rel_l2_max']:.3g} (gate {grad_tol}); step "
              f"{res[0]['step_s']:.2f} s")
        print(f"{tag} peaks {[r['peak_bytes'] for r in res]} B (ratios to "
              f"the prediction {', '.join(f'{x:.4f}' for x in ratios)}); "
              f"collectives {[r['collectives'] for r in res]}; launches by "
              f"rank {launches}")
        if not (a["loss_rel"] <= loss_tol and a["grad_rel_l2_max"] <=
                grad_tol):
            raise AssertionError(f"{tag} against one device: {a}")
        if not all(PEAK_RATIO[0] <= x <= PEAK_RATIO[1] for x in ratios):
            raise AssertionError(f"{tag} peak ratios {ratios} outside "
                                 f"{PEAK_RATIO}")
        if any(r["collectives"] != pred["collectives"] for r in res):
            raise AssertionError(f"{tag} collectives differ from the dry "
                                 "run's")
        if not all(all(n.values()) for n in launches):
            raise AssertionError(f"{tag} a rank launched none of a kernel: "
                                 f"{launches}")
        out[job["arch"]] = {
            "dtype": dtype, "loss_rel": a["loss_rel"],
            "grad_rel_l2_max": a["grad_rel_l2_max"],
            "predicted_peak_bytes": pred["peak_bytes"],
            "peak_bytes": [r["peak_bytes"] for r in res], "peak_ratio": ratios,
            "collectives": res[0]["collectives"],
            "predicted_collectives": pred["collectives"],
            "launches_by_rank": launches, "regions": res[0]["regions"],
            "step_s": res[0]["step_s"]}
    return out


def _zero_head_flash(dev) -> dict:
    """(z3) a shard with no query head on the card: an empty output and
    gradient, no launch."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v = (torch.zeros((2, 0, 128, 64), dtype=torch.bfloat16,
                           device=dev, requires_grad=True) for _ in range(3))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    o = fa_ops.flash_attention(q, k, v, causal=True, window=0)
    grads = torch.autograd.grad(o.sum(), (q, k, v), allow_unused=True)
    torch.cuda.synchronize()
    launched = dict(kernels.launch_counts)
    if tuple(o.shape) != (2, 0, 128, 64) or any(launched.values()) or \
            tuple(grads[0].shape) != (2, 0, 128, 64):
        raise AssertionError(f"(z3) zero heads: output {tuple(o.shape)}, "
                             f"launches {launched}")
    print(f"(z3) a zero-head flash_attention call on the card: output "
          f"{tuple(o.shape)}, gradient {tuple(grads[0].shape)}, no launch")
    return {"shape": list(o.shape), "launches": launched}


def phase_sharded(tp, dev, v_result=None) -> dict:
    """(z) the sharded cells on a DeviceMesh: one LM rank on NCCL bit for
    bit, four gloo_host ranks on the card (the LM, FM and GNN cells)
    against one device and the dry run, a zero-head shard."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()   # what earlier phases left cached
    out = {"z1": _sharded_one_rank(dev, v_result)}
    gc.collect()
    torch.cuda.empty_cache()   # the card's memory to the four rank processes
    out["z2"] = _sharded_four_ranks(dev)
    out["z3"] = _zero_head_flash(dev)
    return out


def _against_unsharded(tag: str, cell, scell, mesh, n: int,
                       counted) -> dict:
    """``n`` train steps of ``cell`` and of ``scell`` (the same cell built
    with ``mesh``) through ``steps.sharded_step``, the launch counts of
    each run from zero: losses, parameters and optimizer state bit for
    bit, the ``counted`` kernels launched as often; step times and the
    sharded run's peak."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import steps

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, losses, want = _train_steps(cell.step_fn, cell.args, n)
    plain = {k: kernels.launch_counts.get(k, 0) for k in counted}
    args = steps.sharded_args(scell, mesh)
    step = steps.sharded_step(scell, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    s_times, s_losses, got = _train_steps(step, args, n)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: kernels.launch_counts.get(k, 0) for k in counted}
    if launches != plain or not all(launches.values()):
        raise AssertionError(f"{tag} launches {launches} != the unsharded "
                             f"run's {plain}")
    if not (all(map(_equal, s_losses, losses))
            and _bitwise(_full(got), want)):
        raise AssertionError(f"{tag} the sharded steps' losses, parameters "
                             "or optimizer state differ from the unsharded")
    print(f"{tag} {n} steps on a one-rank NCCL mesh: losses "
          f"{[float(x) for x in losses]}, parameters and optimizer state bit "
          f"for bit the unsharded cell's; launches {launches} (the "
          f"unsharded run's); steps {', '.join(f'{t:.5f}' for t in s_times)} "
          f"s against {', '.join(f'{t:.5f}' for t in times)} s unsharded; "
          f"peak {peak} B")
    return {"launches": launches, "step_s": s_times, "unsharded_step_s": times,
            "peak_bytes": peak, "bitwise": True,
            "losses": [float(x) for x in losses]}


def _sharded_serve(tag: str, cell, scell, mesh, counted) -> dict:
    """One call of the serve (or retrieval) ``cell`` and of ``scell`` on
    ``mesh``: the scores bit for bit, the ``counted`` kernels launched as
    often; the two calls' times."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import steps

    with torch.no_grad():
        want, launches_want = _counted(cell.step_fn, *cell.args)
        args = steps.sharded_args(scell, mesh)
        step = steps.sharded_step(scell, mesh)
        step(*args)                        # DTensor's caches
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = _full(step(*args))
        torch.cuda.synchronize()
        s_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.launch_counts)
        ms = _time_ms(lambda: cell.step_fn(*cell.args), 5)
    pick = {k: launches.get(k, 0) for k in counted}
    if pick != {k: launches_want.get(k, 0) for k in counted} or \
            not _equal(got, want):
        raise AssertionError(f"{tag} scores or launches {launches} differ "
                             f"from the unsharded call's {launches_want}")
    print(f"{tag} on a one-rank NCCL mesh: {tuple(got.shape)} scores bit for "
          f"bit the unsharded call's; launches {pick}; {s_ms:.3f} ms against "
          f"{ms:.3f} ms unsharded")
    return {"launches": pick, "ms": s_ms, "unsharded_ms": ms}


def phase_sharded_fm_gnn(tp, dev) -> dict:
    """(z4) FM at its published width (train_batch, serve_bulk,
    retrieval_cand) and MeshGraphNet at (r)'s size as sharded programs on a
    one-rank NCCL mesh, each bit for bit its unsharded cell with the
    kernels launched as often."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import gnn_partitioned as gp
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import compat_make_mesh

    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    gp.init_rank(0, 1, gp.free_port(), dev)
    try:
        mesh = compat_make_mesh((1, 1), ("data", "model"), dev.type)
        fm = get_arch("fm")
        fm_kernels = ("fm_interaction", "fm_interaction_bwd",
                      "segment_reduce")
        cell = steps.build_cell(fm, "train_batch", dev)
        scell = steps.build_cell(fm, "train_batch", dev, mesh=mesh)
        out["fm_train"] = _against_unsharded(
            f"(z4) fm train_batch B={cell.args[2]['ids'].shape[0]}", cell,
            scell, mesh, 2, fm_kernels)
        del cell, scell
        for shape in ("serve_bulk", "retrieval_cand"):
            cell = steps.build_cell(fm, shape, dev)
            scell = steps.build_cell(fm, shape, dev, mesh=mesh)
            out[f"fm_{shape}"] = _sharded_serve(
                f"(z4) fm {shape}", cell, scell, mesh,
                ("fm_interaction",) if shape == "serve_bulk" else ())
            del cell, scell
        # MeshGraphNet at full width on (r)'s mesh_batch(512, 512)
        data = synthetic.mesh_batch(512, 512, seed=0, device=dev)
        graph = data["graph"]
        n, e = graph.node_feat.shape[0], graph.senders.shape[0]
        arch = get_arch("meshgraphnet")
        arch = dataclasses.replace(arch, shapes={"mesh_512": {
            "kind": "train", "n_nodes": n, "n_edges": e,
            "d_feat": graph.node_feat.shape[1], "n_graphs": graph.n_graphs}})
        batch = steps.with_edge_plan({
            "node_feat": graph.node_feat, "senders": graph.senders,
            "receivers": graph.receivers, "pos": graph.pos,
            "graph_id": graph.graph_id, "target": data["target"]},
            graph.n_graphs)
        del data, graph
        cell, scell = (c._replace(args=c.args[:2] + (batch,)) for c in (
            steps.build_cell(arch, "mesh_512", dev),
            steps.build_cell(arch, "mesh_512", dev, mesh=mesh)))
        out["meshgraphnet"] = _against_unsharded(
            f"(z4) meshgraphnet {arch.config.n_layers} x "
            f"{arch.config.d_hidden} on mesh_batch(512, 512) (N = {n}, "
            f"E = {e})", cell, scell, mesh, 2, ("segment_reduce",))
        want = 2 * gnn_segment_sums("meshgraphnet", arch.config)
        if out["meshgraphnet"]["launches"]["segment_reduce"] != want:
            raise AssertionError(f"(z4) segment_reduce launches "
                                 f"{out['meshgraphnet']['launches']} != "
                                 f"{want} in two steps")
    finally:
        dist.destroy_process_group()
    return out


PHASES = ("a", "b", "b2", "b3", "c", "d", "n", "p", "e", "g", "h", "m", "o",
          "i", "j", "k", "l", "q", "r", "s", "t", "u", "v", "w",
          "x", "y", "z", "z4")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=PHASES,
                    help="run only these phases (a debugging aid: a run of "
                         "a subset prints no result line); (e) includes (f), "
                         "and (g) needs (e)")
    args = ap.parse_args(argv)
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
    run = set(args.phases) | {"a"} | ({"e"} if "g" in args.phases else set())

    def timed(tag, phase, *a):
        t1 = time.perf_counter()
        result = phase(*a)
        print(f"({tag}) took {time.perf_counter() - t1:.1f} s", flush=True)
        return result

    t0 = time.perf_counter()
    entries = []
    timed("a", phase_build)
    for tag, phase, a in (("b", phase_kernel_vs_plain, (tp, dev)),
                          ("b2", phase_segment_vs_plain, (tp, dev)),
                          ("b3", phase_slot, (tp, dev)),
                          ("c", phase_golden, (tp, dev)),
                          ("d", phase_card_vs_cpu, (tp,)),
                          ("n", phase_fleet_small, (tp,))):
        if tag in run:
            timed(tag, phase, *a)
    jet_gain = {"name": "jet_gain"}
    segment = {"name": "segment_reduce"}
    if "p" in run:
        served = timed("p", phase_serve_small, tp)
        segment["serve"] = {"launches": served["segment_reduce"]}
    if "e" in run:
        g, cfg, res_ell, jet_gain_e = timed("e, f", phase_full_width, dev)
        jet_gain.update(jet_gain_e)
    if "g" in run:
        segment.update(timed("g", phase_sorted_full_width, tp, dev, g, cfg,
                             res_ell))
        del g, res_ell
    entries += [jet_gain, segment]
    if "h" in run:
        timed("h", phase_powerlaw, tp)
    if "m" in run:
        jet_gain["fleet"] = timed("m", phase_fleet_full_width, tp, dev)
    if "o" in run:
        jet_gain["serve"] = timed("o", phase_serve_full_width, tp)
    if "i" in run:
        timed("i", phase_fm_vs_plain, tp, dev)
    if "j" in run:
        entries.append(timed("j", phase_fm_serving, tp, dev))
    if "k" in run:
        timed("k", phase_flash_vs_plain, tp, dev)
    flash = {"name": "flash_attention"}
    if "l" in run:
        flash.update(timed("l", phase_gemma, tp, dev))
    if "q" in run:
        flash["mla_layer"] = timed("q", phase_deepseek, tp, dev)
    entries.append(flash)
    if "r" in run:
        segment["gnn"] = timed("r", phase_gnn_training, tp, dev)
    if "s" in run:
        segment.setdefault("gnn", {})["launches_per_step"] = timed(
            "s", phase_gnn_archs, tp, dev)
    flash_bwd = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:31",
        "note": "no backward Pallas kernel: the reference trains through "
                "chunked_attention, which XLA differentiates",
        "check": "float32 within 1e-4 relative L2 of plain, 16-bit within "
                 "2e-2, bitwise across launches (phase t); Gemma-3 1B's "
                 "gradients within max(2e-2, 2 x the SDPA path's) (phase v)"}
    if "t" in run:
        at = timed("t", phase_train_kernels, tp, dev)
        g_ = at["global"]
        flash_bwd.update({k_: g_[k_] for k_ in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        flash_bwd.update(shape={"B": 8, "H": 4, "Hkv": 1, "S": 4096,
                                "D": 256, "Dv": 256, "dtype": "bfloat16",
                                "causal": True},
                         local_layer=at["local"], mla_layer=at["mla_layer"])
    if "u" in run:
        fm_train = timed("u", phase_fm_training, tp, dev)
        entries.append(fm_train)
        segment.setdefault("train", {})["fm"] = \
            fm_train["launches_per_step"]["segment_reduce"]
    lm = None
    if "v" in run:
        lm = timed("v", phase_gemma_training, tp, dev)
        flash_bwd["launches"] = lm["launches"]["flash_attention_bwd"]
        flash_bwd["gemma_train_step"] = lm
        segment.setdefault("train", {})["gemma3-1b"] = \
            lm["launches"]["segment_reduce"]
    entries.append(flash_bwd)
    if "w" in run:
        timed("w", phase_smoke_training, tp, dev)
    if "x" in run:
        part = timed("x", phase_partitioned, tp, dev)
        segment["partitioned"] = part
        jet_gain["partitioned"] = {"launches": part["jet_gain"]}
    if "y" in run:
        timed("y", phase_dryrun, tp, dev)
    if "z" in run:
        z = timed("z", phase_sharded, tp, dev, lm)
        sharded = {"z1_launches_two_steps": z["z1"]["launches_two_steps"],
                   "z1_bitwise": z["z1"]["bitwise"], "z2": z["z2"]}
        flash["sharded"] = dict(sharded, z3=z["z3"])
        flash_bwd["sharded"] = sharded
        segment["sharded"] = sharded
        for e_ in entries:
            if e_["name"] in ("fm_interaction", "fm_interaction_bwd"):
                e_["sharded_4_ranks"] = [
                    n[e_["name"]] for n in z["z2"]["fm"]["launches_by_rank"]]
    if "z4" in run:
        z4 = timed("z4", phase_sharded_fm_gnn, tp, dev)
        print(f"(z4) on {smi}", flush=True)
        for e_ in entries:
            if e_["name"] in ("fm_interaction", "fm_interaction_bwd"):
                e_["sharded_fm"] = {
                    k_: z4[k_]["launches"].get(e_["name"])
                    for k_ in ("fm_train", "fm_serve_bulk")
                    if e_["name"] in z4[k_]["launches"]}
        segment["sharded"] = dict(segment.get("sharded", {}), z4={
            k_: z4[k_]["launches"]["segment_reduce"]
            for k_ in ("fm_train", "meshgraphnet")})
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        raise AssertionError(f"the port's run imported {leaked[:5]}")
    print(f"phases {' '.join(p for p in PHASES if p in run)} passed in "
          f"{time.perf_counter() - t0:.1f} s; no jax or repro module "
          "imported", flush=True)
    print(json.dumps({"kernels": entries}))
    if run != set(PHASES):
        print("a subset of the phases ran: no result line")
        return 0
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
