"""Partition-as-a-service: async micro-batching over fleet buckets (§11).

Counterpart of ``repro.launch.partition_serve``.

* :class:`PartitionServer` accepts concurrent partition requests (graph +
  k + trials + seed), coalesces them over a configurable window into
  shape-bucketed fleets on a FIXED capacity ladder, dispatches each
  bucket through :func:`~repro_torch.core.partition.partition_fleet_stacked`
  on its device, and routes per-member results back to their callers.
  Every response is bit-identical to a standalone ``partition()`` call
  with the same config: batching changes the schedule, never the values.

* Warm start: :meth:`PartitionServer.warmup` runs the (rung, k) signature
  grid from representative shapes ahead of traffic, so a replay of the
  same shapes runs no new signature
  (:func:`~repro_torch.core.partition.fleet_signature_count`), and
  :func:`enable_compile_cache` points the kernel libraries at a directory
  that a later process finds them in instead of running ``nvcc`` again.

Batch width discipline: every dispatched bucket is padded (with filler
copies of its first member) or split to exactly ``ServeConfig.lanes``
lanes, so the batch width never adds a signature: one per (rung, k).

The server runs on the card unless it is built with ``device="cpu"``:

    server = PartitionServer(ServeConfig(ladder_n=1024, ladder_m=8192))
    server.warmup([gen.grid2d(16, 16)], ks=(8,))
    async with server:
        res = await server.submit(g, k=8)
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from itertools import combinations

import numpy as np
import torch

from repro_torch.core import graph as gr
from repro_torch.core.coarsen import _round_up, shape_schedule
from repro_torch.core.partition import (
    PartitionConfig, PartitionResult, fleet_signature_count, level_signatures,
    partition_fleet_stacked,
)
from repro_torch.device import resolve_device
from repro_torch.kernels._build import (
    CompileCacheStats, cache_stats, enable_compile_cache,
)


@dataclass
class ServeConfig:
    """Serving knobs; ``partition`` holds the per-request defaults.

    ``ladder_n``/``ladder_m`` pin the top rung of the serve-wide capacity
    ladder — requests larger than the top rung are rejected at admission.
    ``window_s`` is the coalescing window: the batcher collects requests
    for this long after the first arrival before dispatching.  ``lanes``
    is the fixed batch width every dispatched bucket is padded/split to.
    ``compile_cache`` is a directory for the kernel libraries.
    """

    ladder_n: int = 4096
    ladder_m: int = 32768
    window_s: float = 0.002
    lanes: int = 4
    max_batch: int = 64            # requests per coalesce round, max
    partition: PartitionConfig = field(default_factory=PartitionConfig)
    compile_cache: str | None = None


@dataclass
class _Request:
    graph: object
    cfg: PartitionConfig
    cfg_key: tuple       # grouping key: (k, trials, seed, trial_seeds)
    future: asyncio.Future
    t_enqueue: float


def _resolve_cfg(base: PartitionConfig, k, trials, seed, trial_seeds):
    cfg = base
    if k is not None:
        cfg = replace(cfg, k=int(k))
    if trials is not None:
        cfg = replace(cfg, trials=int(trials))
    if seed is not None:
        cfg = replace(cfg, seed=int(seed))
    if trial_seeds is not None:
        cfg = replace(cfg, trial_seeds=tuple(int(s) for s in trial_seeds))
    return cfg


def _named_device(device) -> torch.device:
    """The device with its index spelled out, so the worker thread never
    depends on which CUDA device is current there."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class PartitionServer:
    """Async micro-batching front end over ``partition_fleet_stacked``.

    Lifecycle: construct, optionally :meth:`warmup`, then ``async with``
    (or :meth:`start` / :meth:`stop`).  :meth:`submit` is awaitable and
    safe to call concurrently from many tasks; requests sharing a
    coalescing window and a config signature (k, trials, seed) are batched
    into one fleet dispatch, shape-bucketed on the pinned ladder.

    ``device`` is resolved as ``partition()`` resolves it: ``None`` is the
    card (raising without one), ``"cpu"`` runs the kernels' plain versions.

    Host reads per dispatch: one batched (n, m) fetch at assembly, the
    fleet's reads per coarsening level and refinement iteration, and ONE
    transfer of the dispatch's results, all shared by every request in it.
    """

    def __init__(self, cfg: ServeConfig, device=None):
        if cfg.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {cfg.lanes}")
        self.cfg = cfg
        self.device = _named_device(device)
        p = cfg.partition
        self.schedule = shape_schedule(
            _round_up(cfg.ladder_n, p.bucket_align),
            _round_up(cfg.ladder_m, p.bucket_align),
            ratio=p.bucket_ratio, safety=p.bucket_safety,
            stall_ratio=p.stall_ratio, align=p.bucket_align,
        )
        if cfg.compile_cache:
            enable_compile_cache(cfg.compile_cache)
        self._queue: asyncio.Queue | None = None
        self._task: asyncio.Task | None = None
        self._pool: ThreadPoolExecutor | None = None
        # per-item records are bounded so a long-lived server doesn't
        # accumulate memory with traffic; the counters are exact forever,
        # the latency percentiles and signature logs cover a recent window
        self.stats = {
            "requests": 0, "responses": 0, "rejected": 0, "dispatches": 0,
            "buckets": 0, "filler_lanes": 0,
            "occupancy_hist": {},      # real lanes per dispatched bucket
            "latency_s": deque(maxlen=8192),  # enqueue -> response
        }
        self.dispatch_log: deque = deque(maxlen=2048)  # signature records
        self.warmup_log: deque = deque(maxlen=2048)    # same, warmup grid

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "PartitionServer":
        if self._task is not None:
            raise RuntimeError("server already started")
        self._queue = asyncio.Queue()
        # one worker: device dispatches serialize, the event loop keeps
        # coalescing the next window while the current batch computes
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="jet-serve")
        self._task = asyncio.create_task(self._batch_loop())
        return self

    async def stop(self) -> None:
        if self._task is None:
            return
        await self._queue.put(None)  # drain sentinel: flush, then exit
        await self._task
        # a submit racing stop() can enqueue behind the sentinel; fail
        # those futures instead of leaving their callers awaiting forever
        while not self._queue.empty():
            req = self._queue.get_nowait()
            if req is not None and not req.future.done():
                req.future.set_exception(
                    RuntimeError("server stopped before dispatch"))
        self._pool.shutdown(wait=True)  # all dispatches already gathered
        self._pool = None
        self._task = None
        self._queue = None

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, *exc):
        await self.stop()

    # -- request path ------------------------------------------------------

    def _admissible(self, g) -> bool:
        """Host-only fast path; falls back to one (n, m) read only when
        the graph's own padding exceeds the ladder top."""
        n_top = max(nc for nc, _ in self.schedule)
        m_top = max(mc for _, mc in self.schedule)
        if g.n_max <= n_top and g.m_max <= m_top:
            return True
        n, m = torch.stack([g.n, g.m]).tolist()
        return n <= n_top and m <= m_top

    async def submit(self, graph, *, k=None, trials=None, seed=None,
                     trial_seeds=None) -> PartitionResult:
        """Enqueue one partition request; resolves to the same
        :class:`PartitionResult` a standalone ``partition(graph, cfg)``
        call with the resolved config would return."""
        if self._queue is None:
            raise RuntimeError("server not started — use `async with server`")
        self.stats["requests"] += 1
        if not self._admissible(graph):
            self.stats["rejected"] += 1
            raise ValueError(
                "graph exceeds the serve ladder's top rung "
                f"({self.cfg.ladder_n}, {self.cfg.ladder_m}) — raise "
                "ServeConfig.ladder_n/ladder_m or partition it standalone"
            )
        cfg = _resolve_cfg(self.cfg.partition, k, trials, seed, trial_seeds)
        req = _Request(graph=graph, cfg=cfg,
                       cfg_key=(cfg.k, cfg.trials, cfg.seed,
                                cfg.trial_seeds),
                       future=asyncio.get_running_loop().create_future(),
                       t_enqueue=time.perf_counter())
        await self._queue.put(req)
        return await req.future

    async def _batch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        inflight: set[asyncio.Task] = set()
        draining = False
        while not draining:
            first = await self._queue.get()
            if first is None:
                break
            batch = [first]
            deadline = loop.time() + self.cfg.window_s
            while len(batch) < self.cfg.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if nxt is None:  # stop() mid-window: serve the batch, exit
                    draining = True
                    break
                batch.append(nxt)
            groups: dict[tuple, list[_Request]] = {}
            for r in batch:
                groups.setdefault(r.cfg_key, []).append(r)
            # dispatch WITHOUT awaiting: the single-worker executor
            # serializes device work while this loop keeps coalescing the
            # next window on top of it
            for reqs in groups.values():
                t = asyncio.create_task(
                    self._dispatch_group(reqs[0].cfg, reqs))
                inflight.add(t)
                t.add_done_callback(inflight.discard)
        if inflight:
            await asyncio.gather(*inflight)

    async def _dispatch_group(self, cfg: PartitionConfig,
                              reqs: list[_Request]) -> None:
        try:
            results, log = await asyncio.get_running_loop().run_in_executor(
                self._pool, self._dispatch, cfg, [r.graph for r in reqs])
        except Exception as e:  # noqa: BLE001 — routed to callers
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(
                        RuntimeError(f"dispatch failed: {e}"))
        else:
            # all stats/log mutation happens HERE, on the event-loop
            # thread — metrics() can iterate them concurrently without
            # racing the worker
            self.stats["dispatches"] += 1
            hist = self.stats["occupancy_hist"]
            for b in log["buckets"]:
                self.stats["buckets"] += 1
                self.stats["filler_lanes"] += b["lanes"] - b["real"]
                hist[b["real"]] = hist.get(b["real"], 0) + 1
            self.dispatch_log.append(log)
            t_done = time.perf_counter()
            for r, res in zip(reqs, results):
                if r.future.done():  # caller gave up (cancelled/timed out)
                    continue
                self.stats["responses"] += 1
                self.stats["latency_s"].append(t_done - r.t_enqueue)
                r.future.set_result(res)

    def _dispatch(self, cfg: PartitionConfig, graphs) -> tuple:
        """One coalesced fleet run (the worker thread, or warmup): assemble
        ``graphs`` on the pinned ladder at the fixed width -> stacked fleet
        on the server's device -> (results in input order, log record).
        The caller applies the record to the server's stats, so the worker
        never touches shared state."""
        asm = gr.BucketAssembler(self.schedule, lanes=self.cfg.lanes)
        for i, g in enumerate(graphs):
            asm.add(i, g)
        buckets = asm.flush()
        fres = partition_fleet_stacked(buckets, cfg, self.schedule,
                                       device=self.device)
        log = self._log_record(cfg, buckets, fres, len(graphs))
        return [fres.results[i] for i in range(len(graphs))], log

    @staticmethod
    def _log_record(cfg, buckets, fres, nreq) -> dict:
        """Signature-accounting record for one stacked-fleet run."""
        return {
            "k": cfg.k, "trials": cfg.trials, "backend": cfg.backend,
            "c_finest": cfg.c_finest, "c_coarse": cfg.c_coarse,
            "requests": nreq,
            "buckets": [
                {
                    "capacity": list(sb.capacity), "lanes": len(sb.tags),
                    "real": sum(t is not None for t in sb.tags),
                    # caller paddings of the real lanes: differing values
                    # prove the bucket mixed genuinely different graphs
                    "member_n_max": [nm for t, nm in zip(sb.tags,
                                                         sb.orig_n_max)
                                     if t is not None],
                    "levels": fb.levels,
                    "level_stats": [
                        {kk: st[kk] for kk in ("level", "n_max", "m_max",
                                               "ell_width") if kk in st}
                        for st in fb.level_stats
                    ],
                }
                for sb, fb in zip(buckets, fres.buckets)
            ],
        }

    # -- warm-start subsystem ---------------------------------------------

    def warmup(self, shapes, ks=None, trials=None, seed=None,
               compositions: str = "subsets") -> dict:
        """Run the (rung, k) signature grid ahead of traffic.

        ``shapes`` is a list of representative graphs spanning the
        workload's shape families; for each (k, T) in the grid, they are
        assembled into ``lanes``-wide buckets on the pinned ladder and
        run through the complete fleet path, so every kernel library the
        workload loads is built and every shape signature it will run has
        run once.

        A bucket's coarse-level rung chain follows the per-level batch
        max over its lanes, so it depends on WHICH families share the
        bucket (though not on their multiplicity: duplicate lanes —
        filler included — never move the max).  The default
        ``compositions="subsets"`` therefore dispatches every size-<=
        ``lanes`` subset of each rung's families, covering every lane
        composition a replay of these shapes can produce: afterwards the
        same workload runs ZERO new signatures.  That grid is
        ``sum_s C(F, s)`` dispatches per (rung, k) — fine for the few
        families per rung real workloads have; ``compositions="full"``
        dispatches each rung's full member list once (cheapest, but a
        replay whose buckets mix differently may still add signatures).

        Call before :meth:`start`; returns signature and cache accounting.
        ``ks``/``trials``/``seed`` default to the server's own partition
        config — the signatures its plain ``submit()`` calls will hit
        (coarsening is seeded, so the rung chain follows the seed).
        """
        base = self.cfg.partition
        ks = (base.k,) if ks is None else ks
        trials = (base.trials,) if trials is None else trials
        seed = base.seed if seed is None else seed
        shapes = list(shapes)
        _, bucket_map = gr.bucket_graphs(shapes, schedule=self.schedule)
        jobs: list[tuple] = []
        for cap in sorted(bucket_map, reverse=True):
            idxs = bucket_map[cap]
            if compositions == "subsets":
                top = min(self.cfg.lanes, len(idxs))
                jobs += [c for s in range(1, top + 1)
                         for c in combinations(idxs, s)]
            elif compositions == "full":
                jobs.append(tuple(idxs))
            else:
                raise ValueError(
                    f"compositions must be 'subsets' or 'full', got "
                    f"{compositions!r}")

        stats = cache_stats()
        before_cache = stats.snapshot()
        before_sigs = fleet_signature_count()
        t0 = time.perf_counter()
        for k in ks:
            for t in trials:
                cfg = _resolve_cfg(self.cfg.partition, k, t, seed, None)
                for sub in jobs:
                    _, log = self._dispatch(cfg, [shapes[i] for i in sub])
                    self.warmup_log.append(log)
        return {
            "warmup_s": time.perf_counter() - t0,
            "signatures": [(k, t) for k in ks for t in trials],
            "new_executables": fleet_signature_count() - before_sigs,
            "cache_events": CompileCacheStats.delta(before_cache,
                                                    stats.snapshot()),
        }

    # -- reporting ---------------------------------------------------------

    def metrics(self) -> dict:
        """Service-side metrics snapshot (latency, occupancy, signatures,
        kernel-library cache)."""
        lat = sorted(self.stats["latency_s"])
        occ = self.stats["occupancy_hist"]
        occ_total = sum(occ.values())
        return {
            "requests": self.stats["requests"],
            "responses": self.stats["responses"],
            "rejected": self.stats["rejected"],
            "dispatches": self.stats["dispatches"],
            "buckets": self.stats["buckets"],
            "filler_lanes": self.stats["filler_lanes"],
            "occupancy_hist": {str(kk): vv for kk, vv in sorted(occ.items())},
            "mean_occupancy": (
                sum(kk * vv for kk, vv in occ.items()) / occ_total
                if occ_total else 0.0
            ),
            "p50_latency_ms": 1e3 * float(np.percentile(lat, 50)) if lat
            else 0.0,
            "p95_latency_ms": 1e3 * float(np.percentile(lat, 95)) if lat
            else 0.0,
            "uncoarsen_executables": fleet_signature_count(),
            "compile_cache": cache_stats().snapshot(),
        }


def serve_signatures(dispatch_log) -> set:
    """Distinct level signatures a serve run must have run — (lanes, T,
    fine rung, coarse rung, c, ell width, k, backend), the rule of
    :func:`~repro_torch.core.partition.level_signatures` lifted to the
    dispatch log.  With the fixed-lanes discipline this collapses to one
    signature per (rung, k): lanes and T never vary within a server."""
    sigs = set()
    for d in dispatch_log:
        for b in d["buckets"]:
            sigs |= level_signatures(
                b["lanes"], d["trials"], b["level_stats"], k=d["k"],
                backend=d["backend"], c_finest=d["c_finest"],
                c_coarse=d["c_coarse"])
    return sigs
