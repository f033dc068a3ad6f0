"""Shared cases for the end-to-end parity tests of the PyTorch port.

Each case is one small graph × connectivity backend × k, partitioned with
T=2 trials and ``coarse_target=64`` by both packages; a few more cases
coarsen in host mode (a ``_host`` suffix on the name).  The fleet cases
(``fleet_<backend>_k<k>_t<T>``) hold the reference fleet test's graphs
(grids 13x13, 12x12, 8x8, and 8x8 over-padded to n_max = m_max = 1024),
each partitioned standalone by the reference: a port fleet member must
equal its member's summary (:func:`member_summary`).  The serve cases
(``serve_<backend>``) hold ``tests/test_serve.py``'s burst (grids 6x6, 6x5
and 4x4 at k = 2, 2, 3 on the (64, 256) ladder, two lanes): the
reference's standalone member summaries and its server's dispatch log.
:func:`summary` reduces a result to the integers the tests compare (cut, per-trial cuts
and balance, best trial, per-level stats, sha256 of the parts arrays); the
same summaries of the JAX reference are committed as
``src/repro_torch/_golden/partition_small.json`` for runs on a machine
without JAX.  Regenerate that file from a live JAX run with

    PYTHONPATH=src python tests/torch_parity.py --write

Parity at the sizes of ``benchmarks/graphs_suite.py`` (too slow for the
suite) is a manual check that prints EQUAL or DIFFER per family and
backend:

    PYTHONPATH=src:. python tests/torch_parity.py --suite [name ...]
"""
from __future__ import annotations

import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

GOLDEN = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
          / "_golden" / "partition_small.json")

GRAPHS = {
    "grid16": ("grid2d", (16, 16)),
    "cube8": ("grid3d", (8, 8, 8)),
    "rmat9": ("rmat", (9,)),
}
BACKENDS = ("dense", "sorted", "ell")
KS = (2, 8)
TRIALS = 2
COARSE_TARGET = 64
HOST_CASES = ("grid16_dense_k8_host", "rmat9_sorted_k8_host")
FLEET = ((13, 13), (12, 12), (8, 8))  # tests/test_fleet.py's fleet
FLEET_OVERPAD = 1024                  # and its over-padded 8x8 member
FLEET_KS = (2, 8, 33)
FLEET_TRIALS = (1, 2)
FLEET_CONFIG = dict(coarse_target=48, max_iter=30, patience=3)
SERVE_BURST = (((6, 6), 2), ((6, 5), 2), ((4, 4), 3))  # (grid sides, k)
SERVE_CONFIG = dict(k=2, coarse_target=32, max_iter=30, patience=3)
# a window far longer than the burst's arrival span, so the whole burst
# is one batch (two dispatches: k = 2 and k = 3) on any machine
SERVE_SERVER = dict(ladder_n=64, ladder_m=256, window_s=0.25, lanes=2)


def case_names(graph: str, backends=BACKENDS) -> list[str]:
    return [f"{graph}_{b}_k{k}" for b in backends for k in KS]


def all_cases() -> list[str]:
    return [n for g in GRAPHS for n in case_names(g)] + list(HOST_CASES)


def parse(name: str):
    """(graph, backend, k, coarsen_mode) of a case name."""
    graph, backend, k, *host = name.split("_")
    return graph, backend, int(k[1:]), "host" if host else "device"


def make_graph(gen_module, graph: str):
    fn, args = GRAPHS[graph]
    return getattr(gen_module, fn)(*args)


def config_kwargs(name: str) -> dict:
    _, backend, k, mode = parse(name)
    return dict(k=k, trials=TRIALS, coarse_target=COARSE_TARGET,
                backend=backend, coarsen_mode=mode)


def fleet_case_names() -> list[str]:
    return [f"fleet_{b}_k{k}_t{t}" for b in BACKENDS for k in FLEET_KS
            for t in FLEET_TRIALS]


def fleet_config_kwargs(name: str) -> dict:
    _, backend, k, t = name.split("_")
    return dict(k=int(k[1:]), trials=int(t[1:]), backend=backend,
                **FLEET_CONFIG)


def fleet_graphs(graph_module, gen_module) -> list:
    """The fleet's graphs, made with either package's modules."""
    n, edges, ew, vw = graph_module.graph_to_host(gen_module.grid2d(8, 8))
    over = graph_module.build_csr_host(n, edges, ew, vw, n_max=FLEET_OVERPAD,
                                       m_max=FLEET_OVERPAD)
    return [gen_module.grid2d(a, b) for a, b in FLEET] + [over]


def serve_case_names() -> list[str]:
    return [f"serve_{b}" for b in BACKENDS]


def serve_config(serve, part, name: str):
    """The ``ServeConfig`` of a serve case, made with either package's
    ``partition_serve`` and ``partition`` modules."""
    return serve.ServeConfig(partition=part.PartitionConfig(
        backend=name.split("_")[1], **SERVE_CONFIG), **SERVE_SERVER)


def serve_burst(gen_module) -> list:
    """The burst's (graph, k) requests, made with either package's
    generators."""
    return [(gen_module.grid2d(*sides), k) for sides, k in SERVE_BURST]


def run_burst(server, burst) -> list:
    """Submit every request of the burst at once; the responses in order."""
    import asyncio

    async def run():
        async with server:
            return await asyncio.gather(
                *(server.submit(g, k=k) for g, k in burst))

    return asyncio.run(run())


def jax_serve_case(name: str) -> dict:
    """The reference's standalone member summaries of a serve case's burst
    and its server's dispatch log for the same burst."""
    from dataclasses import replace

    from repro.core import partition as jpa
    from repro.data import graphs as gen
    from repro.launch import partition_serve as jps

    scfg = serve_config(jps, jpa, name)
    burst = serve_burst(gen)
    server = jps.PartitionServer(scfg)
    run_burst(server, burst)
    return {
        "members": [member_summary(jpa.partition(g, replace(scfg.partition,
                                                            k=k)))
                    for g, k in burst],
        "dispatch_log": json.loads(json.dumps(list(server.dispatch_log))),
    }


def member_summary(res) -> dict:
    """:func:`summary` of a fleet member or a standalone run, comparable
    across the two: only the levels the graph's own hierarchy has, without
    the capacities (a bucket's ladder differs from the standalone one)."""
    out = summary(res)
    out["level_stats"] = [
        {kk: v for kk, v in st.items()
         if kk not in ("n_max", "m_max", "active")}
        for st in res.level_stats if st.get("active", True)]
    return out


def sha(a) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a), dtype="<i4").tobytes()).hexdigest()


def summary(res) -> dict:
    """The integers of a PartitionResult that parity holds exactly."""
    return {
        "cut": int(res.cut),
        "trial_cuts": [int(x) for x in res.trial_cuts],
        "trial_balanced": [bool(x) for x in res.trial_balanced],
        "best_trial": int(res.best_trial),
        "balanced": bool(res.balanced),
        "levels": int(res.levels),
        "level_stats": res.level_stats,
        "parts_sha256": sha(_np(res.parts)),
        "trial_parts_sha256": sha(_np(res.trial_parts)),
    }


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


@functools.lru_cache(maxsize=None)
def jax_result(name: str):
    from repro.core.partition import PartitionConfig, partition
    from repro.data import graphs as gen

    return partition(make_graph(gen, parse(name)[0]),
                     PartitionConfig(**config_kwargs(name)))


@functools.lru_cache(maxsize=None)
def torch_result(name: str, device: str = "cpu"):
    from repro_torch.core.partition import PartitionConfig, partition
    from repro_torch.data import graphs as gen

    return partition(make_graph(gen, parse(name)[0]),
                     PartitionConfig(**config_kwargs(name)), device=device)


def assert_matches_reference(name: str) -> None:
    """The port's CPU result of a case equals the live JAX result exactly."""
    got, want = torch_result(name), jax_result(name)
    np.testing.assert_array_equal(_np(got.parts), _np(want.parts))
    np.testing.assert_array_equal(_np(got.trial_parts), _np(want.trial_parts))
    assert summary(got) == summary(want)
    assert got.imbalance == want.imbalance


def panel(n: int, d: int, k: int, t: int | None, seed: int,
          odd: bool = False):
    """A random jet_gain ELL panel as numpy (nbr_parts, wgt, parts).

    Weights in [0, 3) make many ties; every 16th row is a ghost row (all
    slots part k, weight 0, own part k) and every 16th row from the 8th on
    touches only its own part.  With ``odd``, every 16th row from the 4th on
    also carries part ids outside [0, k] in every other slot, and every 16th
    row from the 12th on has zero weights, so all its parts tie at
    connectivity 0.  ``t=None`` gives the unbatched (N, D) form.
    """
    rng = np.random.default_rng(seed)
    shape = (n, d) if t is None else (t, n, d)
    nbr_parts = rng.integers(0, k + 1, shape).astype(np.int32)
    wgt = rng.integers(0, 3, (n, d)).astype(np.int32)
    parts = rng.integers(0, k, shape[:-1]).astype(np.int32)
    nbr_parts[..., 8::16, :] = parts[..., 8::16, None]
    nbr_parts[..., ::16, :] = k
    parts[..., ::16] = k
    wgt[::16] = 0
    if odd:
        ids = np.array([-2**31, -7, -1, k + 1, k + 100, 2**31 - 1])
        nbr_parts[..., 4::16, ::2] = rng.choice(
            ids, nbr_parts[..., 4::16, ::2].shape).astype(np.int32)
        wgt[12::16] = 0
    return nbr_parts, wgt, parts


def pow2_window_floats() -> np.ndarray:
    """Every float32 x = float32(loss) of an int32 loss within 4096 ulps
    of a power of two 2^j, j = 0..31: the only places where a float32
    floor(log2) can go wrong."""
    xs = []
    for j in range(32):
        c = int(np.float32(2.0**j).view(np.int32))
        x = np.arange(c - 4096, c + 4097, dtype=np.int32).view(np.float32)
        xs.append(x[(x >= 1) & (x <= 2.0**31) & (x == np.floor(x))])
    return np.unique(np.concatenate(xs))


def slot_losses() -> np.ndarray:
    """The int32 losses on which the port's slot() is held to the
    reference's: all of [-2^16, 2^22], and one loss for each of
    :func:`pow2_window_floats` (2^31 itself is float32(INT_MAX))."""
    x = np.minimum(pow2_window_floats().astype(np.float64), 2**31 - 1)
    return np.unique(np.concatenate([
        np.arange(-2**16, 2**22 + 1), x.astype(np.int64)])).astype(np.int32)


SEGMENT_KINDS = ("one", "each", "span", "empty", "drop", "ghost")


def segment_case(m: int, f: int, kind: str, dtype, seed: int, device):
    """A segment_reduce panel as torch tensors (data (m, f), seg_ids (m,),
    num_segments) made on ``device`` from ``seed``; float data is normal,
    made in float32 and rounded to ``dtype``.

    kind: ``one`` all rows in one segment; ``each`` every row its own;
    ``span`` four segments, so runs span many tiles; ``empty`` 4m+7
    segments, most of them empty; ``drop`` a third of the rows carry ids
    >= num_segments; ``ghost`` short runs over a fifth of the rows, then one
    run at id num_segments - 1 over the rest, as the sorted backend's sums
    by run vertex give it (the ghost vertex).  int32 values cover the whole
    range, so sums wrap.
    """
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, generator=gen)
    if kind == "one":
        s, seg = 1, torch.zeros(m, dtype=torch.int64, device=device)
    elif kind == "each":
        s, seg = m, torch.arange(m, device=device)
    elif kind == "span":
        s = 4
        seg = torch.multinomial(torch.tensor([7.0, 1, 1, 1], device=device),
                                m, replacement=True, generator=gen)
    elif kind == "empty":
        s = 4 * m + 7
        seg = torch.randint(0, s, (m,), **kw)
    elif kind == "drop":
        s = max(2 * m // 3, 1)
        seg = torch.randint(0, s + m // 3 + 1, (m,), **kw)
    elif kind == "ghost":
        s = m // 4 + 2
        seg = torch.full((m,), s - 1, dtype=torch.int64, device=device)
        seg[:m // 5] = torch.randint(0, s - 1, (m // 5,), **kw)
    else:
        raise ValueError(f"unknown segment case kind {kind!r}")
    seg = torch.sort(seg).values.int()
    if dtype == torch.int32:
        data = torch.randint(-2**31, 2**31, (m, f), dtype=torch.int64, **kw)
        data = data.int()
    else:
        data = torch.randn(m, f, **kw).to(dtype)
    return data, seg, s


def segment_error_ratio(got, want, data, seg, s) -> float:
    """The largest |kernel - plain| of a float segment_reduce result over
    its tolerance: 1e-5 + 1e-5 * (the sum of |x| over the segment), the
    float32 sums' order, plus for bfloat16 and float16 one rounding step of
    the output, eps * max(|kernel|, |plain|).  At most 1 passes."""
    import torch

    from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref

    g, w = got.float(), want.float()
    bound = 1e-5 + 1e-5 * segment_sum_sorted_ref(data.float().abs(), seg, s)
    if got.dtype in (torch.bfloat16, torch.float16):
        bound = bound + torch.finfo(got.dtype).eps * torch.maximum(
            g.abs(), w.abs())
    return float(((g - w).abs() / bound).max()) if got.numel() else 0.0


def fm_error_ratio(got, want, emb) -> float:
    """The largest |kernel - plain| of an fm_interaction result over its
    tolerance, 1e-5 + 1e-5 * (the row's sum of e^2): the terms s^2 and sq
    cancel, so an error of a few float32 roundings of their size is
    expected.  At most 1 passes."""
    e = emb.float()
    bound = 1e-5 + 1e-5 * (e * e).sum(dim=(1, 2))
    return float(((got - want).abs() / bound).max()) if got.numel() else 0.0


def flash_error_ratio(got, want) -> float:
    """The largest |kernel - plain| of a flash_attention output over its
    tolerance: 2e-5 + 2e-5 * |plain| in float32 (the softmax and the
    products run in another order), 1e-5 + 1e-2 * |plain| in bfloat16 and
    float16 (one step of the output's rounding).  At most 1 passes."""
    import torch

    rel, floor = (2e-5, 2e-5) if got.dtype == torch.float32 else (1e-2, 1e-5)
    w = want.float()
    return float(((got.float() - w).abs() / (floor + rel * w.abs())).max()) \
        if got.numel() else 0.0


# (H, Hkv, Sq, Skv, causal, window, q_offset): ragged tiles, Sq != Skv with
# an offset, non-causal, a 512 window, rows that see no key (a negative
# offset, or a window past the last key), one query against a long cache
FLASH_SHAPES = (
    (4, 4, 200, 200, True, 0, 0),
    (4, 1, 130, 300, True, 16, 170),
    (4, 4, 77, 77, False, 0, 0),
    (4, 1, 96, 600, False, 512, 520),
    (4, 1, 100, 50, True, 0, -30),
    (4, 4, 64, 70, False, 16, 80),
    (4, 1, 1, 1000, True, 512, 999),
)
# (D, Dv): values of a width of their own, as MLA's (192, 128); 36 and 8
# are no multiple of 16, so the tiles' zero padding differs between the two
FLASH_DV = ((24, 16), (192, 128), (36, 8))


def qkv(b, h, hkv, sq, skv, d, dtype, seed: int, device, dv=None):
    """Random q (b, h, sq, d), k (b, hkv, skv, d) and v (b, hkv, skv, dv)
    (dv defaults to d) made on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, h, sq, d), (b, hkv, skv, d),
                          (b, hkv, skv, dv or d))]


GNN_ARCHS = ("meshgraphnet", "graphsage-reddit", "schnet", "nequip")
GNN_LABEL = {"meshgraphnet": "target", "graphsage-reddit": "labels",
             "schnet": "energy", "nequip": "energy"}


def gnn_batch(arch_id: str, cfg, seed: int, n: int = 24, e: int = 80,
              g: int = 3) -> dict:
    """A GNN batch as numpy arrays (a cell's batch dict: node_feat,
    senders, receivers, pos, graph_id and the arch's label), made from
    ``seed``: N = n nodes of which the last 4 are pad nodes (graph_id g),
    e edges in [0, n] (index n is the ghost) with the first 5 aimed at node
    0; molecular species include ids to truncate and to clip."""
    rng = np.random.default_rng(seed)
    pad = 4
    b = {
        "senders": rng.integers(0, n + 1, e).astype(np.int32),
        "receivers": rng.integers(0, n + 1, e).astype(np.int32),
        "graph_id": np.concatenate([np.sort(rng.integers(0, g, n - pad)),
                                    np.full(pad, g)]).astype(np.int32),
        "pos": (rng.random((n, 3)) * 2.0).astype(np.float32),
    }
    b["receivers"][:5] = 0
    if arch_id in ("schnet", "nequip"):
        z = rng.integers(0, cfg.n_species, n).astype(np.float32)
        z[:3] = [-1.5, cfg.n_species + 3, 2.7]
        b["node_feat"] = z[:, None]
        b["energy"] = rng.standard_normal(g).astype(np.float32)
    else:
        b["node_feat"] = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
        if arch_id == "graphsage-reddit":
            labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
            labels[::3] = -1
            b["labels"] = labels
        else:
            b["target"] = rng.standard_normal((n, 2)).astype(np.float32)
    return b


def load_golden() -> dict:
    return json.loads(GOLDEN.read_text())["cases"]


def load_golden_fleet() -> dict:
    """Per fleet case, the reference's standalone member summaries."""
    return json.loads(GOLDEN.read_text())["fleet"]


def load_golden_serve() -> dict:
    """Per serve case, :func:`jax_serve_case`'s record."""
    return json.loads(GOLDEN.read_text())["serve"]


def jax_fleet_members(name: str) -> list:
    """The reference's standalone ``partition()`` of each fleet member."""
    from repro.core import graph as gr
    from repro.core.partition import PartitionConfig, partition
    from repro.data import graphs as gen

    cfg = PartitionConfig(**fleet_config_kwargs(name))
    return [partition(g, cfg) for g in fleet_graphs(gr, gen)]


def _case_in_subprocess(name: str):
    """A fleet case's :func:`jax_fleet_members` summaries, or a serve
    case's :func:`jax_serve_case`, from a process of their own: one process
    that compiles every case's programs runs XLA's CPU compiler out of
    memory."""
    out = subprocess.run([sys.executable, __file__, "--case", name],
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.splitlines()[-1])


def write_golden() -> None:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(3) as pool:
        names = fleet_case_names()
        fleet = dict(zip(names, pool.map(_case_in_subprocess, names)))
        names = serve_case_names()
        serve = dict(zip(names, pool.map(_case_in_subprocess, names)))
    cases = {name: summary(jax_result(name)) for name in all_cases()}
    GOLDEN.write_text(json.dumps({
        "about": "JAX reference summaries of the port's small partition "
                 "parity cases; regenerate with "
                 "`PYTHONPATH=src python tests/torch_parity.py --write`",
        "trials": TRIALS, "coarse_target": COARSE_TARGET,
        "graphs": {g: f"{fn}{args}" for g, (fn, args) in GRAPHS.items()},
        "cases": cases,
        "fleet_graphs": "grid2d 13x13, 12x12, 8x8; grid2d 8x8 at n_max = "
                        f"m_max = {FLEET_OVERPAD}",
        "fleet_config": FLEET_CONFIG,
        "fleet": fleet,
        "serve_burst": "grid2d 6x6, 6x5 at k=2 and 4x4 at k=3; config "
                       f"{SERVE_CONFIG}, server {SERVE_SERVER}",
        "serve": serve,
    }, indent=1) + "\n")


def suite_parity(names) -> bool:
    """graphs_suite families at bench_partitioner's trials_ab config (k=8,
    T=4, coarse_target=512), JAX against the port on the CPU."""
    from benchmarks import graphs_suite
    from repro.core import partition as jpa
    from repro_torch.core import partition as pa
    from repro_torch.core.graph import from_numpy_arrays

    ok = True
    for name in names or graphs_suite.SUITE:
        jg = graphs_suite.load(name)
        tg = from_numpy_arrays(*(np.asarray(a) for a in jg))
        for backend in BACKENDS:
            kw = dict(k=8, trials=4, coarse_target=512, backend=backend)
            got = summary(pa.partition(tg, pa.PartitionConfig(**kw),
                                       device="cpu"))
            want = summary(jpa.partition(jg, jpa.PartitionConfig(**kw)))
            ok &= got == want
            print(name, backend, "EQUAL" if got == want else "DIFFER",
                  "cut", got["cut"], want["cut"], "trial_cuts",
                  got["trial_cuts"], want["trial_cuts"], flush=True)
    return ok


if __name__ == "__main__":
    if sys.argv[1:2] == ["--suite"]:
        raise SystemExit(0 if suite_parity(sys.argv[2:]) else 1)
    if sys.argv[1:2] == ["--case"]:
        name = sys.argv[2]
        print(json.dumps(jax_serve_case(name) if name.startswith("serve_")
                         else [member_summary(r)
                               for r in jax_fleet_members(name)]))
        raise SystemExit(0)
    if sys.argv[1:] != ["--write"]:
        raise SystemExit(f"usage: {sys.argv[0]} --write | --suite [name ...]")
    write_golden()
