"""Shared cases for the end-to-end parity tests of the PyTorch port.

Each case is one small graph × connectivity backend × k, partitioned with
T=2 trials and ``coarse_target=64`` by both packages; a few more cases
coarsen in host mode (a ``_host`` suffix on the name).  :func:`summary`
reduces a result to the integers the tests compare (cut, per-trial cuts
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


def panel(n: int, d: int, k: int, t: int | None, seed: int):
    """A random jet_gain ELL panel as numpy (nbr_parts, wgt, parts).

    Weights in [0, 3) make many ties; every 16th row is a ghost row (all
    slots part k, weight 0, own part k) and every 16th row from the 8th on
    touches only its own part.  ``t=None`` gives the unbatched (N, D) form.
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


SEGMENT_KINDS = ("one", "each", "span", "empty", "drop")


def segment_case(m: int, f: int, kind: str, dtype, seed: int, device):
    """A segment_reduce panel as torch tensors (data (m, f), seg_ids (m,),
    num_segments) made on ``device`` from ``seed``.

    kind: ``one`` all rows in one segment; ``each`` every row its own;
    ``span`` four segments, so runs span many tiles; ``empty`` 4m+7
    segments, most of them empty; ``drop`` a third of the rows carry ids
    >= num_segments.  int32 values cover the whole range, so sums wrap.
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
    else:
        raise ValueError(f"unknown segment case kind {kind!r}")
    seg = torch.sort(seg).values.int()
    if dtype == torch.int32:
        data = torch.randint(-2**31, 2**31, (m, f), dtype=torch.int64, **kw)
        data = data.int()
    else:
        data = torch.randn(m, f, **kw)
    return data, seg, s


def load_golden() -> dict:
    return json.loads(GOLDEN.read_text())["cases"]


def write_golden() -> None:
    cases = {name: summary(jax_result(name)) for name in all_cases()}
    GOLDEN.write_text(json.dumps({
        "about": "JAX reference summaries of the port's small partition "
                 "parity cases; regenerate with "
                 "`PYTHONPATH=src python tests/torch_parity.py --write`",
        "trials": TRIALS, "coarse_target": COARSE_TARGET,
        "graphs": {g: f"{fn}{args}" for g, (fn, args) in GRAPHS.items()},
        "cases": cases,
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
    if sys.argv[1:] != ["--write"]:
        raise SystemExit(f"usage: {sys.argv[0]} --write | --suite [name ...]")
    write_golden()
