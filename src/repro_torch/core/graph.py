"""Padded CSR graph container — the core data structure of the Jet partitioner.

Counterpart of ``repro.core.graph``: every array is an int32 tensor of a
static (padded) length, and the true sizes ``n`` (vertices) and ``m``
(directed edges) ride along as int32 tensors.  Padding vertices have
weight 0 and degree 0; padding edges have weight 0 and src/dst 0, so every
weighted reduction ignores them for free.  Count-style reductions apply
:meth:`Graph.edge_mask` / :meth:`Graph.vertex_mask`.

Each undirected edge is stored twice; ``esrc[e]`` is the source vertex of
directed edge ``e``.

A fleet (DESIGN.md §10) stacks graphs of one capacity along a leading lane
axis: every array is then ``(B, ...)`` and ``n``/``m`` are ``(B,)``.  The
methods below read the last axis, so they serve both forms; per-trial state
of the partitioner is ``(*lanes, T, ...)`` and meets the graph's arrays
through :func:`trial_axis` and :func:`take`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import trace


def _fit(a: torch.Tensor, size: int, edge: bool = False) -> torch.Tensor:
    """Slice or pad the last axis to a static length (zeros, or its last
    value)."""
    cur = a.shape[-1]
    if size <= cur:
        return a[..., :size].contiguous()
    fill = a[..., -1:] if edge else torch.zeros(
        (*a.shape[:-1], 1), dtype=a.dtype, device=a.device)
    return torch.cat([a, fill.expand(*a.shape[:-1], size - cur)], -1)


def trial_axis(x: torch.Tensor, ndim: int, at: int = -2) -> torch.Tensor:
    """``x`` with singleton axes inserted at ``at`` until it has ``ndim``
    axes: a graph array ``(*lanes, N)`` made to broadcast against per-trial
    state ``(*lanes, T, N)`` (``at=-3`` for ELL panels ``(*lanes, N, D)``)."""
    while x.dim() < ndim:
        x = x.unsqueeze(at)
    return x


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` per lane: ``x`` is ``(*lanes, [T,] N)`` and ``idx``
    a graph index ``(*lanes, M)``; returns ``(*lanes, [T,] M)``."""
    idx = trial_axis(idx.long(), x.dim())
    return x.gather(-1, idx.expand(*x.shape[:-1], idx.shape[-1]))


class Graph(NamedTuple):
    """Padded CSR graph. Shapes: xadj (N+1,), adjncy/adjwgt/esrc (M,), vwgt
    (N,); a stacked fleet bucket has a leading (B,) axis on every field."""

    xadj: torch.Tensor    # int32 (N+1,) row offsets; xadj[v+1]==xadj[v] for pads
    adjncy: torch.Tensor  # int32 (M,) neighbor (dst) ids; 0 for padding edges
    adjwgt: torch.Tensor  # int32 (M,) edge weights; 0 for padding edges
    vwgt: torch.Tensor    # int32 (N,) vertex weights; 0 for padding vertices
    esrc: torch.Tensor    # int32 (M,) source vertex of each directed edge
    n: torch.Tensor       # int32 0-d (or (B,)), true vertex count (n <= N)
    m: torch.Tensor       # int32 0-d (or (B,)), true directed edge count

    @property
    def n_max(self) -> int:
        return self.vwgt.shape[-1]

    @property
    def m_max(self) -> int:
        return self.adjncy.shape[-1]

    @property
    def lanes(self) -> tuple:
        """``()`` for one graph, ``(B,)`` for a stacked bucket."""
        return tuple(self.vwgt.shape[:-1])

    @property
    def device(self) -> torch.device:
        return self.vwgt.device

    def to(self, device) -> "Graph":
        return Graph(*(a.to(device) for a in self))

    def vertex_mask(self) -> torch.Tensor:
        return torch.arange(self.n_max, device=self.device) < \
            self.n.unsqueeze(-1)

    def edge_mask(self) -> torch.Tensor:
        return torch.arange(self.m_max, device=self.device) < \
            self.m.unsqueeze(-1)

    def degrees(self) -> torch.Tensor:
        return self.xadj[..., 1:] - self.xadj[..., :-1]

    def total_vweight(self) -> torch.Tensor:
        return self.vwgt.sum(-1, dtype=torch.int32)

    def with_capacity(self, n_max: int, m_max: int) -> "Graph":
        """Re-bucket to new padded capacities (requires n <= n_max, m <= m_max).

        The grown ``xadj`` tail repeats ``xadj[-1] == m``; grown edge and
        vertex arrays are zero.
        """
        return Graph(
            xadj=_fit(self.xadj, n_max + 1, edge=True),
            adjncy=_fit(self.adjncy, m_max),
            adjwgt=_fit(self.adjwgt, m_max),
            vwgt=_fit(self.vwgt, n_max),
            esrc=_fit(self.esrc, m_max),
            n=self.n,
            m=self.m,
        )


# ---------------------------------------------------------------------------
# Fleet batching — stacked graphs and shape buckets (DESIGN.md §10)
# ---------------------------------------------------------------------------

def stack_graphs(graphs: "list[Graph]") -> Graph:
    """Stack same-capacity graphs along a leading lane axis: every field of
    the result is ``(B, ...)``."""
    if not graphs:
        raise ValueError("stack_graphs needs at least one graph")
    cap = (graphs[0].n_max, graphs[0].m_max)
    for g in graphs[1:]:
        if (g.n_max, g.m_max) != cap:
            raise ValueError(
                f"stack_graphs needs uniform capacities, got {cap} vs "
                f"{(g.n_max, g.m_max)} — re-bucket with with_capacity first"
            )
    return Graph(*(torch.stack([getattr(g, f) for g in graphs])
                   for f in Graph._fields))


def unstack_graph(gb: Graph, b: int) -> Graph:
    """Member ``b`` of a stacked graph (a view, no copy)."""
    return Graph(*(leaf[b] for leaf in gb))


def bucket_graphs(
    graphs: "list[Graph]",
    ratio: float = 1.6,
    safety: float = 1.25,
    stall_ratio: float = 0.95,
    align: int = 64,
    schedule: "tuple[tuple[int, int], ...] | None" = None,
):
    """Group a fleet of graphs into static shape buckets on a shared ladder.

    Builds ONE capacity ladder spanning the whole fleet (top rung = fleet
    max, aligned to ``align``) and assigns each graph the smallest fitting
    ``(n_cap, m_cap)`` rung pair, chosen per axis like
    :func:`~repro_torch.core.coarsen.select_capacity`.  Graphs of different
    true sizes share a bucket whenever they round to the same rungs.

    With ``schedule`` given, assignment runs on the caller's fixed ladder,
    so rung pairs stay stable across calls (the serving contract, DESIGN.md
    §11); a graph above the ladder's top rung raises ``ValueError``.

    Returns ``(schedule, buckets)``: ``buckets`` maps a capacity pair to the
    list of graph indices assigned to it (in order of first member).  One
    host read fetches every graph's (n, m).
    """
    from repro_torch.core.coarsen import (_round_up, select_capacity,
                                          shape_schedule)

    if not graphs:
        raise ValueError("bucket_graphs needs at least one graph")
    sizes = trace.read("fleet.sizes", torch.stack([
        torch.stack([g.n, g.m]) for g in graphs]).tolist)
    if schedule is None:
        n_top = _round_up(max(max(n for n, _ in sizes), 1), align)
        m_top = _round_up(max(max(m for _, m in sizes), 1), align)
        schedule = shape_schedule(n_top, m_top, ratio=ratio, safety=safety,
                                  stall_ratio=stall_ratio, align=align)
    else:
        n_top = max(nc for nc, _ in schedule)
        m_top = max(mc for _, mc in schedule)
        for i, (n, m) in enumerate(sizes):
            if n > n_top or m > m_top:
                raise ValueError(
                    f"graph {i} (n={n}, m={m}) exceeds the fixed ladder's "
                    f"top rung ({n_top}, {m_top}) — raise the ladder or "
                    "partition it standalone"
                )
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, (n, m) in enumerate(sizes):
        buckets.setdefault(select_capacity(schedule, n, m), []).append(i)
    return schedule, buckets


def stack_bucket(graphs: "list[Graph]", cap: tuple) -> Graph:
    """Re-pad each graph to ``cap`` (where it differs) and stack them."""
    return stack_graphs([g if (g.n_max, g.m_max) == cap
                         else g.with_capacity(*cap) for g in graphs])


class StackedBucket(NamedTuple):
    """One pre-stacked shape bucket, ready for ``partition_fleet_stacked``.

    ``graph`` is a stacked ``(B, ...)`` :class:`Graph` at ``capacity``;
    ``tags`` carries one caller id per lane (``None`` marks a filler lane —
    a real graph stacked only to pin the batch width, whose result the
    partitioner drops); ``orig_n_max`` records each lane's own padding so
    results can be restored to the caller's shape contract.
    """

    capacity: tuple
    graph: Graph
    tags: tuple
    orig_n_max: tuple


class BucketAssembler:
    """Incremental bucket assembly on a FIXED capacity ladder (§11 serving).

    ``add`` queues graphs host-side (no device work); ``flush`` makes ONE
    host read of every queued (n, m), assigns each graph its smallest
    fitting rung pair on the pinned ladder, re-pads members with
    :meth:`Graph.with_capacity`, and returns stacked buckets, largest
    capacity first.

    ``lanes`` pins every flushed bucket to a fixed batch width: buckets
    with fewer members are padded with filler copies of their first member
    (``tags`` entry ``None``), buckets with more are split into
    ``lanes``-wide chunks.  ``lanes=None`` stacks each bucket at its
    natural occupancy (the ``partition_fleet`` behaviour).
    """

    def __init__(self, schedule, lanes: "int | None" = None):
        if lanes is not None and lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self.schedule = tuple(schedule)
        self.lanes = lanes
        self._pending: list = []  # (tag, Graph)

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, tag, g: Graph) -> None:
        self._pending.append((tag, g))

    def flush(self) -> "list[StackedBucket]":
        if not self._pending:
            return []
        tags = [t for t, _ in self._pending]
        graphs = [g for _, g in self._pending]
        self._pending = []
        _, bucket_map = bucket_graphs(graphs, schedule=self.schedule)
        out = []
        for cap in sorted(bucket_map, reverse=True):
            idxs = bucket_map[cap]
            width = self.lanes or len(idxs)
            for lo in range(0, len(idxs), width):
                chunk = idxs[lo: lo + width]
                fill = width - len(chunk)
                out.append(StackedBucket(
                    capacity=cap,
                    graph=stack_bucket(
                        [graphs[i] for i in chunk + chunk[:1] * fill], cap),
                    tags=tuple([tags[i] for i in chunk] + [None] * fill),
                    orig_n_max=tuple([graphs[i].n_max for i in chunk]
                                     + [cap[0]] * fill),
                ))
        return out


def from_numpy_arrays(xadj, adjncy, adjwgt, vwgt, esrc, n, m,
                      device="cpu") -> Graph:
    """A :class:`Graph` from the seven arrays of a reference graph, in field
    order (as numpy arrays or scalars)."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=device)

    return Graph(t(xadj), t(adjncy), t(adjwgt), t(vwgt), t(esrc), t(n), t(m))


def csr_from_edge_runs(
    cu: torch.Tensor,
    cv: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    n_edges: torch.Tensor,
    vwgt: torch.Tensor,
    n_vertices: torch.Tensor,
    *,
    n_max: int,
    m_max: int,
) -> Graph:
    """Device-side CSR constructor from deduplicated edge runs.

    ``cu``/``cv``/``w`` are edge runs sorted lexicographically by (cu, cv)
    with all valid runs contiguous at the front (``valid`` marks them).
    ``xadj`` is a segment count plus a cumsum, all on the device.
    """
    dev = cu.device
    counts = torch.zeros((*cu.shape[:-1], n_max), dtype=torch.int32,
                         device=dev)
    counts.scatter_add_(-1, torch.where(valid, cu, 0).long(), valid.int())
    xadj = torch.cat([torch.zeros_like(counts[..., :1]),
                      torch.cumsum(counts, -1).int()], -1)
    return Graph(
        xadj=xadj,
        adjncy=_fit(torch.where(valid, cv, 0).int(), m_max),
        adjwgt=_fit(torch.where(valid, w, 0).int(), m_max),
        vwgt=_fit(vwgt.int(), n_max),
        esrc=_fit(torch.where(valid, cu, 0).int(), m_max),
        n=n_vertices.int(),
        m=n_edges.int(),
    )


def build_csr_host(
    n: int,
    edges: np.ndarray,
    eweights: np.ndarray | None = None,
    vweights: np.ndarray | None = None,
    n_max: int | None = None,
    m_max: int | None = None,
) -> Graph:
    """Host-side CSR builder from an undirected edge list of (u, v) pairs.

    Removes self loops, deduplicates parallel edges (summing weights), and
    symmetrizes.  ``edges`` is (E, 2) int; weights default to 1.  The graph
    is returned on the CPU.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if eweights is None:
        eweights = np.ones(edges.shape[0], dtype=np.int64)
    else:
        eweights = np.asarray(eweights, dtype=np.int64)
    keep = edges[:, 0] != edges[:, 1]
    edges, eweights = edges[keep], eweights[keep]
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    key = lo * n + hi
    order = np.argsort(key, kind="stable")
    key, eweights = key[order], eweights[order]
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.zeros(uniq.shape[0], dtype=np.int64)
    np.add.at(w, inv, eweights)
    lo = uniq // n
    hi = uniq % n
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    ew = np.concatenate([w, w])
    order = np.argsort(src * n + dst, kind="stable")
    src, dst, ew = src[order], dst[order], ew[order]
    m = src.shape[0]
    xadj = np.zeros(n + 1, dtype=np.int64)
    xadj[1:] = np.cumsum(np.bincount(src, minlength=n))
    if vweights is None:
        vweights = np.ones(n, dtype=np.int64)
    else:
        vweights = np.asarray(vweights, dtype=np.int64)

    n_max = int(n_max) if n_max is not None else int(n)
    m_max = int(m_max) if m_max is not None else int(m)
    if n_max < n or m_max < m:
        raise ValueError(f"capacity ({n_max}, {m_max}) below size ({n}, {m})")

    xadj_p = np.full(n_max + 1, m, dtype=np.int32)
    xadj_p[: n + 1] = xadj
    adjncy_p = np.zeros(m_max, dtype=np.int32)
    adjncy_p[:m] = dst
    adjwgt_p = np.zeros(m_max, dtype=np.int32)
    adjwgt_p[:m] = ew
    vwgt_p = np.zeros(n_max, dtype=np.int32)
    vwgt_p[:n] = vweights
    esrc_p = np.zeros(m_max, dtype=np.int32)
    esrc_p[:m] = src
    return from_numpy_arrays(xadj_p, adjncy_p, adjwgt_p, vwgt_p, esrc_p, n, m)


def graph_to_host(g: Graph) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Return (n, edges(u<v), eweights, vweights) on host, unpadded."""
    n = int(g.n)
    m = int(g.m)
    src = g.esrc[:m].cpu().numpy()
    dst = g.adjncy[:m].cpu().numpy()
    w = g.adjwgt[:m].cpu().numpy()
    keep = src < dst
    return (n, np.stack([src[keep], dst[keep]], axis=1), w[keep],
            g.vwgt[:n].cpu().numpy())


def validate_host(g: Graph) -> None:
    """Structural invariants of one graph, checked on the host (tests):
    raises ``AssertionError`` where one fails."""
    n, m = int(g.n), int(g.m)
    xadj, adjncy, adjwgt, esrc = (a.cpu().numpy() for a in (
        g.xadj, g.adjncy, g.adjwgt, g.esrc))
    assert xadj[0] == 0 and xadj[n] == m
    assert np.all(np.diff(xadj[: n + 1]) >= 0)
    assert np.all(xadj[n:] == m)
    assert np.all(adjncy[:m] >= 0) and np.all(adjncy[:m] < n)
    assert np.all(adjwgt[:m] > 0)
    assert np.all(adjwgt[m:] == 0)
    # esrc consistent with xadj
    expect_src = np.repeat(np.arange(n), np.diff(xadj[: n + 1]))
    assert np.array_equal(esrc[:m], expect_src)
    # no self loops
    assert np.all(adjncy[:m] != esrc[:m])
    # symmetric with equal weights
    fwd = {(int(u), int(v)): int(w)
           for u, v, w in zip(esrc[:m], adjncy[:m], adjwgt[:m])}
    for (u, v), w in fwd.items():
        assert fwd.get((v, u)) == w, f"asymmetric edge {(u, v)}"
