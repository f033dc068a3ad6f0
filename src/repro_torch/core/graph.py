"""Padded CSR graph container — the core data structure of the Jet partitioner.

Counterpart of ``repro.core.graph``: every array is an int32 tensor of a
static (padded) length, and the true sizes ``n`` (vertices) and ``m``
(directed edges) ride along as 0-d int32 tensors.  Padding vertices have
weight 0 and degree 0; padding edges have weight 0 and src/dst 0, so every
weighted reduction ignores them for free.  Count-style reductions apply
:meth:`Graph.edge_mask` / :meth:`Graph.vertex_mask`.

Each undirected edge is stored twice; ``esrc[e]`` is the source vertex of
directed edge ``e``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _fit(a: torch.Tensor, size: int, edge: bool = False) -> torch.Tensor:
    """Slice or pad a 1-D tensor to a static length (zeros, or its last value)."""
    cur = a.shape[0]
    if size <= cur:
        return a[:size]
    fill = a[-1:] if edge else torch.zeros(1, dtype=a.dtype, device=a.device)
    return torch.cat([a, fill.expand(size - cur)])


class Graph(NamedTuple):
    """Padded CSR graph. Shapes: xadj (N+1,), adjncy/adjwgt/esrc (M,), vwgt (N,)."""

    xadj: torch.Tensor    # int32 (N+1,) row offsets; xadj[v+1]==xadj[v] for pads
    adjncy: torch.Tensor  # int32 (M,) neighbor (dst) ids; 0 for padding edges
    adjwgt: torch.Tensor  # int32 (M,) edge weights; 0 for padding edges
    vwgt: torch.Tensor    # int32 (N,) vertex weights; 0 for padding vertices
    esrc: torch.Tensor    # int32 (M,) source vertex of each directed edge
    n: torch.Tensor       # int32 0-d, true vertex count (n <= N)
    m: torch.Tensor       # int32 0-d, true directed edge count (m <= M)

    @property
    def n_max(self) -> int:
        return self.vwgt.shape[0]

    @property
    def m_max(self) -> int:
        return self.adjncy.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vwgt.device

    def to(self, device) -> "Graph":
        return Graph(*(a.to(device) for a in self))

    def vertex_mask(self) -> torch.Tensor:
        return torch.arange(self.n_max, device=self.device) < self.n

    def edge_mask(self) -> torch.Tensor:
        return torch.arange(self.m_max, device=self.device) < self.m

    def degrees(self) -> torch.Tensor:
        return self.xadj[1:] - self.xadj[:-1]

    def total_vweight(self) -> torch.Tensor:
        return self.vwgt.sum(dtype=torch.int32)

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
    counts = torch.zeros(n_max, dtype=torch.int32, device=dev)
    counts.index_add_(0, torch.where(valid, cu, 0).long(), valid.int())
    xadj = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(counts, 0).int()])
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
