"""Vertex-part connectivity — the Jet refinement data structure (paper §4.3).

Counterpart of ``repro.core.connectivity`` for two backends:

* ``dense`` — a (T, N, k+1) connectivity matrix built by integer
  scatter-add; every query is a masked row reduction.
* ``ell``   — the graph's adjacency padded to (N, D) rows, with the
  neighbors' parts maintained per trial as (T, N, D); the Jetlp query is the
  jet_gain kernel (``kernels/jet_gain``).

The ``sorted`` backend is not ported yet: it raises ``NotImplementedError``.

Everything here is trial-batched: ``parts`` is (T, N) and every per-trial
quantity carries the leading T axis.  The graph and the ELL adjacency
(``ell_nbr``/``ell_wgt``) are shared by all trials and stay unbatched.
:class:`ConnState` is built once per level (:func:`build_state`), advanced
after each move list with Alg 4.4 deltas (:func:`apply_moves`), and rebuilt
from scratch only on the ``rebuild_every`` escape hatch
(:func:`rebuild_state`).  Integer arithmetic throughout, so incremental and
rebuilt states agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import metrics
from repro_torch.core.graph import Graph
from repro_torch.kernels.jet_gain import ops as jg

BACKENDS = ("dense", "ell")


def _check_backend(backend: str) -> None:
    if backend == "sorted":
        raise NotImplementedError(
            "the sorted connectivity backend is not ported yet; it comes with "
            "the segment_reduce kernel slice — use 'dense' or 'ell'")
    if backend not in BACKENDS:
        raise ValueError(f"unknown connectivity backend {backend!r}")


class ConnQueries(NamedTuple):
    """Per-vertex connectivity answers, all shape (T, N)."""

    conn_self: torch.Tensor   # conn(v, P_s(v))
    best_part: torch.Tensor   # argmax_{p != P_s(v)} conn(v, p); == k if none
    best_conn: torch.Tensor   # its connectivity (0 if none)


# ---------------------------------------------------------------------------
# dense backend
# ---------------------------------------------------------------------------

def conn_matrix(g: Graph, parts: torch.Tensor, k: int) -> torch.Tensor:
    """(T, N, k+1) connectivity matrix via scatter-add over directed edges.

    Column k is the ghost part; padding edges carry weight 0 so they add
    nothing wherever they land.  A part id outside [0, k] adds nothing, as
    the reference's scatter drops it.
    """
    t = parts.shape[0]
    dst_part = parts[:, g.adjncy].long()
    ok = (dst_part >= 0) & (dst_part <= k)
    flat = g.esrc.long() * (k + 1) + torch.where(ok, dst_part, 0)   # (T, M)
    mat = torch.zeros(t, g.n_max * (k + 1), dtype=torch.int32,
                      device=parts.device)
    mat.scatter_add_(1, flat, torch.where(ok, g.adjwgt, 0))
    return mat.view(t, g.n_max, k + 1)


def queries_from_matrix(mat: torch.Tensor, parts: torch.Tensor,
                        k: int) -> ConnQueries:
    own = parts.long().unsqueeze(-1)
    conn_self = mat.gather(-1, own).squeeze(-1)
    cols = torch.arange(k + 1, device=mat.device)
    masked = torch.where((cols == own) | (cols == k), -1, mat)
    best_part = torch.argmax(masked, dim=-1).int()
    best_conn = masked.amax(dim=-1)
    none = best_conn <= 0  # weights positive: conn 0 means not adjacent
    return ConnQueries(conn_self, torch.where(none, k, best_part),
                       torch.where(none, 0, best_conn))


def dense_queries(g: Graph, parts: torch.Tensor, k: int) -> ConnQueries:
    return queries_from_matrix(conn_matrix(g, parts, k), parts, k)


def ell_queries(g: Graph, parts: torch.Tensor, k: int) -> ConnQueries:
    """The jet_gain kernel over the graph's ELL adjacency."""
    nbr, wgt = jg.csr_to_ell(g)
    return ConnQueries(*jg.jet_gain(nbr, wgt, parts, k))


def queries(g: Graph, parts: torch.Tensor, k: int,
            backend: str = "dense") -> ConnQueries:
    _check_backend(backend)
    if backend == "dense":
        return dense_queries(g, parts, k)
    return ell_queries(g, parts, k)


# ---------------------------------------------------------------------------
# incremental update (paper Alg 4.4)
# ---------------------------------------------------------------------------

def update_conn_matrix(mat: torch.Tensor, g: Graph, parts_old: torch.Tensor,
                       move: torch.Tensor, dest: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Connectivity after a move list, updated source-side like the
    reference's ``update_conn_matrix_rows``: every edge whose destination
    moved takes its weight from (src, old part) and gives it to (src, new
    part).

    Two integer scatter-adds; bit-identical to the reference's one-hot
    cumsum (integer adds commute, no value overflows).  Parts outside
    [0, k] match no column there, so they move no weight here.
    """
    t = mat.shape[0]
    w = torch.where(move[:, g.adjncy], g.adjwgt, 0)
    row = g.esrc.long() * (k + 1)
    out = mat.reshape(t, -1).clone()
    for p, sign in ((parts_old[:, g.adjncy].long(), -1),
                    (dest[:, g.adjncy].long(), 1)):
        ok = (p >= 0) & (p <= k)
        out.scatter_add_(1, row + torch.where(ok, p, 0),
                         torch.where(ok, sign * w, 0))
    return out.view_as(mat)


# ---------------------------------------------------------------------------
# stateful interface — ConnState threaded through the refinement loop
# ---------------------------------------------------------------------------

class ConnState(NamedTuple):
    """Persistent per-level refinement state (paper §4.3 + Alg 4.4).

    Exactly one backend's structure is populated; the other holds an empty
    placeholder.  ``sizes`` is delta-maintained; ``cut`` is advanced by a
    one-pass edge reduction over the post-move parts.
    """

    sizes: torch.Tensor          # (T, k) int32 part weights
    cut: torch.Tensor            # (T,) int32 current cutsize
    mat: torch.Tensor            # dense: (T, N, k+1) int32; else empty
    ell_nbr: torch.Tensor        # ell: (N, D) int32 neighbor ids; else empty
    ell_wgt: torch.Tensor        # ell: (N, D) int32 edge weights; else empty
    ell_parts: torch.Tensor      # ell: (T, N, D) int32 neighbor parts; else empty
    moves_applied: torch.Tensor  # (T,) int32 move lists since last (re)build


def build_state(g: Graph, parts: torch.Tensor, k: int, backend: str = "dense",
                max_degree: int | None = None) -> ConnState:
    """Build the full state from a (T, N) parts batch (once per level).

    ``parts`` must already map padding vertices to the ghost part ``k``.
    """
    _check_backend(backend)
    empty = torch.zeros(0, dtype=torch.int32, device=parts.device)
    mat = nbr = wgt = nparts = empty
    if backend == "dense":
        mat = conn_matrix(g, parts, k)
    else:
        nbr, wgt = jg.csr_to_ell(g, max_degree)
        nparts = jg.lookup_nbr_parts(nbr, parts, k)
    return ConnState(
        sizes=metrics.part_sizes(g, parts, k),
        cut=metrics.cutsize(g, parts),
        mat=mat, ell_nbr=nbr, ell_wgt=wgt, ell_parts=nparts,
        moves_applied=torch.zeros(parts.shape[0], dtype=torch.int32,
                                  device=parts.device),
    )


def rebuild_state(g: Graph, state: ConnState, parts: torch.Tensor, k: int,
                  backend: str) -> ConnState:
    """Full refresh from ``parts`` — the ``rebuild_every`` escape hatch.

    Reuses the static ELL adjacency (it never changes within a level).
    """
    _check_backend(backend)
    upd = {"sizes": metrics.part_sizes(g, parts, k),
           "cut": metrics.cutsize(g, parts),
           "moves_applied": torch.zeros_like(state.moves_applied)}
    if backend == "dense":
        upd["mat"] = conn_matrix(g, parts, k)
    else:
        upd["ell_parts"] = jg.lookup_nbr_parts(state.ell_nbr, parts, k)
    return state._replace(**upd)


def apply_moves(g: Graph, state: ConnState, parts_old: torch.Tensor,
                move: torch.Tensor, dest: torch.Tensor, k: int,
                backend: str) -> ConnState:
    """Advance the state past one move list (paper Alg 4.4).

    Bit-exact against :func:`rebuild_state` of the post-move parts.
    """
    _check_backend(backend)
    parts_new = torch.where(move, dest, parts_old)
    upd = {"sizes": metrics.delta_part_sizes(g, state.sizes, parts_old, move,
                                             dest, k),
           "cut": metrics.cutsize(g, parts_new),  # one-pass recompute
           "moves_applied": state.moves_applied + 1}
    if backend == "dense":
        upd["mat"] = update_conn_matrix(state.mat, g, parts_old, move, dest, k)
    else:
        upd["ell_parts"] = jg.update_nbr_parts(state.ell_nbr, state.ell_parts,
                                               move, dest, k)
    return state._replace(**upd)


def state_queries(g: Graph, state: ConnState, parts: torch.Tensor, k: int,
                  backend: str) -> ConnQueries:
    """Jetlp queries from the maintained state — no rebuild, no part gather."""
    _check_backend(backend)
    if backend == "dense":
        return queries_from_matrix(state.mat, parts, k)
    return ConnQueries(*jg.jet_gain_from_parts(state.ell_parts, state.ell_wgt,
                                               parts, k))


# -- valid-destination queries (Jetrw / Jetrs) from the maintained state ----

def _colmask(valid_parts: torch.Tensor) -> torch.Tensor:
    """(T, 1, k+1) column mask: the valid parts, never the ghost column."""
    pad = torch.zeros_like(valid_parts[:, :1])
    return torch.cat([valid_parts, pad], 1).unsqueeze(1)


def _state_matrix(state: ConnState, k: int, backend: str) -> torch.Tensor:
    """A dense (T, N, k+1) view of the state for matrix-shaped queries.

    ELL rebuilds it from the maintained neighbor parts — an O(T*N*D)
    scatter, used only on (rare) rebalance iterations.
    """
    if backend == "dense":
        return state.mat
    return jg.ell_to_matrix(state.ell_parts, state.ell_wgt, k)


def rw_queries(g: Graph, state: ConnState, k: int, valid_parts: torch.Tensor,
               backend: str):
    """Jetrw: best valid-destination part per vertex: (best_conn, best_part, has)."""
    _check_backend(backend)
    masked = torch.where(_colmask(valid_parts), _state_matrix(state, k, backend),
                         -1)
    best_conn = masked.amax(dim=-1)
    best_part = torch.argmax(masked, dim=-1).int()
    has = best_conn > 0
    return best_conn.clamp(min=0), torch.where(has, best_part, k), has


def rs_queries(g: Graph, state: ConnState, k: int, valid_parts: torch.Tensor,
               backend: str):
    """Jetrs: sum and count of connectivity over adjacent valid parts."""
    _check_backend(backend)
    sel = torch.where(_colmask(valid_parts), _state_matrix(state, k, backend), 0)
    return sel.sum(-1, dtype=torch.int32), (sel > 0).sum(-1, dtype=torch.int32)
