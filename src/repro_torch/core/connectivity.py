"""Vertex-part connectivity — the Jet refinement data structure (paper §4.3).

Counterpart of ``repro.core.connectivity``, with its three backends:

* ``dense``  — a (T, N, k+1) connectivity matrix built by integer
  scatter-add; every query is a masked row reduction.
* ``sorted`` — per-edge (src, part) keys, sorted per trial; runs of equal
  keys and then runs per vertex are reduced by the segment_reduce kernel
  (``kernels/segment_reduce``).  O(T*M) memory, whatever k and the degrees.
* ``ell``    — the graph's adjacency padded to (N, D) rows, with the
  neighbors' parts maintained per trial as (T, N, D); the Jetlp query is the
  jet_gain kernel (``kernels/jet_gain``).

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
from repro_torch.core.u32 import MASK, u32
from repro_torch.kernels.jet_gain import ops as jg
from repro_torch.kernels.segment_reduce import ops as sr

BACKENDS = ("dense", "sorted", "ell")


def _check_backend(backend: str) -> None:
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


# ---------------------------------------------------------------------------
# sorted backend — O(m) memory
# ---------------------------------------------------------------------------

_INVALID = MASK  # uint32 0xFFFFFFFF: the key of a padding edge


def check_sorted(g: Graph, k: int, t: int) -> None:
    """Refuse shapes at which the sorted backend's ids would overflow.

    The reference forms ``esrc*(k+1) + part`` in uint32: past
    ``n_max*(k+1) = 2^32 - 1`` keys wrap, runs of different vertices merge
    and its connectivity is silently wrong.  The T trials' segment ids are
    offset by ``t * num_segments`` in int32.
    """
    if g.n_max * (k + 1) > MASK:
        raise ValueError(
            f"sorted backend: n_max*(k+1) = {g.n_max}*{k + 1} exceeds "
            f"2^32-1, so its uint32 (vertex, part) keys would wrap")
    if t * max(g.m_max, g.n_max + 1) >= 2**31:
        raise ValueError(
            f"sorted backend: {t} trials x {max(g.m_max, g.n_max + 1)} "
            "segments overflow its int32 segment ids")


def _segment_sum(data: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-trial sorted-segment sum of (T, M) int32 ``data`` by (T, M) ids
    in [0, num_segments) that do not decrease along each row.  One kernel
    launch for all trials: trial t's ids are offset by ``t * num_segments``,
    so the flattened ids still do not decrease.  Returns (T, num_segments).
    """
    t = data.shape[0]
    off = torch.arange(t, device=seg.device)[:, None] * num_segments
    ids = (seg.long() + off).int().reshape(-1)
    out = sr.segment_sum_sorted(data.reshape(-1, 1), ids, t * num_segments)
    return out.view(t, num_segments)


def sorted_edge_keys(g: Graph, dst_part: torch.Tensor, k: int):
    """Each trial's (src, dst_part) edge keys, sorted: ``(skey, sw,
    run_id)``, each (T, M) — the sorted uint32 keys (in int64), the edge
    weights in that order, and each position's run of equal keys."""
    check_sorted(g, k, dst_part.shape[0])
    key = (u32(g.esrc) * (k + 1) + dst_part.long()) & MASK
    key = torch.where(g.edge_mask(), key, _INVALID)
    skey, order = torch.sort(key, dim=-1, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    return skey, g.adjwgt[order], torch.cumsum(first, -1) - 1


def runs_from_dst_part(g: Graph, dst_part: torch.Tensor, k: int):
    """Sort directed edges by (src, dst_part) and segment-sum equal keys.

    ``dst_part`` is the per-edge destination part (T, M) — either gathered
    from a parts batch or maintained incrementally in a :class:`ConnState`.
    Returns ``(run_vertex, run_part, run_conn, run_valid)``, each (T, M).
    Invalid runs have ``run_vertex == g.n_max`` (ghost segment).
    """
    skey, sw, run_id = sorted_edge_keys(g, dst_part, k)
    run_conn = _segment_sum(sw, run_id, g.m_max)
    # every key of a run is the same, so the scatter is order-free
    run_key = torch.full_like(skey, _INVALID).scatter_(1, run_id, skey)
    valid = run_key != _INVALID
    run_vertex = torch.where(valid, run_key // (k + 1), g.n_max).int()
    run_part = (run_key % (k + 1)).int()
    return run_vertex, run_part, run_conn, valid


def sorted_runs(g: Graph, parts: torch.Tensor, k: int):
    """Runs built from scratch: gather each edge's destination part."""
    return runs_from_dst_part(g, parts[:, g.adjncy], k)


def _seg_max(values: torch.Tensor, seg: torch.Tensor, n_seg: int):
    """(T, n_seg) segment max; an empty segment holds INT32_MIN, the
    reference's identity."""
    out = torch.full((values.shape[0], n_seg), -2**31, dtype=torch.int32,
                     device=values.device)
    return out.scatter_reduce_(1, seg.long(), values, "amax")


def _seg_argmax_part(values, part_ids, seg, mask, n_seg: int, k: int):
    """Per-segment (max value, smallest part id attaining it). Deterministic."""
    vals = torch.where(mask, values, 0)
    best = _seg_max(vals, seg, n_seg).clamp(min=0)
    seg_c = seg.clamp(0, n_seg - 1).long()
    is_best = mask & (values == best.gather(1, seg_c)) & (values > 0)
    cand = torch.where(is_best, part_ids, k)  # k sorts after all real parts
    part = -_seg_max(torch.where(is_best, -cand, -k), seg, n_seg)
    none = best <= 0
    return torch.where(none, 0, best), torch.where(none, k, part).int()


def queries_from_runs(g: Graph, runs, parts: torch.Tensor,
                      k: int) -> ConnQueries:
    run_vertex, run_part, run_conn, valid = runs
    n_seg = g.n_max + 1
    vclip = run_vertex.clamp(0, g.n_max - 1).long()
    own = valid & (run_part == parts.gather(1, vclip))
    conn_self = _segment_sum(torch.where(own, run_conn, 0), run_vertex,
                             n_seg)[:, :g.n_max]
    alt = valid & ~own
    best_conn, best_part = _seg_argmax_part(run_conn, run_part, run_vertex,
                                            alt, n_seg, k)
    return ConnQueries(conn_self, best_part[:, :g.n_max],
                       best_conn[:, :g.n_max])


def sorted_queries(g: Graph, parts: torch.Tensor, k: int) -> ConnQueries:
    return queries_from_runs(g, sorted_runs(g, parts, k), parts, k)


def ell_queries(g: Graph, parts: torch.Tensor, k: int) -> ConnQueries:
    """The jet_gain kernel over the graph's ELL adjacency."""
    nbr, wgt = jg.csr_to_ell(g)
    return ConnQueries(*jg.jet_gain(nbr, wgt, parts, k))


def queries(g: Graph, parts: torch.Tensor, k: int,
            backend: str = "dense") -> ConnQueries:
    _check_backend(backend)
    if backend == "dense":
        return dense_queries(g, parts, k)
    if backend == "sorted":
        return sorted_queries(g, parts, k)
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

    Exactly one backend's structure is populated; the others hold empty
    placeholders.  ``sizes`` is delta-maintained; ``cut`` is advanced by a
    one-pass edge reduction over the post-move parts.
    """

    sizes: torch.Tensor          # (T, k) int32 part weights
    cut: torch.Tensor            # (T,) int32 current cutsize
    mat: torch.Tensor            # dense: (T, N, k+1) int32; else empty
    edge_dst_part: torch.Tensor  # sorted: (T, M) int32 edge dst parts; else empty
    ell_nbr: torch.Tensor        # ell: (N, D) int32 neighbor ids; else empty
    ell_wgt: torch.Tensor        # ell: (N, D) int32 edge weights; else empty
    ell_parts: torch.Tensor      # ell: (T, N, D) int32 neighbor parts; else empty
    moves_applied: torch.Tensor  # (T,) int32 move lists since last (re)build


def _edge_dst_part(g: Graph, parts: torch.Tensor, k: int) -> torch.Tensor:
    """(T, M) destination part of every edge; padding edges hold k."""
    return torch.where(g.edge_mask(), parts[:, g.adjncy], k).int()


def build_state(g: Graph, parts: torch.Tensor, k: int, backend: str = "dense",
                max_degree: int | None = None) -> ConnState:
    """Build the full state from a (T, N) parts batch (once per level).

    ``parts`` must already map padding vertices to the ghost part ``k``.
    """
    _check_backend(backend)
    empty = torch.zeros(0, dtype=torch.int32, device=parts.device)
    mat = edp = nbr = wgt = nparts = empty
    if backend == "dense":
        mat = conn_matrix(g, parts, k)
    elif backend == "sorted":
        edp = _edge_dst_part(g, parts, k)
    else:
        nbr, wgt = jg.csr_to_ell(g, max_degree)
        nparts = jg.lookup_nbr_parts(nbr, parts, k)
    return ConnState(
        sizes=metrics.part_sizes(g, parts, k),
        cut=metrics.cutsize(g, parts),
        mat=mat, edge_dst_part=edp, ell_nbr=nbr, ell_wgt=wgt,
        ell_parts=nparts,
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
    elif backend == "sorted":
        upd["edge_dst_part"] = _edge_dst_part(g, parts, k)
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
    elif backend == "sorted":
        hit = g.edge_mask() & move[:, g.adjncy]
        upd["edge_dst_part"] = torch.where(hit, dest[:, g.adjncy],
                                           state.edge_dst_part).int()
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
    if backend == "sorted":
        runs = runs_from_dst_part(g, state.edge_dst_part, k)
        return queries_from_runs(g, runs, parts, k)
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


def _run_mask(runs, valid_parts: torch.Tensor, k: int) -> torch.Tensor:
    """Valid runs whose part is a valid destination (never the ghost k)."""
    _, run_part, _, valid = runs
    vp = torch.cat([valid_parts, torch.zeros_like(valid_parts[:, :1])], 1)
    return valid & vp.gather(1, run_part.clamp(0, k).long())


def _rw_from_runs(g: Graph, runs, valid_parts: torch.Tensor, k: int):
    run_vertex, run_part, run_conn, _ = runs
    best_conn, best_part = _seg_argmax_part(
        run_conn, run_part, run_vertex, _run_mask(runs, valid_parts, k),
        g.n_max + 1, k)
    best_conn, best_part = best_conn[:, :g.n_max], best_part[:, :g.n_max]
    has = best_conn > 0
    return best_conn.clamp(min=0), torch.where(has, best_part, k).int(), has


def _rs_from_runs(g: Graph, runs, valid_parts: torch.Tensor, k: int):
    run_vertex, _, run_conn, _ = runs
    mask = _run_mask(runs, valid_parts, k)
    n_seg = g.n_max + 1
    s = _segment_sum(torch.where(mask, run_conn, 0), run_vertex, n_seg)
    cnt = _segment_sum((mask & (run_conn > 0)).int(), run_vertex, n_seg)
    return s[:, :g.n_max], cnt[:, :g.n_max]


def rw_queries(g: Graph, state: ConnState, k: int, valid_parts: torch.Tensor,
               backend: str):
    """Jetrw: best valid-destination part per vertex: (best_conn, best_part, has)."""
    _check_backend(backend)
    if backend == "sorted":
        runs = runs_from_dst_part(g, state.edge_dst_part, k)
        return _rw_from_runs(g, runs, valid_parts, k)
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
    if backend == "sorted":
        runs = runs_from_dst_part(g, state.edge_dst_part, k)
        return _rs_from_runs(g, runs, valid_parts, k)
    sel = torch.where(_colmask(valid_parts), _state_matrix(state, k, backend), 0)
    return sel.sum(-1, dtype=torch.int32), (sel > 0).sum(-1, dtype=torch.int32)
