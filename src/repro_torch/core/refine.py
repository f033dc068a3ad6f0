"""Jet refinement — Jetlp (Alg 4.2) and the outer driver (Alg 4.1).

Counterpart of ``repro.core.refine``, trial-batched: ``parts`` is (T, N),
or (B, T, N) over the lanes of a fleet bucket.  The reference runs one
``lax.while_loop`` per level under ``jax.vmap`` over the trials (and the
lanes); here that is a Python loop which runs while any row is still
active, computing the body for all rows and freezing every carry field of
a finished row with ``torch.where`` — so trial t of lane b walks the
trajectory of its standalone T=1 run (DESIGN.md §§9-10).  Each ``lax.cond``
under vmap becomes a select: a branch is computed only if some active row
takes it, then chosen per row.  One small host read per iteration, for the
whole bucket, decides the loop and the branches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import trace
from repro_torch.core import connectivity as cn
from repro_torch.core import metrics
from repro_torch.core import rebalance as rb
from repro_torch.core.graph import Graph, take, trial_axis

VARIANTS = ("baseline", "locks", "weak_ab", "full_ab", "full")


def variant_flags(variant: str):
    """(use_ratio_filter, use_afterburner, use_locks) — Table 3 ablations."""
    return {
        "baseline": (False, False, False),
        "locks": (False, False, True),
        "weak_ab": (False, True, False),
        "full_ab": (True, True, False),
        "full": (True, True, True),
    }[variant]


@trace.spanned("jet.lp")
def jetlp_moves(g: Graph, parts, k: int, lock, c: float,
                backend: str = "dense", variant: str = "full",
                queries: cn.ConnQueries | None = None):
    """One unconstrained LP pass (Alg 4.2). Returns (move_mask, dest), (..., T, N).

    First filter: Eq 4.3 ``-F(v) < floor(c * conn(v, P_s))  or  F(v) >= 0``.
    Second filter (afterburner): recompute the gain against the approximate
    next state merged under ``ord`` (Eq 4.1), keep non-negative.
    """
    use_ratio, use_ab, use_locks = variant_flags(variant)
    q = queries if queries is not None else cn.queries(g, parts, k, backend)
    F = q.best_conn - q.conn_self  # gain of the best single move
    boundary = q.best_conn > 0
    if use_ratio:
        thr = torch.floor(c * q.conn_self.float()).int()
        filter1 = (F >= 0) | (-F < thr)  # Eq 4.3 (strict <, floor rounding)
    else:
        filter1 = F >= 0
    nd = parts.dim()
    X = trial_axis(g.vertex_mask(), nd) & boundary & filter1
    if use_locks:
        X = X & ~lock
    Pd = torch.where(X, q.best_part, parts)
    if not use_ab:
        return X, Pd

    # Afterburner: per-edge approximate next state.
    with trace.span("jet.lp.afterburner"):
        u, v, w = g.adjncy, g.esrc, trial_axis(g.adjwgt, nd)
        Fu, Fv = take(F, u), take(F, v)
        # ord(u) < ord(v): u moves "first" iff higher priority gain, tie ->
        # smaller id
        u_first = take(X, u) & ((Fu > Fv)
                                | ((Fu == Fv) & trial_axis(u < v, nd)))
        pu = torch.where(u_first, take(Pd, u), take(parts, u))
        contrib = w * ((pu == take(Pd, v)).int()
                       - (pu == take(parts, v)).int())
        contrib = torch.where(trial_axis(g.edge_mask(), nd) & take(X, v),
                              contrib, 0)
        vi = trial_axis(v.long(), nd).expand(contrib.shape)
        F2 = torch.zeros_like(F).scatter_add_(-1, vi, contrib)
    return X & (F2 >= 0), Pd


class RefineState(NamedTuple):
    """The loop's carry: every field is per row, (..., T[, N])."""

    parts: torch.Tensor          # (..., T, N)
    conn: cn.ConnState           # threaded connectivity/sizes/cut state
    best_parts: torch.Tensor     # (..., T, N)
    best_cost: torch.Tensor      # (..., T) int32 cutsize of best
    best_maxsize: torch.Tensor   # (..., T) int32 max part weight of best
    best_balanced: torch.Tensor  # (..., T) bool
    lock: torch.Tensor           # (..., T, N) bool — last Jetlp move set
    since_best: torch.Tensor     # (..., T) int32 iterations since best improved
    weak_count: torch.Tensor     # (..., T) int32 consecutive weak rebalances
    it: torch.Tensor             # (..., T) int32 total iterations
    lp_iters: torch.Tensor       # (..., T) int32 (stats)
    rb_iters: torch.Tensor       # (..., T) int32 (stats)


def _select(pick: torch.Tensor, new, old):
    """Per-row select, ``pick`` (..., T), over a per-row tensor, a tuple
    of them, a :class:`RefineState` or a :class:`~repro_torch.core.
    connectivity.ConnState`.

    Which tensors are per row is decided by name, never by shape: the
    ConnState fields in ``cn.SHARED_FIELDS`` (the ELL adjacency, one per
    lane) and empty placeholders are the same in both and pass through.
    """
    if isinstance(new, tuple):
        shared = cn.SHARED_FIELDS if isinstance(new, cn.ConnState) else ()
        fields = getattr(new, "_fields", [None] * len(new))
        vals = [a if f in shared else _select(pick, a, b)
                for f, a, b in zip(fields, new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)
    if new is old or new.numel() == 0:
        return new
    return torch.where(
        pick.view(*pick.shape, *[1] * (new.dim() - pick.dim())), new, old)


def _cond(pred, need_true: bool, need_false: bool, if_true, if_false):
    """``lax.cond`` under vmap: compute only the branches that some active
    trial takes, then select per trial by ``pred``."""
    if not need_false:
        return if_true()
    if not need_true:
        return if_false()
    return _select(pred, if_true(), if_false())


def jet_refine(g: Graph, parts0, k: int, lam: float = 0.03, c: float = 0.75,
               phi: float = 0.999, backend: str = "dense", patience: int = 12,
               max_iter: int = 200, b_max: int = 2, variant: str = "full",
               rebuild_every: int = 0, conn0: cn.ConnState | None = None,
               max_degree: int | None = None):
    """Alg 4.1 on a (..., T, N) batch of partitions. Returns (best_parts,
    stats)."""
    if rebuild_every < 0:
        raise ValueError(f"rebuild_every must be >= 0, got {rebuild_every}")
    parts0 = torch.where(trial_axis(g.vertex_mask(), parts0.dim()),
                         parts0.int(), k)
    if conn0 is None:
        if backend == "ell" and max_degree is None:
            max_degree = int(g.degrees().max())
        conn0 = cn.build_state(g, parts0, k, backend, max_degree=max_degree)
    return _refine_loop(g, parts0, conn0, phi, k=k, lam=lam, c=c,
                        backend=backend, patience=patience, max_iter=max_iter,
                        b_max=b_max, variant=variant,
                        rebuild_every=rebuild_every)


def _refine_loop(g: Graph, parts0, conn0: cn.ConnState, phi, *, k: int,
                 lam: float, c: float, backend: str, patience: int,
                 max_iter: int, b_max: int, variant: str, rebuild_every: int,
                 active=None):
    """Alg 4.1 over the rows (..., T) of ``parts0``.

    ``active`` (a fleet lane's refine flag, (B,) bool) makes every row of
    an inactive lane's loop condition false at iteration 0, so its
    (identity-projected) partition passes through untouched.

    Adds the loop's host wall time, and the part of it the host spent
    blocked in reads (the per-iteration read of its flags), to the call's
    record.
    """
    rec = trace.current()
    t_loop, wait0 = trace.clock(), rec.read_ns
    dev = parts0.device
    rows = parts0.shape[:-1]
    # per lane, against the (..., T) rows
    limit = metrics.size_limit(g.total_vweight(), k, lam).unsqueeze(-1)
    lane_ok = True if active is None else active.unsqueeze(-1)

    def zeros():
        return torch.zeros(rows, dtype=torch.int32, device=dev)

    max0 = conn0.sizes.amax(-1)
    st = RefineState(
        parts=parts0, conn=conn0, best_parts=parts0, best_cost=conn0.cut,
        best_maxsize=max0, best_balanced=max0 <= limit,
        lock=torch.zeros_like(parts0, dtype=torch.bool),
        since_best=zeros(), weak_count=zeros(), it=zeros(),
        lp_iters=zeros(), rb_iters=zeros(),
    )
    one = torch.ones(rows, dtype=torch.int32, device=dev)

    while True:
        with trace.span("jet.flags"):
            active = (st.since_best < patience) & (st.it < max_iter) & lane_ok
            balanced = st.conn.sizes.amax(-1) <= limit
            weak = st.weak_count < b_max
            # the loop's one host read: the host waits here for the device
            any_act, any_lp, any_weak, any_strong = trace.read(
                "refine.iter", torch.stack([
                    active.any(), (active & balanced).any(),
                    (active & ~balanced & weak).any(),
                    (active & ~balanced & ~weak).any(),
                ]).tolist)
        if not any_act:
            break
        with trace.span("jet.iter"):
            # one ConnQueries per iteration, shared by all three move kinds
            q = cn.state_queries(g, st.conn, st.parts, k, backend)

            def do_lp():
                move, dest = jetlp_moves(g, st.parts, k, st.lock, c,
                                         backend, variant, queries=q)
                return move, dest, move, zeros(), one, zeros()

            def do_rb():
                move, dest = _cond(
                    weak, any_weak, any_strong,
                    lambda: rb.jetrw_moves(g, st.parts, k, lam, backend,
                                           conn=st.conn, queries=q),
                    lambda: rb.jetrs_moves(g, st.parts, k, lam, backend,
                                           conn=st.conn, queries=q))
                # rebalancing does not touch lock state (paper §4.1.3)
                return move, dest, st.lock, st.weak_count + 1, zeros(), one

            step = _cond(balanced, any_lp, any_weak or any_strong, do_lp,
                         do_rb)
            move, dest, lock2, weak2, dlp, drb = step

            # Alg 4.4 delta update; `rebuild_every` is the full-rebuild hatch.
            with trace.span("jet.apply"):
                parts2 = torch.where(move, dest, st.parts)
                if rebuild_every == 1:
                    conn2 = cn.rebuild_state(g, st.conn, parts2, k, backend)
                elif rebuild_every == 0:
                    conn2 = cn.apply_moves(g, st.conn, st.parts, move, dest,
                                           k, backend)
                else:
                    full = (st.it + 1) % rebuild_every == 0
                    conn2 = _select(
                        full, cn.rebuild_state(g, st.conn, parts2, k, backend),
                        cn.apply_moves(g, st.conn, st.parts, move, dest, k,
                                       backend))

            with trace.span("jet.best"):
                cost2 = conn2.cut
                max2 = conn2.sizes.amax(-1)
                bal2 = max2 <= limit
                # Best tracking (Alg 4.1 lines 16-23, with a balanced
                # partition always superseding an unbalanced best —
                # DESIGN.md §6).
                take_bal = bal2 & (~st.best_balanced | (cost2 < st.best_cost))
                significant = bal2 & (
                    ~st.best_balanced
                    | (cost2.float() < phi * st.best_cost.float()))
                take_imb = ~bal2 & ~st.best_balanced & (max2 < st.best_maxsize)
                take_best = take_bal | take_imb
                reset = significant | take_imb
                new = RefineState(
                    parts=parts2,
                    conn=conn2,
                    best_parts=_select(take_best, parts2, st.best_parts),
                    best_cost=torch.where(take_best, cost2, st.best_cost),
                    best_maxsize=torch.where(take_best, max2,
                                             st.best_maxsize),
                    best_balanced=st.best_balanced | bal2,
                    lock=lock2,
                    since_best=torch.where(reset, 0, st.since_best + 1),
                    weak_count=torch.where(bal2, 0, weak2),
                    it=st.it + 1,
                    lp_iters=st.lp_iters + dlp,
                    rb_iters=st.rb_iters + drb,
                )
                st = _select(active, new, st)

    rec.refine_loop_ns += trace.clock() - t_loop
    rec.refine_wait_ns += rec.read_ns - wait0
    stats = {
        "iterations": st.it,
        "lp_iters": st.lp_iters,
        "rb_iters": st.rb_iters,
        "best_cost": st.best_cost,
        "best_maxsize": st.best_maxsize,
        "best_balanced": st.best_balanced,
    }
    return st.best_parts, stats
