"""LP refinement variants for the Table 3 ablation + a size-constrained LP
competitor (the refinement family of Mt-Metis/KaMinPar that the paper groups
as "Label Propagation", §2.5.1).

Counterpart of ``repro.core.lp_baseline``, trial-batched: ``parts0`` is
(T, N).  The reference's ``lax.scan`` over the iterations is a Python loop.

Variant matrix (paper §7.1.4):
  baseline : X = {F >= 0}; commit all of X; no locks
  locks    : baseline + lock bit
  weak_ab  : X = {F >= 0}; afterburner second filter
  full_ab  : X per Eq 4.3 (negative gains admitted); afterburner
  full     : full_ab + locks   (== Jetlp)
"""
from __future__ import annotations

import torch

from repro_torch.core import connectivity as cn
from repro_torch.core import metrics
from repro_torch.core.graph import Graph
from repro_torch.core.refine import (  # noqa: F401  (re-export)
    VARIANTS, jetlp_moves, variant_flags)
from repro_torch.core.u32 import i32

_INF = 2147483647
_GAIN_CAP = 1 << 20


def constrained_lp_refine(g: Graph, parts0: torch.Tensor, k: int,
                          lam: float = 0.03, iters: int = 24):
    """Size-constrained synchronous LP (the classic competitor, §2.5.1).

    Each iteration: every boundary vertex proposes its best positive-gain
    move; proposals are admitted per destination part up to the part's
    remaining headroom (gain-descending, via a (dest, -gain) sorted prefix
    scan) so the balance constraint is never violated.  Keeps the best seen.
    Returns ``(best_parts (T, N), {"best_cost": (T,)})``.

    The admission key ``dest*(2*GAIN_CAP) + (GAIN_CAP - gain)`` is int32 and
    wraps for k >= 1024, as the reference's does.
    """
    limit = metrics.size_limit(g.total_vweight(), k, lam)
    vmask = g.vertex_mask()
    parts = torch.where(vmask, parts0.int(), k)
    t = parts.shape[0]
    dev = parts.device

    cost0 = metrics.cutsize(g, parts)
    bal0 = metrics.part_sizes(g, parts, k).amax(1) <= limit
    best_parts, best_cost = parts, torch.where(bal0, cost0, _INF)
    for _ in range(iters):
        q = cn.dense_queries(g, parts, k)
        F = q.best_conn - q.conn_self
        want = vmask & (q.best_conn > 0) & (F > 0)
        dest = torch.where(want, q.best_part, k)
        # admit by descending gain within each destination, up to headroom
        gain_c = F.clamp(-_GAIN_CAP + 1, _GAIN_CAP - 1)
        key = torch.where(
            want, i32(dest.long() * (2 * _GAIN_CAP) + (_GAIN_CAP - gain_c)),
            _INF)
        order = torch.argsort(key, dim=1, stable=True)
        want_s = want.gather(1, order)
        dseg = torch.where(want_s, dest.gather(1, order), k).long()
        w_s = torch.where(want_s, g.vwgt[order], 0)
        cum_b = torch.cumsum(w_s, 1).int() - w_s
        first = torch.ones_like(want_s)
        first[:, 1:] = dseg[:, 1:] != dseg[:, :-1]
        off = torch.zeros(t, k + 1, dtype=torch.int32, device=dev)
        off.scatter_reduce_(1, dseg, torch.where(first, cum_b, 0), "amax")
        within = cum_b - off.gather(1, dseg)
        sizes = metrics.part_sizes(g, parts, k)
        headroom = (limit - sizes).clamp(min=0)
        admit_s = want_s & (within < headroom.gather(1, dseg.clamp(0, k - 1)))
        admit = torch.zeros_like(admit_s).scatter_(1, order, admit_s)
        parts = torch.where(admit, dest, parts)
        cost2 = metrics.cutsize(g, parts)
        ok2 = metrics.part_sizes(g, parts, k).amax(1) <= limit
        take = ok2 & (cost2 < best_cost)
        best_parts = torch.where(take[:, None], parts, best_parts)
        best_cost = torch.where(take, cost2, best_cost)
    return best_parts, {"best_cost": best_cost}
