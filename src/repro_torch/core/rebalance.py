"""Jetr rebalancing — weak (Alg 4.3) and strong variants, slot bucketing (Eq 4.5).

Counterpart of ``repro.core.rebalance``, trial-batched: ``parts`` is (T, N)
and the connectivity state carries the T axis.  The same partial order as
the paper's bucket insertion comes from a stable sort on (part, slot) keys;
eviction prefixes come from a segmented cumulative sum.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import connectivity as cn
from repro_torch.core import metrics
from repro_torch.core.graph import Graph
from repro_torch.core.u32 import mul32

NSLOT = 36  # slot(x) in [0, 2+floor(log2(2^31))] = [0, 33]
_INF = 2147483647


# floor(log2(x)) as the reference's XLA-CPU log2 gives it, where that differs
# from the float32 exponent of x: (first, last, value) over float32 bit
# patterns, for every x = float32(loss) of an int32 loss (63 such x, all
# near powers of two; tests/test_torch_core.py regenerates them).
_XLA_LOG2_FLOOR = (
    (1174405120, 1174405120, 12),  # 8192
    (1191182336, 1191182336, 14),  # 32768
    (1241513976, 1241513976, 21),  # 2097151
    (1249902588, 1249902588, 22),  # 4194303
    (1258291186, 1258291198, 23),  # 8388601..8388607
    (1266679793, 1266679807, 24),  # 16777201..16777215
    (1275068409, 1275068415, 25),  # 33554418..33554430
    (1283457024, 1283457024, 25),  # 67108864
    (1291845632, 1291845636, 26),  # 134217728..134217792
    (1300234225, 1300234239, 28),  # 268435216..268435440
    (1308622841, 1308622847, 29),  # 536870688..536870880
    (1317011456, 1317011456, 29),  # 1073741824
    (1325400064, 1325400064, 30),  # 2147483648
)


@functools.cache
def _log2_table(device: torch.device):
    return torch.tensor(_XLA_LOG2_FLOOR, dtype=torch.int32,
                        device=device).T.contiguous()


def slot(loss: torch.Tensor) -> torch.Tensor:
    """Eq 4.5: log2 bucketing of the loss value.

    ``floor(log2(float32(loss)))`` is read as the float32 exponent and then
    corrected by :data:`_XLA_LOG2_FLOOR` wherever the reference's XLA-CPU
    ``log2`` rounds across an integer.  Integer arithmetic only, so the
    answer is the reference's on the CPU and on CUDA alike.
    """
    f = torch.clamp(loss.float(), min=1.0)
    bits = f.view(torch.int32)
    lg = ((bits >> 23) & 0xFF) - 127
    first, last, value = _log2_table(bits.device)
    i = (torch.searchsorted(first, bits, right=True) - 1).clamp(min=0)
    hit = (bits >= first[i]) & (bits <= last[i])
    lg = torch.where(hit, value[i], lg)
    return torch.where(loss > 0, 2 + lg, torch.where(loss == 0, 1, 0)).int()


def _dest_caps(sizes, limit, total_w, k: int):
    """Oversized set A, valid-destination set B, and sigma (deadzone top)."""
    opt = total_w // k
    sigma = (limit + opt) // 2
    over = sizes > limit
    valid = (sizes <= sigma) & ~over
    return over, valid, sigma, opt


def _rank_to_part(valid_parts: torch.Tensor, k: int):
    """part_of_rank[t, r] = r-th valid part id of trial t; num_valid (T,)."""
    v = valid_parts.int()
    rank = torch.cumsum(v, 1).int() - 1
    ids = torch.arange(k, dtype=torch.int32, device=v.device).expand_as(v)
    part_of_rank = torch.zeros_like(v).scatter_reduce_(
        1, torch.where(valid_parts, rank, k - 1).long(),
        torch.where(valid_parts, ids, 0), "amax")
    return part_of_rank, v.sum(1, dtype=torch.int32)


def _evict_prefix(g: Graph, parts, k, movable, slots, sizes, limit):
    """Stable sort by (part, slot); pick per-part prefixes with weight just
    covering size - limit (Alg 4.3 lines 19-28, Eq 4.4).

    Returns (evict (T,N) bool, order (T,N), evict_s, ecum_before (T,N)
    cumulative evicted weight in sorted space, for the cookie-cutter).
    """
    key = torch.where(movable, parts * NSLOT + slots, _INF)
    order = torch.argsort(key, dim=1, stable=True)
    mov_s = movable.gather(1, order)
    seg = torch.where(mov_s, parts.gather(1, order), k).long()
    w_s = torch.where(mov_s, g.vwgt[order], 0)
    cum_before = torch.cumsum(w_s, 1).int() - w_s
    first = torch.ones_like(mov_s)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    part_off = torch.zeros(parts.shape[0], k + 1, dtype=torch.int32,
                           device=parts.device).scatter_reduce_(
        1, seg, torch.where(first, cum_before, 0), "amax")
    within_before = cum_before - part_off.gather(1, seg)
    need = torch.clamp(sizes - limit, min=0)
    need_s = need.gather(1, seg.clamp(0, k - 1))
    evict_s = mov_s & (within_before < need_s)
    evict = torch.zeros_like(evict_s).scatter_(1, order, evict_s)
    ew = torch.where(evict_s, w_s, 0)
    ecum_before = torch.cumsum(ew, 1).int() - ew
    return evict, order, evict_s, ecum_before


def _common(g: Graph, conn: cn.ConnState, parts, k, lam):
    sizes = conn.sizes
    W = g.total_vweight()
    limit = metrics.size_limit(W, k, lam)
    over, valid, sigma, opt = _dest_caps(sizes, limit, W, k)
    pclip = parts.clamp(0, k - 1).long()
    in_over = over.gather(1, pclip) & g.vertex_mask() & (parts < k)
    # weight restriction (paper end of §4.2.2)
    surplus = (sizes.gather(1, pclip) - opt).float()
    movable = in_over & (g.vwgt.float() <= 1.5 * surplus)
    return sizes, limit, over, valid, sigma, opt, movable


def _state_and_queries(g, parts, k, backend, conn, queries):
    """Fill in state/queries for direct (non-loop) callers."""
    if conn is None:
        conn = cn.build_state(g, parts, k, backend)
    if queries is None:
        queries = cn.state_queries(g, conn, parts, k, backend)
    return conn, queries


def jetrw_moves(g: Graph, parts, k: int, lam: float, backend: str = "dense",
                conn: cn.ConnState | None = None, queries=None):
    """Weak rebalancing (Alg 4.3): evictees go to their best valid part."""
    conn, q = _state_and_queries(g, parts, k, backend, conn, queries)
    sizes, limit, over, valid, sigma, opt, movable = _common(g, conn, parts,
                                                             k, lam)
    best_conn, best_part, has = cn.rw_queries(g, conn, k, valid, backend)
    # fallback destination: pseudo-random valid part (deterministic hash)
    part_of_rank, num_valid = _rank_to_part(valid, k)
    vid = torch.arange(g.n_max, device=parts.device)
    r = (mul32(vid, 2654435761) >> 8).int()
    r = r % torch.clamp(num_valid, min=1)[:, None]
    rand_part = part_of_rank.gather(1, r.clamp(0, k - 1).long())
    # last resort (no valid part at all): smallest part
    argmin_part = torch.argmin(sizes, dim=1).int()[:, None]
    dest = torch.where(has, best_part,
                       torch.where(num_valid[:, None] > 0, rand_part,
                                   argmin_part))
    loss = q.conn_self - best_conn
    evict, _, _, _ = _evict_prefix(g, parts, k, movable, slot(loss), sizes,
                                   limit)
    return evict, dest.int()


def jetrs_moves(g: Graph, parts, k: int, lam: float, backend: str = "dense",
                conn: cn.ConnState | None = None, queries=None):
    """Strong rebalancing: cookie-cutter destination overlay (one shot)."""
    conn, q = _state_and_queries(g, parts, k, backend, conn, queries)
    sizes, limit, over, valid, sigma, opt, movable = _common(g, conn, parts,
                                                             k, lam)
    s_conn, cnt = cn.rs_queries(g, conn, k, valid, backend)
    mean_conn = torch.where(cnt > 0, s_conn // torch.clamp(cnt, min=1), 0)
    loss = q.conn_self - mean_conn  # Eq 4.10 (sign per Alg 4.3 convention)
    evict, order, _, ecum_before = _evict_prefix(g, parts, k, movable,
                                                 slot(loss), sizes, limit)
    # capacities of valid destinations up to sigma
    cap = torch.where(valid, torch.clamp(sigma - sizes, min=0), 0)
    ccap = torch.cumsum(cap, 1).int()
    total_cap = ccap[:, -1:]
    x = torch.minimum(ecum_before, torch.clamp(total_cap - 1, min=0))
    dest_s = torch.searchsorted(ccap, x, right=True).clamp(0, k - 1).int()
    # safety: if total capacity is zero, send to smallest part
    argmin_part = torch.argmin(sizes, dim=1).int()[:, None]
    dest_s = torch.where(total_cap > 0, dest_s, argmin_part)
    dest = torch.zeros_like(dest_s).scatter_(1, order, dest_s)
    return evict, dest
