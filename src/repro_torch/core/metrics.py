"""Partition quality metrics: cutsize, part sizes, imbalance.

Counterpart of ``repro.core.metrics``.  ``parts`` may carry leading batch
dimensions (a lane axis, a trial axis): every function reduces over the
last axis only, and a per-lane ``total_w`` lines up with the lane axis.
``size_limit`` and ``imbalance`` stay float32, in the reference's order of
operations.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import Graph, take, trial_axis


def cutsize(g: Graph, parts: torch.Tensor) -> torch.Tensor:
    """Sum of weights of cut (undirected) edges. parts: (*lanes, [T,] N)."""
    cut = torch.where(take(parts, g.esrc) != take(parts, g.adjncy),
                      trial_axis(g.adjwgt, parts.dim()), 0)
    return cut.sum(-1, dtype=torch.int32) // 2


def _weight_by_part(parts: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k+1) sums of ``w`` by part id along the last axis; ids outside
    [0, k] are dropped, as the reference's segment sum drops them."""
    p = parts.long()
    ok = (p >= 0) & (p <= k)
    w = trial_axis(w, p.dim()).expand(p.shape).int()
    out = torch.zeros((*p.shape[:-1], k + 1), dtype=torch.int32,
                      device=p.device)
    return out.scatter_add_(-1, torch.where(ok, p, 0), torch.where(ok, w, 0))


def part_sizes(g: Graph, parts: torch.Tensor, k: int) -> torch.Tensor:
    """Weighted size of each part, (..., k). Ghost part dropped."""
    return _weight_by_part(parts, g.vwgt, k)[..., :k]


def delta_part_sizes(g: Graph, sizes, parts_old, move, dest, k: int):
    """Part sizes after a move list.

    Integer scatter-adds of the movers' weights, bit-identical to the
    reference's one-hot delta reduction (integer adds commute).
    """
    w = torch.where(move, trial_axis(g.vwgt, move.dim()), 0)
    parts_new = torch.where(move, dest, parts_old)
    d = _weight_by_part(parts_new, w, k) - _weight_by_part(parts_old, w, k)
    return sizes + d[..., :k]


def size_limit(total_w: torch.Tensor, k: int, lam: float) -> torch.Tensor:
    """Max allowed part weight: floor((1+lam) * W / k), in float32."""
    return torch.floor((1.0 + lam) * total_w.float() / k).int()


def imbalance(sizes: torch.Tensor, total_w: torch.Tensor, k: int) -> torch.Tensor:
    """max_p size_p * k / W - 1 (0 == perfectly balanced), float32."""
    opt = total_w.float() / k
    return sizes.max(-1).values.float() / torch.clamp(opt, min=1.0) - 1.0


def is_balanced(sizes, total_w, k: int, lam: float) -> torch.Tensor:
    return sizes.max(-1).values <= size_limit(total_w, k, lam)
