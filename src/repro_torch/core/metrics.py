"""Partition quality metrics: cutsize, part sizes, imbalance.

Counterpart of ``repro.core.metrics``.  ``parts`` may carry leading batch
dimensions (a trial axis): every function reduces over the last axis only.
``size_limit`` and ``imbalance`` stay float32, in the reference's order of
operations.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import Graph


def _rows(parts: torch.Tensor) -> torch.Tensor:
    return parts.reshape(-1, parts.shape[-1])


def cutsize(g: Graph, parts: torch.Tensor) -> torch.Tensor:
    """Sum of weights of cut (undirected) edges. parts: (..., N) in [0, k]."""
    cut = torch.where(parts[..., g.esrc] != parts[..., g.adjncy], g.adjwgt, 0)
    return cut.sum(-1, dtype=torch.int32) // 2


def _weight_by_part(parts: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k+1) sums of ``w`` (..., N) by part id; ids outside [0, k] are
    dropped, as the reference's segment sum drops them."""
    p = _rows(parts).long()
    ok = (p >= 0) & (p <= k)
    out = torch.zeros(p.shape[0], k + 1, dtype=torch.int32, device=p.device)
    out.scatter_add_(1, torch.where(ok, p, 0),
                     torch.where(ok, _rows(w.expand(parts.shape)).int(), 0))
    return out.reshape(*parts.shape[:-1], k + 1)


def part_sizes(g: Graph, parts: torch.Tensor, k: int) -> torch.Tensor:
    """Weighted size of each part, (..., k). Ghost part dropped."""
    return _weight_by_part(parts, g.vwgt, k)[..., :k]


def delta_part_sizes(g: Graph, sizes, parts_old, move, dest, k: int):
    """Part sizes after a move list.

    Integer scatter-adds of the movers' weights, bit-identical to the
    reference's one-hot delta reduction (integer adds commute).
    """
    w = torch.where(move, g.vwgt, 0)
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
