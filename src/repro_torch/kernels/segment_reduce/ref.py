"""Plain PyTorch version of the segment_reduce kernel (counterpart of
``repro.kernels.segment_reduce.ref.segment_sum_sorted_ref``).

``data`` (M, F) rows are summed by ``seg_ids`` (M,) into (S, F).  Ids
outside [0, S) are dropped, as ``jax.ops.segment_sum`` drops them.  An
integer ``index_add_`` does not depend on the order of the adds, so on
int32 this equals the kernel exactly; on float32 the order differs.
"""
from __future__ import annotations

import torch


def segment_sum_sorted_ref(data: torch.Tensor, seg_ids: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    s = num_segments
    idx = torch.where(seg_ids < 0, s, seg_ids).clamp(max=s).long()
    out = torch.zeros(s + 1, data.shape[1], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, idx, data)[:s]
