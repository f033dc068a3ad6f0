"""Plain PyTorch version of the segment_reduce kernel (counterpart of
``repro.kernels.segment_reduce.ref.segment_sum_sorted_ref``).

``data`` (M, F) rows are summed by ``seg_ids`` (M,) into (S, F).  Ids
outside [0, S) are dropped, as ``jax.ops.segment_sum`` drops them.  An
integer ``index_add_`` does not depend on the order of the adds, so on
int32 this equals the kernel exactly; on float32 the order differs.
bfloat16 and float16 rows are summed in float32 and rounded once to their
dtype, as the kernel's wrapper does.
"""
from __future__ import annotations

import torch


def segment_sum_sorted_ref(data: torch.Tensor, seg_ids: torch.Tensor,
                           num_segments: int) -> torch.Tensor:
    s = num_segments
    idx = torch.where(seg_ids < 0, s, seg_ids).clamp(max=s).long()
    acc = data if data.dtype in (torch.int32, torch.float32) else data.float()
    out = torch.zeros(s + 1, data.shape[1], dtype=acc.dtype,
                      device=data.device)
    return out.index_add_(0, idx, acc)[:s].to(data.dtype)
