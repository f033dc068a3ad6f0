"""Plain PyTorch version of the fm_interaction kernel (counterpart of
``repro.kernels.fm_interaction.ref.fm_interaction_ref``).

score(x) = 0.5 * sum_d [ (sum_f e_fd)^2 - sum_f e_fd^2 ]
with e (B, F, D) the per-field embedding vectors.  O(F*D) via the
sum-square trick against O(F^2 D) for the naive pairwise sum.
"""
from __future__ import annotations

import torch


def fm_interaction_ref(emb: torch.Tensor) -> torch.Tensor:
    e = emb.float()  # accumulate in f32 (the trick cancels badly in bf16)
    s = torch.sum(e, dim=1)                      # (B, D)
    sq = torch.sum(e * e, dim=1)                 # (B, D)
    return 0.5 * torch.sum(s * s - sq, dim=-1)   # (B,) float32
