"""Plain PyTorch version of the flash_attention kernel.

Counterpart of the reference's Pallas kernel
(``repro.kernels.flash_attention.flash_attention``) and of its oracle
``ref.mha_ref``: softmax attention with GQA, causal masking, a sliding
window and a query offset, computed in float32 over the whole (Sq, Skv)
score matrix, with no online softmax.  It follows the Pallas kernel where
the two differ: q is scaled by 1/sqrt(D) before the product, and a row
whose every key is masked gives 0 (``mha_ref`` gives NaN there).  Values
may have a width Dv of their own (MLA: D = 192, Dv = 128), as in the
reference's ``chunked_attention``; the scale stays 1/sqrt(D).
"""
from __future__ import annotations

import torch


def attention_mask(sq: int, skv: int, causal: bool, window: int,
                   q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool, True where query i may not see key j."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.zeros((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask |= kpos > qpos
    if window > 0:
        mask |= kpos <= qpos - window
    return mask


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q (B, H, Sq, D); k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), H % Hkv == 0
    -> (B, H, Sq, Dv) in q's dtype.

    ``window`` > 0 limits attention to the last ``window`` kv positions
    (inclusive of self); ``q_offset`` shifts the query positions.
    """
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = (q.float() * (1.0 / d ** 0.5)) @ kk.transpose(-1, -2)   # (B, H, Sq, Skv)
    s = s.masked_fill(attention_mask(sq, k.shape[2], causal, window, q_offset,
                                     q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ vv) / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
