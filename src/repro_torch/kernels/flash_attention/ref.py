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


def _scores(q, kk, causal, window, q_offset):
    """(B, H, Sq, Skv) float32 scaled scores, -inf where masked."""
    sq, d = q.shape[2], q.shape[3]
    s = (q.float() * (1.0 / d ** 0.5)) @ kk.transpose(-1, -2)
    return s.masked_fill(attention_mask(sq, kk.shape[2], causal, window,
                                        q_offset, q.device), float("-inf"))


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0,
                        q_offset: int = 0, return_lse: bool = False):
    """q (B, H, Sq, D); k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), H % Hkv == 0
    -> (B, H, Sq, Dv) in q's dtype.

    ``window`` > 0 limits attention to the last ``window`` kv positions
    (inclusive of self); ``q_offset`` shifts the query positions.  With
    ``return_lse`` also each row's log-sum-exp of its scaled scores (B, H,
    Sq) float32, -inf for a row that sees no key: what the kernel saves for
    the backward pass.
    """
    group = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = _scores(q, kk, causal, window, q_offset)           # (B, H, Sq, Skv)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    out = ((p @ vv) / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, float("-inf"), m_safe + torch.log(l))
    return out, lse[..., 0]


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            window: int = 0, q_offset: int = 0):
    """The backward pass of :func:`flash_attention_ref`, the formulas of
    FlashAttention-2's on whole (Sq, Skv) matrices in float32: P = exp(S -
    lse) (0 where masked or where lse is -inf), dv = P^T do, dP = do v^T,
    Dl = rowsum(do * o), dS = P (dP - Dl), dq = dS k / sqrt(D), dk = dS^T
    q / sqrt(D); dk and dv summed over each kv head's query heads.

    o (B, H, Sq, Dv) and lse (B, H, Sq) are the forward's; do is o's
    cotangent.  Returns (dq, dk, dv) in q's, k's and v's dtypes.
    """
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = _scores(q, kk, causal, window, q_offset)
    lse = lse.float()[..., None]
    p = torch.where(torch.isneginf(s) | torch.isneginf(lse), 0.0,
                    torch.exp(s - torch.where(torch.isneginf(lse), 0.0, lse)))
    dof = do.float()
    dvv = p.transpose(-1, -2) @ dof                       # (B, H, Skv, Dv)
    dp = dof @ vv.transpose(-1, -2)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    scale = 1.0 / d ** 0.5
    dq = (ds @ kk) * scale
    dkk = (ds.transpose(-1, -2) @ q.float()) * scale
    skv = k.shape[2]
    dk = dkk.reshape(b, hkv, group, skv, d).sum(dim=2)
    dv = dvv.reshape(b, hkv, group, skv, v.shape[3]).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
