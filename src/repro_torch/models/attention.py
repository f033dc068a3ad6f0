"""Attention of the LM transformer (counterpart of ``repro.models.attention``).

Prefill attention on the card is the flash_attention kernel
(``kernels/flash_attention``), called from ``models/transformer.py``.  This
module keeps the reference's other two paths as plain PyTorch:
``chunked_attention``, the online softmax over kv chunks that the JAX
transformer uses where the port calls the kernel (kept for the tests), and
``decode_attention``, the cached single-token path, which the JAX package
also computes outside any kernel.  GQA, causal and sliding-window masks.
On DTensors (a sharded decode step) the query's heads are gathered (it is
one token) and the cache's sequence shards stay where they are: DTensor
gathers the (B, Hkv, group, S) scores for the softmax over S and sums the
shards' products with the values (a ``Partial``).
"""
from __future__ import annotations

import torch

from repro_torch.dist import regions


def repeat_kv(k, h: int):
    """(B, Hkv, S, D) -> (B, H, S, D) by repeating each kv head."""
    hkv = k.shape[1]
    if hkv == h:
        return k
    return k.repeat_interleave(h // hkv, dim=1)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      chunk: int = 1024):
    """Flash-style online softmax over kv chunks, a Python loop.

    q (B, H, Sq, D); k, v (B, Hkv, Skv, Dk/Dv), kv heads repeated here.
    Never materializes (Sq, Skv).
    """
    b, h, sq, d = q.shape
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    skv = k.shape[2]
    dv = v.shape[-1]
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"Skv={skv} is not a multiple of chunk={chunk}")
    scale = 1.0 / (d ** 0.5)
    qf = q.float() * scale
    qpos = (torch.arange(sq, device=q.device) + q_offset)[:, None]  # (Sq, 1)
    ninf = float("-inf")
    m = torch.full((b, h, sq, 1), ninf, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, dv), device=q.device)
    for j in range(skv // chunk):
        kj = k[:, :, j * chunk:(j + 1) * chunk].float()
        vj = v[:, :, j * chunk:(j + 1) * chunk].float()
        s = qf @ kj.transpose(-1, -2)
        kpos = (j * chunk + torch.arange(chunk, device=q.device))[None, :]
        mask = torch.zeros((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask |= kpos > qpos
        if window > 0:
            mask |= kpos <= qpos - window
        s = s.masked_fill(mask, ninf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - m_safe))
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = corr * acc + p @ vj
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window=0):
    """Single-token decode: q (B, H, 1, D); caches (B, Hkv, S, D).

    The cache is not repeated to H heads; the one query is viewed as
    (B, Hkv, group, D).  ``cache_len`` is the number of valid entries (the
    new token's kv is already written at ``cache_len - 1``).  The products
    take the cache's type on both sides and accumulate in float32, as the
    reference's ``preferred_element_type=float32`` dots do.
    """
    b, h, _, d = q.shape
    hkv, s_len = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    if regions.is_dtensor(q):   # the one query: its heads gathered
        from torch.distributed.tensor import Replicate, Shard

        q = regions.to(q, [p if p == Shard(0) else Replicate()
                           for p in q.placements])
    scale = 1.0 / (d ** 0.5)
    qg = (q.float() * scale).to(k_cache.dtype).reshape(b, hkv, group, d)
    sc = qg.float() @ k_cache.float().transpose(-1, -2)      # (B, Hkv, g, S)
    kpos = torch.arange(s_len, device=q.device)[None, :]
    qpos = cache_len - 1
    mask = kpos >= cache_len
    if window > 0:
        mask |= kpos <= qpos - window
    sc = sc.masked_fill(mask, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = p.to(v_cache.dtype).float() @ v_cache.float()      # (B, Hkv, g, D)
    return out.reshape(b, h, 1, d).to(q.dtype)
