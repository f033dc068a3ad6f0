"""Shared NN building blocks (counterpart of ``repro.models.layers``).

Parameters are plain tensors.  The initialisers draw from an explicit
``torch.Generator`` on the generator's device; the same seed gives other
numbers than ``jax.random`` does, so parity tests carry the reference's
parameters across with ``models/convert.py`` instead.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, lead: tuple = ()):
    """U(-1/sqrt(d_in), 1/sqrt(d_in)) drawn in float32, then cast; ``lead``
    prepends axes (the stacked layer axis)."""
    scale = 1.0 / np.sqrt(d_in)
    u = torch.rand((*lead, d_in, d_out), generator=gen, device=gen.device)
    return (u * (2 * scale) - scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.bfloat16):
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w.float()).to(dt)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(head_dim: int, theta: float = 10000.0):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` as a tensor on ``device``, copied there once (a copy
    from host memory per call would wait for the card's queue)."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """:func:`_rope_freqs_on`, but under a FakeTensorMode a fake tensor of
    its shape (a fake tensor holds no values, and belongs to its mode: it
    must not outlive it in the cache)."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is not None:
        return torch.empty(head_dim // 2, device=device)
    return _rope_freqs_on(head_dim, theta, device)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, D) with D even; positions (..., S) integer."""
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)     # (D/2,)
    ang = positions[..., None].float() * freqs                   # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """logits (..., V): float32 cross entropy, positions labelled
    ``ignore_id`` masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
