"""32-bit wraparound arithmetic in int64 tensors.

The reference hashes in ``uint32`` and lets some ``int32`` sums wrap.  Torch
supports ``uint32`` only in part, so the port computes in int64 and masks to
32 bits.  A product of two 32-bit values can overflow int64, so
:func:`mul32` splits the constant into 16-bit halves.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def u32(x) -> torch.Tensor:
    """The low 32 bits of ``x`` as a non-negative int64 (the uint32 value)."""
    return torch.as_tensor(x).long() & MASK


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32) and a constant ``c``."""
    c &= MASK
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of ``x`` read as a signed int32 (two's complement)."""
    return (((x.long() & MASK) ^ 0x80000000) - 0x80000000).int()
