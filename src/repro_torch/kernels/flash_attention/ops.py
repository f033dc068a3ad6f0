"""Public wrapper of the flash_attention kernel and its backward kernel.

Counterpart of ``repro.kernels.flash_attention.ops``.
:func:`flash_attention` sends CPU tensors to the plain version in
``ref.py`` and CUDA tensors to the kernel in ``flash_attention.cu``; there
is no third path.  Unlike the Pallas kernel, the CUDA kernel takes any Sq
and Skv (it masks the ragged tiles), a value width Dv of its own (MLA's
192-wide queries and keys with 128-wide values), and picks its own tile
sizes.

Where an input needs a gradient, the call goes through an autograd
Function: its forward also returns each row's log-sum-exp (the kernel
writes it beside the output, which stays bit for bit what it is without
it) and saves q, k, v, o and lse; its backward is the kernel of
``flash_attention_bwd.cu`` on the card and ``flash_attention_bwd_ref`` on
the CPU.  The reference has no backward kernel: it trains through
``chunked_attention``, which XLA differentiates.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_ref)

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_DV = 256  # the widest value head the kernel takes


@functools.cache
def _library():
    """``flash_attention.cu``'s C launcher and its largest head dim, built
    at first use."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.flash_attention_max_head_dim()


@functools.cache
def _bwd_library():
    """``flash_attention_bwd.cu``'s C launcher and its largest head dim."""
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.flash_attention_bwd_max_head_dim()


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3] or not 1 <= v.shape[3] <= MAX_DV:
        raise ValueError(f"q must be (B, H, Sq, D), k (B, Hkv, Skv, D) and v "
                         f"(B, Hkv, Skv, Dv) with 1 <= Dv <= {MAX_DV}, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 or \
            h % k.shape[1] != 0:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}: same B and D, H % Hkv == 0")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def _flash_attention_cuda(q, k, v, causal: bool, window: int, q_offset: int,
                          with_lse: bool = False):
    """Launch ``flash_attention.cu`` on the current stream (strided views
    are copied to contiguous first); with ``with_lse`` also return the
    rows' log-sum-exp (B, H, Sq) float32."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    fn, max_d = _library()
    b, h, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if max(d, dv) > max_d:
        raise ValueError(f"flash_attention takes D, Dv <= {max_d}, got {d}, "
                         f"{dv}")
    out = q.new_empty((b, h, sq, dv))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None, b, h, hkv, sq, skv, d,
                 dv, int(causal), int(window), int(q_offset), DTYPES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed with CUDA error {err}")
    launch_counts["flash_attention"] += 1
    return (out, lse) if with_lse else out


def _flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool, window: int,
                              q_offset: int):
    """Launch ``flash_attention_bwd.cu`` (its three kernels) on the current
    stream: (dq, dk, dv) in q's dtype."""
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    fn, max_d = _bwd_library()
    b, h, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if max(d, dv) > max_d:
        raise ValueError(f"flash_attention's backward takes D, Dv <= {max_d}, "
                         f"got {d}, {dv}")
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h == 0:
        return dq, dk, dvv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, h, hkv, sq,
                 skv, d, dv, int(causal), int(window), int(q_offset),
                 DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed "
                           f"with CUDA error {err}")
    launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dvv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` from its inputs, its output
    o, the rows' log-sum-exp and o's cotangent ``do``: the backward kernel
    on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cuda":
        return _flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window,
                                         q_offset)
    return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window,
                                   q_offset)


class _FlashAttention(torch.autograd.Function):
    """flash_attention with a gradient: the forward saves q, k, v, o and
    the rows' log-sum-exp; the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        if q.device.type == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            o, lse = _flash_attention_cuda(q, k, v, causal, window, q_offset,
                                           with_lse=True)
        else:
            o, lse = flash_attention_ref(q, k, v, causal, window, q_offset,
                                         return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q (B, H, Sq, D); k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv) -> (B, H,
    Sq, Dv) in q's dtype, with the scale 1/sqrt(D).

    Attention of each query head over kv head ``h // (H / Hkv)``, causal
    (key position <= query position + ``q_offset``) and, for ``window`` >
    0, over the last ``window`` positions only.  A row with no visible key
    is 0.  CPU tensors go to the plain version, CUDA tensors to the kernel.
    Where q, k or v needs a gradient, the backward kernel (its plain
    version on the CPU) gives it.
    """
    _check(q, k, v)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, causal, window, q_offset)
    return flash_attention_ref(q, k, v, causal, window, q_offset)
