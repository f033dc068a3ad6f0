"""Public wrapper of the flash_attention kernel.

Counterpart of ``repro.kernels.flash_attention.ops``.
:func:`flash_attention` sends CPU tensors to the plain version in
``ref.py`` and CUDA tensors to the kernel in ``flash_attention.cu``; there
is no third path.  Unlike the Pallas kernel, the CUDA kernel takes any Sq
and Skv (it masks the ragged tiles), a value width Dv of its own (MLA's
192-wide queries and keys with 128-wide values), and picks its own tile
sizes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_DV = 256  # the widest value head the kernel takes


@functools.cache
def _library():
    """``flash_attention.cu``'s C launcher and its largest head dim, built
    at first use."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.flash_attention_max_head_dim()


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


def _flash_attention_cuda(q, k, v, causal: bool, window: int, q_offset: int):
    """Launch ``flash_attention.cu`` on the current stream (strided views
    are copied to contiguous first)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    fn, max_d = _library()
    b, h, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if max(d, dv) > max_d:
        raise ValueError(f"flash_attention takes D, Dv <= {max_d}, got {d}, "
                         f"{dv}")
    out = q.new_empty((b, h, sq, dv))
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, sq, skv, d, dv, int(causal), int(window),
                 int(q_offset), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed with CUDA error {err}")
    launch_counts["flash_attention"] += 1
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q (B, H, Sq, D); k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv) -> (B, H,
    Sq, Dv) in q's dtype, with the scale 1/sqrt(D).

    Attention of each query head over kv head ``h // (H / Hkv)``, causal
    (key position <= query position + ``q_offset``) and, for ``window`` >
    0, over the last ``window`` positions only.  A row with no visible key
    is 0.  CPU tensors go to the plain version, CUDA tensors to the kernel.
    """
    _check(q, k, v)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window, q_offset)
    raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
