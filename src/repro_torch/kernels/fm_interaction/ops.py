"""Public wrapper of the fm_interaction kernel.

Counterpart of ``repro.kernels.fm_interaction.ops``.  :func:`fm_interaction`
sends a CPU tensor to the plain version in ``ref.py`` and a CUDA tensor to
the kernel in ``fm_interaction.cu``; there is no third path.  Unlike the
JAX wrapper it needs no padding of B to a block.  Both paths take float32,
bfloat16 and float16 (each cast to float32 on load, as the reference casts
any float) and strided views, and refuse the same inputs with the same
message.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_DIM = 12288  # fm_interaction.cu's kMaxDim


@functools.cache
def _library():
    """``fm_interaction.cu``'s C launcher, built at first use."""
    lib = _build.load("fm_interaction")
    if lib.fm_interaction_max_dim() != MAX_DIM:
        raise RuntimeError("fm_interaction.cu's kMaxDim is not MAX_DIM")
    fn = lib.fm_interaction_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fm_interaction_cuda(emb):
    """Launch ``fm_interaction.cu`` on the current stream."""
    emb = emb.contiguous()
    fn = _library()
    b, f, d = emb.shape
    out = torch.empty(b, dtype=torch.float32, device=emb.device)
    if b == 0:
        return out
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(emb.data_ptr(), out.data_ptr(), b, f, d, DTYPES[emb.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(
            f"fm_interaction kernel launch failed with CUDA error {err}")
    launch_counts["fm_interaction"] += 1
    return out


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """emb (B, F, D) float32, bfloat16 or float16 -> (B,) float32
    second-order FM scores.  A CPU tensor goes to the plain version, a CUDA
    tensor to the kernel."""
    if emb.dim() != 3:
        raise ValueError(f"emb must be (B, F, D), got {tuple(emb.shape)}")
    if emb.dtype not in DTYPES:
        raise TypeError(f"emb must be one of {list(DTYPES)}, got "
                        f"{emb.dtype}")
    if not 1 <= emb.shape[2] <= MAX_DIM:
        raise ValueError(f"fm_interaction takes 1 <= D <= {MAX_DIM}, got "
                         f"{emb.shape[2]}")
    if emb.device.type == "cuda":
        return _fm_interaction_cuda(emb)
    if emb.device.type == "cpu":
        return fm_interaction_ref(emb)
    raise ValueError(f"fm_interaction runs on cpu or cuda, not {emb.device}")
