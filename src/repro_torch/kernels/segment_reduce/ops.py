"""Public wrapper of the segment_reduce kernel.

Counterpart of ``repro.kernels.segment_reduce.ops``.
:func:`segment_sum_sorted` sends a CPU tensor to the plain version in
``ref.py`` and a CUDA tensor to the kernel in ``segment_reduce.cu``; there
is no third path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref

DTYPES = (torch.int32, torch.float32)


def _check(data, seg_ids, num_segments: int) -> None:
    if data.dim() != 2 or seg_ids.dim() != 1 or \
            seg_ids.shape[0] != data.shape[0]:
        raise ValueError(f"data must be (M, F) and seg_ids (M,), got "
                         f"{tuple(data.shape)}, {tuple(seg_ids.shape)}")
    if data.dtype not in DTYPES:
        raise TypeError(f"data must be int32 or float32, got {data.dtype}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"seg_ids must be int32, got {seg_ids.dtype}")
    if seg_ids.device != data.device:
        raise ValueError(f"seg_ids is on {seg_ids.device}, data on "
                         f"{data.device}")
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"num_segments must be in [0, 2^31), got "
                         f"{num_segments}")


@functools.cache
def _library():
    """``segment_reduce.cu``'s C launcher and its tile size, built at first use."""
    lib = _build.load("segment_reduce")
    fn = lib.segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.segment_sum_tile_rows()


def _segment_sum_cuda(data, seg_ids, num_segments: int):
    """Launch ``segment_reduce.cu`` on the current stream."""
    if not (data.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_reduce needs contiguous data and seg_ids")
    fn, tile_rows = _library()
    m, f = data.shape
    tiles = -(-m // tile_rows)
    out = torch.empty((num_segments, f), dtype=data.dtype, device=data.device)
    head = torch.empty((tiles, f), dtype=data.dtype, device=data.device)
    tail = torch.empty_like(head)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(data.data_ptr(), seg_ids.data_ptr(), out.data_ptr(),
                 head.data_ptr(), tail.data_ptr(), m, f, num_segments,
                 int(data.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(
            f"segment_reduce kernel launch failed with CUDA error {err}")
    launch_counts["segment_reduce"] += 1
    return out


def segment_sum_sorted(data, seg_ids, num_segments: int):
    """Sorted-segment sum: data (M, F), seg_ids (M,) int32 non-decreasing.

    Returns (num_segments, F); rows whose id lies outside [0, num_segments)
    are dropped.  A CPU tensor goes to the plain version, a CUDA tensor to
    the kernel.  The kernel trusts the order of ``seg_ids``: ids that
    decrease give a wrong sum, unchecked.
    """
    _check(data, seg_ids, num_segments)
    if data.device.type == "cuda":
        return _segment_sum_cuda(data, seg_ids, num_segments)
    if data.device.type == "cpu":
        return segment_sum_sorted_ref(data, seg_ids, num_segments)
    raise ValueError(f"segment_reduce runs on cpu or cuda, not {data.device}")
