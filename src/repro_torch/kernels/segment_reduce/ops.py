"""Public wrapper of the segment_reduce kernel.

Counterpart of ``repro.kernels.segment_reduce.ops``.
:func:`segment_sum_sorted` sends a CPU tensor to the plain version in
``ref.py`` and a CUDA tensor to the kernel in ``segment_reduce.cu``; there
is no third path.  Strided views are taken (the card path copies them to
contiguous first).  bfloat16 and float16 data are summed in float32 and
rounded once to their dtype at the output, on both paths.  The sum is a
custom op (``repro_torch::segment_reduce``, see ``kernels/__init__.py``)
with a cost formula.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, cost, launch_counts, nbytes, op_costs
from repro_torch.kernels.segment_reduce.ref import segment_sum_sorted_ref

DTYPES = (torch.int32, torch.float32, torch.bfloat16, torch.float16)


def _check(data, seg_ids, num_segments: int) -> None:
    if data.dim() != 2 or seg_ids.dim() != 1 or \
            seg_ids.shape[0] != data.shape[0]:
        raise ValueError(f"data must be (M, F) and seg_ids (M,), got "
                         f"{tuple(data.shape)}, {tuple(seg_ids.shape)}")
    if data.dtype not in DTYPES:
        raise TypeError(f"data must be one of {list(DTYPES)}, got "
                        f"{data.dtype}")
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
    """``segment_reduce.cu``'s C launcher and its tile count, built at
    first use."""
    lib = _build.load("segment_reduce")
    fn = lib.segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tiles = lib.segment_sum_tiles
    tiles.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    tiles.restype = ctypes.c_longlong
    return fn, tiles


def _segment_sum_cuda(data, seg_ids, num_segments: int):
    """Launch ``segment_reduce.cu`` on the current stream.  The kernel
    sums int32 or float32; 16-bit data is widened to float32 for it, and
    its float32 sums rounded once to the data's dtype."""
    dtype = data.dtype
    data = (data if dtype in (torch.int32, torch.float32)
            else data.float()).contiguous()
    seg_ids = seg_ids.contiguous()
    fn, tile_count = _library()
    m, f = data.shape
    tiles = tile_count(m, f, num_segments)
    out = torch.empty((num_segments, f), dtype=data.dtype, device=data.device)
    # per tile: the partials of its first output (lead) and of the rows
    # after its last output (trail), its first row and its first output
    scratch = torch.empty(2 * tiles * f + 2 * tiles + 1, dtype=torch.int32,
                          device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(data.data_ptr(), seg_ids.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), m, f, num_segments,
                 int(data.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(
            f"segment_reduce kernel launch failed with CUDA error {err}")
    launch_counts["segment_reduce"] += 1
    return out.to(dtype)


def segment_reduce_cost(data, seg_ids, num_segments: int) -> dict:
    """One call: an add a data element; the ids and the data read and the
    (S, F) sums written once in the data's dtype."""
    m, f = data.shape
    return cost(m * f, nbytes(seg_ids, data)
                + num_segments * f * data.element_size())


@torch.library.custom_op("repro_torch::segment_reduce", mutates_args=(),
                         device_types="cpu")
def _op(data: torch.Tensor, seg_ids: torch.Tensor,
        num_segments: int) -> torch.Tensor:
    return segment_sum_sorted_ref(data, seg_ids, num_segments).contiguous()


@_op.register_kernel("cuda")
def _(data, seg_ids, num_segments):
    return _segment_sum_cuda(data, seg_ids, num_segments)


@_op.register_fake
def _(data, seg_ids, num_segments):
    return data.new_empty((num_segments, data.shape[1]))


op_costs["repro_torch::segment_reduce"] = segment_reduce_cost


def segment_sum_sorted(data, seg_ids, num_segments: int,
                       out_placements=None):
    """Sorted-segment sum: data (M, F), seg_ids (M,) int32 non-decreasing.

    Returns (num_segments, F); rows whose id lies outside [0, num_segments)
    are dropped.  A CPU tensor goes to the plain version, a CUDA tensor to
    the kernel.  The kernel trusts the order of ``seg_ids``: ids that
    decrease give a wrong sum, unchecked.  DTensors go to
    :func:`_sharded_segment_sum` (``out_placements`` asks for an output
    sharded by segment range there).
    """
    from repro_torch.dist import regions

    if regions.is_dtensor(data):
        return _sharded_segment_sum(data, seg_ids, num_segments,
                                    out_placements)
    _check(data, seg_ids, num_segments)
    if data.device.type not in ("cuda", "cpu"):
        raise ValueError(f"segment_reduce runs on cpu or cuda, not "
                         f"{data.device}")
    return _op(data, seg_ids, num_segments)


def _sharded_segment_sum(data, seg_ids, num_segments: int,
                         out_placements=None):
    """segment_sum_sorted on DTensors (the ``segment_reduce`` region of
    ``dist/regions.py``), along each mesh dim:

    * data rows sharded (``Shard(0)``): the ids sharded alike, each rank's
      rows non-decreasing; each rank sums its rows and the output is the
      sum of the ranks' (``Partial``);
    * data replicated and ``out_placements`` ``Shard(0)`` there: the output
      sharded by segment range (a vocab-parallel embedding's gradient);
      each rank shifts the ids by its range's start, and the kernel drops
      the rows outside [0, its segment count);
    * data features sharded (``Shard(1)``): the output sharded alike;
    * else replicated.

    Integer sums stay exact; a float sum under ``Partial`` adds the ranks'
    sums in another order than one device does."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.dist import regions

    mesh = data.device_mesh
    want = list(out_placements or [Replicate()] * mesh.ndim)
    d_pl, i_pl, o_pl = [], [], []
    for d, p in enumerate(data.placements):
        if isinstance(p, Shard) and p.dim == 0:
            d_pl.append(p), i_pl.append(p), o_pl.append(Partial())
        elif isinstance(p, Shard) and p.dim == 1:
            d_pl.append(p), i_pl.append(Replicate()), o_pl.append(p)
        elif isinstance(want[d], Shard) and want[d].dim == 0:
            d_pl.append(Replicate()), i_pl.append(Replicate())
            o_pl.append(Shard(0))
        else:
            d_pl.append(Replicate()), i_pl.append(Replicate())
            o_pl.append(Replicate())
    data = regions.to(data, d_pl)
    seg_ids = regions.to(seg_ids, i_pl)

    def local(dl, il):
        s0, s1 = regions.shard_range(mesh, o_pl, 0, num_segments)
        if s0:
            il = il - s0
        return segment_sum_sorted(dl, il, s1 - s0)

    return regions.run("segment_reduce", local, mesh, (data, seg_ids),
                       (d_pl, i_pl), o_pl, (d_pl, None),
                       (num_segments, data.shape[1]))
