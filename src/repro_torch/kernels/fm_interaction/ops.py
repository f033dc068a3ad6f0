"""Public wrapper of the fm_interaction kernel.

Counterpart of ``repro.kernels.fm_interaction.ops``.  :func:`fm_interaction`
sends a CPU tensor to the plain version in ``ref.py`` and a CUDA tensor to
the kernel in ``fm_interaction.cu``; there is no third path.  Unlike the
JAX wrapper it needs no padding of B to a block.  Both paths take float32,
bfloat16 and float16 (each cast to float32 on load, as the reference casts
any float) and strided views, and refuse the same inputs with the same
message.

Where ``emb`` needs a gradient, the call goes through an autograd Function
whose backward is the backward kernel in the same ``.cu`` (its plain
version ``fm_interaction_bwd_ref`` on the CPU).  Both directions are
custom ops (``repro_torch::fm_interaction``, ``repro_torch::
fm_interaction_bwd``, see ``kernels/__init__.py``) with a cost formula each.
On DTensors (a sharded step) the call runs in the ``fm_interaction``
region of ``dist/regions.py`` (:func:`_sharded_fm_interaction`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, cost, launch_counts, nbytes, op_costs
from repro_torch.kernels.fm_interaction.ref import (
    fm_interaction_bwd_ref, fm_interaction_ref)

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
    bwd = lib.fm_interaction_bwd_launch
    bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fn, bwd


def _fm_interaction_cuda(emb):
    """Launch ``fm_interaction.cu`` on the current stream."""
    emb = emb.contiguous()
    fn = _library()[0]
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


def _fm_interaction_bwd_cuda(emb, g):
    """Launch the backward kernel: the gradient (B, F, D) in emb's dtype."""
    emb, g = emb.contiguous(), g.float().contiguous()
    fn = _library()[1]
    b, f, d = emb.shape
    grad = torch.empty_like(emb)
    if grad.numel() == 0:
        return grad
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(emb.data_ptr(), g.data_ptr(), grad.data_ptr(), b, f, d,
                 DTYPES[emb.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fm_interaction backward kernel launch failed "
                           f"with CUDA error {err}")
    launch_counts["fm_interaction_bwd"] += 1
    return grad


def fm_interaction_cost(emb) -> dict:
    """One forward call: Σ_f e, Σ_f e² and their difference, 3 flops an
    element, then 3 a (row, d) and one a row; emb read and the (B,)
    float32 scores written once."""
    b, f, d = emb.shape
    return cost(3 * b * f * d + 3 * b * d + b, nbytes(emb) + 4 * b)


def fm_interaction_bwd_cost(emb, g) -> dict:
    """One backward call: s - e, times g, and the sum, 3 flops an element;
    emb and g (float32) read, the gradient written once in emb's dtype."""
    return cost(3 * emb.numel(), 2 * nbytes(emb) + 4 * emb.shape[0])


@torch.library.custom_op("repro_torch::fm_interaction", mutates_args=(),
                         device_types="cpu")
def _forward_op(emb: torch.Tensor) -> torch.Tensor:
    return fm_interaction_ref(emb).contiguous()


@_forward_op.register_kernel("cuda")
def _(emb):
    return _fm_interaction_cuda(emb)


@_forward_op.register_fake
def _(emb):
    return emb.new_empty((emb.shape[0],), dtype=torch.float32)


@torch.library.custom_op("repro_torch::fm_interaction_bwd", mutates_args=(),
                         device_types="cpu")
def _backward_op(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return fm_interaction_bwd_ref(emb, g).contiguous()


@_backward_op.register_kernel("cuda")
def _(emb, g):
    return _fm_interaction_bwd_cuda(emb, g)


@_backward_op.register_fake
def _(emb, g):
    return torch.empty(emb.shape, dtype=emb.dtype, device=emb.device)


op_costs["repro_torch::fm_interaction"] = fm_interaction_cost
op_costs["repro_torch::fm_interaction_bwd"] = fm_interaction_bwd_cost


def fm_interaction_bwd(emb, g):
    """The gradient of :func:`fm_interaction` at ``emb`` for the scores'
    cotangent ``g`` (B,): the backward kernel on a CUDA tensor, its plain
    version on a CPU tensor."""
    return _backward_op(emb, g)


class _FmInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return _forward_op(emb)

    @staticmethod
    def backward(ctx, g):
        (emb,) = ctx.saved_tensors
        return fm_interaction_bwd(emb, g)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """emb (B, F, D) float32, bfloat16 or float16 -> (B,) float32
    second-order FM scores.  A CPU tensor goes to the plain version, a CUDA
    tensor to the kernel; a DTensor to :func:`_sharded_fm_interaction`,
    the kernel on each rank's shard."""
    from repro_torch.dist import regions

    if regions.is_dtensor(emb):
        return _sharded_fm_interaction(emb)
    if emb.dim() != 3:
        raise ValueError(f"emb must be (B, F, D), got {tuple(emb.shape)}")
    if emb.dtype not in DTYPES:
        raise TypeError(f"emb must be one of {list(DTYPES)}, got "
                        f"{emb.dtype}")
    if not 1 <= emb.shape[2] <= MAX_DIM:
        raise ValueError(f"fm_interaction takes 1 <= D <= {MAX_DIM}, got "
                         f"{emb.shape[2]}")
    if emb.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fm_interaction runs on cpu or cuda, not "
                         f"{emb.device}")
    if torch.is_grad_enabled() and emb.requires_grad:
        return _FmInteraction.apply(emb)
    return _forward_op(emb)


def _fm_layouts(emb) -> tuple[list, list]:
    """(emb, output) placements of a sharded call, along each mesh dim:
    batch rows sharded (``Shard(0)``) shard the output alike; D sharded
    (``Shard(2)``) gives each rank the sum over its columns, a ``Partial``
    output (the function is a sum over D of per-column terms); F sharded
    is gathered (a column's sum runs over every field); a ``Partial`` emb
    (a vocab-parallel lookup's) is reduced first, since the square is not
    linear: onto batch rows where they divide evenly (a reduce-scatter),
    else replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.dist import regions

    e_pl, o_pl = [], []
    for p in regions.partials_onto_rows(emb.placements, emb.device_mesh,
                                        emb.shape[0]):
        if p == Shard(0):
            e_pl.append(p), o_pl.append(p)
        elif p == Shard(2):
            e_pl.append(p), o_pl.append(Partial())
        else:
            e_pl.append(Replicate()), o_pl.append(Replicate())
    return e_pl, o_pl


def _sharded_fm_interaction(emb):
    """fm_interaction on a DTensor (the ``fm_interaction`` region of
    ``dist/regions.py``), laid out as :func:`_fm_layouts` says: each rank
    calls the kernel (forward, and backward where emb needs a gradient) on
    its shard.  The gradient is laid out as emb: a D-sharded shard's
    backward is local, since its Σ_f runs per column, and the cotangent of
    a ``Partial`` output is the whole one on every rank."""
    from repro_torch.dist import regions

    e_pl, o_pl = _fm_layouts(emb)
    emb = regions.to(emb, e_pl)
    return regions.run("fm_interaction", fm_interaction, emb.device_mesh,
                       (emb,), (e_pl,), o_pl, None, (emb.shape[0],))
