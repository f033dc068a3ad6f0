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
it) and saves q, k, v, o and lse; its backward is a backward kernel on the
card and ``flash_attention_bwd_ref`` on the CPU.  The backward's kernels
go by dtype, as the forward's do inside its launcher: float32 to the
CUDA-core kernels of ``flash_attention_bwd.cu``, bfloat16 and float16 to
the tensor-core kernels of ``flash_attention_bwd_tc.cu``
(``BWD_SOURCES``); ``bwd_launches`` counts the launches of each.  The
reference has no backward kernel: it trains through ``chunked_attention``,
which XLA differentiates.

The forward and the backward are custom ops (``repro_torch::flash_attention``
and ``repro_torch::flash_attention_bwd``, see ``kernels/__init__.py``);
their cost formulas count the work of the visible (query, key) pairs only
(:func:`attention_pairs`).
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import numpy as np
import torch

from repro_torch.kernels import _build, cost, launch_counts, nbytes, op_costs
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_ref)

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_DV = 256  # the widest value head the kernel takes
# the backward's kernel source for each dtype: CUDA cores for float32,
# tensor cores for the 16-bit types
BWD_SOURCES = {torch.float32: "flash_attention_bwd",
               torch.bfloat16: "flash_attention_bwd_tc",
               torch.float16: "flash_attention_bwd_tc"}
# launches of the backward by source in this process (each also adds one
# to launch_counts["flash_attention_bwd"])
bwd_launches: Counter = Counter()


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
def _bwd_library(name: str):
    """The C launcher of the backward kernels in source ``name`` (one of
    ``BWD_SOURCES``' values) and their largest head dim."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, getattr(lib, f"{name}_max_head_dim")()


def _check(q, k, v) -> None:
    """Shapes, types and devices of a call; a shard with no query head
    (H = Hkv = 0) is a valid call with an empty result."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3] or not 1 <= v.shape[3] <= MAX_DV:
        raise ValueError(f"q must be (B, H, Sq, D), k (B, Hkv, Skv, D) and v "
                         f"(B, Hkv, Skv, Dv) with 1 <= Dv <= {MAX_DV}, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or (h > 0 and (
            k.shape[1] < 1 or h % k.shape[1] != 0)) or \
            (h == 0 and k.shape[1] != 0):
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}: same B and D, H % Hkv == 0 "
                         f"(or H = Hkv = 0)")
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
    """Launch the three backward kernels of q's dtype (``BWD_SOURCES``) on
    the current stream: (dq, dk, dv) in q's dtype."""
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    source = BWD_SOURCES[q.dtype]
    fn, max_d = _bwd_library(source)
    b, h, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if max(d, dv) > max_d:
        raise ValueError(f"flash_attention's backward takes D, Dv <= {max_d}, "
                         f"got {d}, {dv}")
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dvv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, h, hkv, sq,
                 skv, d, dv, int(causal), int(window), int(q_offset),
                 DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed "
                           f"({source}) with CUDA error {err}")
    launch_counts["flash_attention_bwd"] += 1
    bwd_launches[source] += 1
    return dq, dk, dvv


def attention_pairs(sq: int, skv: int, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> int:
    """Visible (query, key) pairs of one (batch, head): query i at position
    i + ``q_offset`` sees key j < ``skv`` where j <= i + q_offset (causal)
    and i + q_offset - j < ``window`` (``window`` > 0)."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_cost(q, k, v, causal: bool = True, window: int = 0,
                         q_offset: int = 0, with_lse: bool = False) -> dict:
    """One forward call: q k^T and P V, 2 D + 2 Dv flops and one exp a
    visible pair; q, k, v read and o (and the lse) written once."""
    b, h, sq, d = q.shape
    pairs = attention_pairs(sq, k.shape[2], causal, window, q_offset) * b * h
    dv = v.shape[3]
    out = b * h * sq * (dv * q.element_size() + (4 if with_lse else 0))
    return cost((2 * d + 2 * dv) * pairs, nbytes(q, k, v) + out, pairs)


def flash_attention_bwd_cost(q, k, v, o, lse, do, causal: bool = True,
                             window: int = 0, q_offset: int = 0) -> dict:
    """One backward call: S = q k^T (2 D), dP = do v^T (2 Dv), dV = P^T do
    (2 Dv), dQ = dS k (2 D), dK = dS^T q (2 D) flops and one exp a visible
    pair; q, k, v, o, lse, do read and dq, dk, dv written once."""
    b, h, sq, d = q.shape
    pairs = attention_pairs(sq, k.shape[2], causal, window, q_offset) * b * h
    dv = v.shape[3]
    return cost((6 * d + 4 * dv) * pairs,
                2 * nbytes(q, k, v) + nbytes(o, lse, do), pairs)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, q_offset: int,
                with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the plain version on the CPU; lse is empty (0,) unless
    ``with_lse``."""
    if q.numel() == 0 or k.numel() == 0:
        return _empty_forward(q, v, with_lse)
    if with_lse:
        o, lse = flash_attention_ref(q, k, v, causal, window, q_offset,
                                     return_lse=True)
        return o.contiguous(), lse.contiguous()
    return (flash_attention_ref(q, k, v, causal, window, q_offset)
            .contiguous(), _no_lse(q))


def _no_lse(q):
    return torch.empty((0,), dtype=torch.float32, device=q.device)


def _empty_forward(q, v, with_lse: bool):
    """The forward's result where q or k holds no element (a shard with
    no query head, an empty batch or sequence): zeros, no launch."""
    b, h, sq, _ = q.shape
    lse = torch.full((b, h, sq), float("-inf"), device=q.device) \
        if with_lse else _no_lse(q)
    return q.new_zeros((b, h, sq, v.shape[3])), lse


@_forward_op.register_kernel("cuda")
def _(q, k, v, causal, window, q_offset, with_lse):
    if q.numel() == 0 or k.numel() == 0:
        return _empty_forward(q, v, with_lse)
    if with_lse:
        return _flash_attention_cuda(q, k, v, causal, window, q_offset, True)
    return (_flash_attention_cuda(q, k, v, causal, window, q_offset),
            _no_lse(q))


@_forward_op.register_fake
def _(q, k, v, causal, window, q_offset, with_lse):
    b, h, sq, _ = q.shape
    return (q.new_empty((b, h, sq, v.shape[3])),
            q.new_empty((b, h, sq) if with_lse else (0,),
                        dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 causal: bool, window: int, q_offset: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    return tuple(x.contiguous() for x in flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal, window, q_offset))


@_backward_op.register_kernel("cuda")
def _(q, k, v, o, lse, do, causal, window, q_offset):
    return _flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, window,
                                     q_offset)


@_backward_op.register_fake
def _(q, k, v, o, lse, do, causal, window, q_offset):
    return tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                 for x in (q, k, v))


op_costs["repro_torch::flash_attention"] = flash_attention_cost
op_costs["repro_torch::flash_attention_bwd"] = flash_attention_bwd_cost


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` from its inputs, its output
    o, the rows' log-sum-exp and o's cotangent ``do``: the backward kernel
    on CUDA tensors, its plain version on CPU tensors."""
    return _backward_op(q, k, v, o, lse, do, causal, window, q_offset)


class _FlashAttention(torch.autograd.Function):
    """flash_attention with a gradient: the forward saves q, k, v, o and
    the rows' log-sum-exp; the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = _forward_op(q, k, v, causal, window, q_offset, True)
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
    version on the CPU) gives it.  DTensors go to
    :func:`_sharded_flash_attention`, the kernel on each rank's shards.
    """
    _check(q, k, v)
    from repro_torch.dist import regions

    if regions.is_dtensor(q):
        return _sharded_flash_attention(q, k, v, causal, window, q_offset)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward_op(q, k, v, causal, window, q_offset, False)[0]


def _kv_heads(kl, vl, h0: int, h1: int, group: int):
    """The kv heads that query heads [h0, h1) attend to, as a shard's call
    of the kernel needs them (its head h maps to kv head h // (its H / its
    Hkv)): a slice where the shard holds whole groups or lies in one, else
    each query head's kv head repeated (heads straddling two groups)."""
    if h1 == h0:
        return kl[:, :0], vl[:, :0]
    first, last = h0 // group, (h1 - 1) // group
    if (h0 % group == 0 and h1 % group == 0) or first == last:
        return kl[:, first:last + 1], vl[:, first:last + 1]
    counts = [min(h1, (j + 1) * group) - max(h0, j * group)
              for j in range(first, last + 1)]

    def repeat(x):
        return torch.cat([x[:, j:j + 1].expand(-1, c, -1, -1) for j, c in
                          zip(range(first, last + 1), counts)], dim=1)

    return repeat(kl), repeat(vl)


def _sharded_flash_attention(q, k, v, causal: bool, window: int,
                             q_offset: int):
    """flash_attention on DTensors (the ``flash_attention`` region of
    ``dist/regions.py``): along each mesh dim, q's batch rows (``Shard(0)``)
    shard k, v and the output alike; q's heads (``Shard(1)``) shard the
    output, and k, v are replicated there unless Hkv = H (MLA: sharded
    alike).  Any other layout of q is replicated first.  Each rank calls
    the kernel on its shards with the kv heads of its global query heads
    (:func:`_kv_heads`); the gradients of replicated k, v are each rank's
    share of a sum (``Partial``).  A rank with no query head (H smaller
    than the head axes) makes no launch."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.dist import regions

    mesh = q.device_mesh
    h, hkv = q.shape[1], k.shape[1]
    q_pl, kv_pl, kv_grad = [], [], []
    for p in q.placements:
        if isinstance(p, Shard) and p.dim in (0, 1):
            q_pl.append(p)
            shared = p.dim == 0 or hkv == h
            kv_pl.append(p if shared else Replicate())
            kv_grad.append(p if shared else Partial())
        else:
            q_pl += [Replicate()]
            kv_pl += [Replicate()]
            kv_grad += [Replicate()]
    q = regions.to(q, q_pl)
    k, v = (regions.to(x, kv_pl) if regions.is_dtensor(x) else
            regions.replicated(x, mesh, kv_pl) for x in (k, v))
    slice_kv = hkv != h and any(isinstance(p, Shard) and p.dim == 1
                                for p in q_pl)

    def local(ql, kl, vl):
        if slice_kv:
            h0, h1 = regions.shard_range(mesh, q_pl, 1, h)
            kl, vl = _kv_heads(kl, vl, h0, h1, h // hkv)
        return flash_attention(ql, kl, vl, causal, window, q_offset)

    return regions.run("flash_attention", local, mesh, (q, k, v),
                       (q_pl, kv_pl, kv_pl), q_pl, (q_pl, kv_grad, kv_grad),
                       (*q.shape[:3], v.shape[3]))

