"""Public wrappers of the jet_gain kernel, plus the ELL glue around it.

Counterpart of ``repro.kernels.jet_gain.ops``.  The glue (``csr_to_ell``,
``lookup_nbr_parts``, ``update_nbr_parts``, ``ell_to_matrix``) is plain
PyTorch.  :func:`jet_gain_from_parts` sends a CPU tensor to the plain
version in ``ref.py`` and a CUDA tensor to the kernel in ``jet_gain.cu``;
there is no third path.

Trial batching: the ELL adjacency (``nbr``, ``wgt``) is (N, D) and shared by
all trials; per-trial arrays carry a T axis (``parts`` (T, N), ``nbr_parts``
(T, N, D)), or none.  On a fleet bucket every array has a leading lane axis
B: the adjacency is (B, N, D), one per lane and never copied T times, and
per-trial arrays are (B, T, N[, D]).

The query is a custom op (``repro_torch::jet_gain``, see
``kernels/__init__.py``) with a cost formula.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import trace
from repro_torch.core.graph import trial_axis
from repro_torch.kernels import _build, cost, launch_counts, nbytes, op_costs
from repro_torch.kernels.jet_gain.ref import jet_gain_ref


def csr_to_ell(g, max_degree: int | None = None):
    """Pad CSR adjacency to (..., N, D). Returns (nbr, wgt), each (..., N, D).

    Slots beyond a vertex's degree have nbr == N (ghost) and weight 0.
    """
    deg = g.degrees()
    d = int(max_degree) if max_degree else int(deg.max())
    slots = torch.arange(d, dtype=torch.int32, device=g.device)
    eidx = (g.xadj[..., :-1, None] + slots).clamp(0, g.m_max - 1).long()
    valid = slots < deg[..., None]

    def gather(a):  # a (..., M) at the (..., N, D) edge slots
        return a.gather(-1, eidx.flatten(-2)).view(eidx.shape)

    nbr = torch.where(valid, gather(g.adjncy), g.n_max)
    wgt = torch.where(valid, gather(g.adjwgt), 0)
    return nbr, wgt


def _ext(x: torch.Tensor, fill) -> torch.Tensor:
    """Append one ``fill`` entry to the last axis (the ghost neighbor N)."""
    pad = torch.full((*x.shape[:-1], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], -1)


def _at_slots(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``x`` (..., [T,] N+1) read at the neighbor slots ``nbr`` (..., N, D):
    (..., [T,] N, D)."""
    idx = nbr.clamp(0, x.shape[-1] - 1).long().flatten(-2)
    idx = idx.view(*idx.shape[:-1], *[1] * (x.dim() - idx.dim()),
                   idx.shape[-1])
    out = x.gather(-1, idx.expand(*x.shape[:-1], idx.shape[-1]))
    return out.view(*x.shape[:-1], *nbr.shape[-2:])


def lookup_nbr_parts(nbr, parts, k: int):
    """(..., [T,] N, D) neighbor part ids from a parts batch; ghost slots
    map to k."""
    n = parts.shape[-1]
    nbr_parts = _at_slots(_ext(parts.int(), k), nbr)
    return torch.where(trial_axis(nbr >= n, nbr_parts.dim(), at=-3), k,
                       nbr_parts)


def update_nbr_parts(nbr, nbr_parts, move, dest, k: int):
    """Rewrite the slots whose neighbor moved (paper Alg 4.4)."""
    return torch.where(_at_slots(_ext(move, False), nbr),
                       _at_slots(_ext(dest.int(), k), nbr), nbr_parts)


def ell_to_matrix(nbr_parts, wgt, k: int):
    """(..., N, k+1) dense connectivity matrix from maintained ELL state.

    Used by the (rare) rebalance iterations.  An integer scatter-add, so the
    result does not depend on the order of the adds; slot part ids outside
    [0, k] are dropped, as the reference's scatter drops them.
    """
    p = nbr_parts.long()
    valid = (p >= 0) & (p <= k)
    mat = torch.zeros(*nbr_parts.shape[:-1], k + 1, dtype=torch.int32,
                      device=nbr_parts.device)
    wgt = trial_axis(wgt, p.dim(), at=-3)
    return mat.scatter_add_(-1, torch.where(valid, p, 0),
                            torch.where(valid, wgt, 0))


def _check(nbr_parts, wgt, parts) -> None:
    """The panel's shapes: ``wgt`` is (N, D) or (B, N, D), ``nbr_parts``
    has wgt's shape or one more axis, T, before N."""
    def shapes():
        return (f"nbr_parts {tuple(nbr_parts.shape)}, wgt "
                f"{tuple(wgt.shape)}, parts {tuple(parts.shape)}")

    if wgt.dim() not in (2, 3) or \
            nbr_parts.dim() not in (wgt.dim(), wgt.dim() + 1):
        raise ValueError(f"nbr_parts must be ([B,] [T,] N, D) and wgt "
                         f"([B,] N, D): {shapes()}")
    lanes = wgt.dim() - 2
    if nbr_parts.shape[:lanes] != wgt.shape[:lanes] or \
            nbr_parts.shape[-2:] != wgt.shape[-2:] or \
            parts.shape != nbr_parts.shape[:-1]:
        raise ValueError(f"shape mismatch: {shapes()}")
    for name, x in (("nbr_parts", nbr_parts), ("wgt", wgt), ("parts", parts)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != nbr_parts.device:
            raise ValueError(f"{name} is on {x.device}, nbr_parts on "
                             f"{nbr_parts.device}")


@functools.cache
def _launcher():
    """The C launcher ``jet_gain_launch`` of ``jet_gain.cu``, built at first use."""
    fn = _build.load("jet_gain").jet_gain_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _jet_gain_cuda(nbr_parts, wgt, parts, k: int):
    """Launch ``jet_gain.cu`` on the current stream (strided views are
    copied to contiguous first); the wrapper has checked the shapes."""
    n, d = wgt.shape[-2:]
    per_lane = (parts.shape[1:] if wgt.dim() == 3 else parts.shape).numel()
    nbr_parts, wgt, parts = (x.contiguous() for x in (nbr_parts, wgt, parts))
    fn = _launcher()
    out = [torch.empty(parts.shape, dtype=torch.int32, device=parts.device)
           for _ in range(3)]
    with torch.cuda.device(parts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(nbr_parts.data_ptr(), wgt.data_ptr(), parts.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 parts.numel(), per_lane, n, d, k, stream)
    if err != 0:
        raise RuntimeError(f"jet_gain kernel launch failed with CUDA error {err}")
    launch_counts["jet_gain"] += 1
    return out[0], out[1], out[2]


def jet_gain_cost(nbr_parts, wgt, parts, k: int) -> dict:
    """One call: an integer add a slot (counted as one operation); the
    slots' parts and weights and the rows' parts read, and the three (rows,)
    answers written once, all int32."""
    return cost(nbr_parts.numel(), nbytes(nbr_parts, wgt) + 4 * nbytes(parts))


@torch.library.custom_op("repro_torch::jet_gain", mutates_args=(),
                         device_types="cpu")
def _op(nbr_parts: torch.Tensor, wgt: torch.Tensor, parts: torch.Tensor,
        k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(x.contiguous() for x in jet_gain_ref(nbr_parts, wgt, parts,
                                                      k))


@_op.register_kernel("cuda")
def _(nbr_parts, wgt, parts, k):
    return _jet_gain_cuda(nbr_parts, wgt, parts, k)


@_op.register_fake
def _(nbr_parts, wgt, parts, k):
    return tuple(torch.empty(parts.shape, dtype=torch.int32,
                             device=parts.device) for _ in range(3))


op_costs["repro_torch::jet_gain"] = jet_gain_cost


def jet_gain_from_parts(nbr_parts, wgt, parts, k: int):
    """Fused conn_self / best_part / best_conn from maintained neighbor parts
    — the entry point of the stateful ELL backend.

    A CPU tensor goes to the plain version, a CUDA tensor to the kernel.
    The host time from here to the launch's return (the check, the custom
    op's dispatch, the ctypes launch) adds to the call's record.
    """
    t0 = trace.clock()
    if nbr_parts.device.type not in ("cuda", "cpu"):
        raise ValueError(f"jet_gain runs on cpu or cuda, not "
                         f"{nbr_parts.device}")
    _check(nbr_parts, wgt, parts)
    out = _op(nbr_parts, wgt, parts, k)
    trace.current().jet_gain_ns += trace.clock() - t0
    return out


def jet_gain(nbr, wgt, parts, k: int):
    """Fused conn_self / best_part / best_conn from neighbor ids: part ids
    are looked up here and the ghost id N maps to ghost part k."""
    return jet_gain_from_parts(lookup_nbr_parts(nbr, parts, k), wgt, parts, k)
