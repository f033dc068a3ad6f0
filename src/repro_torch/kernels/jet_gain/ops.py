"""Public wrappers of the jet_gain kernel, plus the ELL glue around it.

Counterpart of ``repro.kernels.jet_gain.ops``.  The glue (``csr_to_ell``,
``lookup_nbr_parts``, ``update_nbr_parts``, ``ell_to_matrix``) is plain
PyTorch.  :func:`jet_gain_from_parts` sends a CPU tensor to the plain
version in ``ref.py`` and a CUDA tensor to the kernel in ``jet_gain.cu``;
there is no third path.

Trial batching: the ELL adjacency (``nbr``, ``wgt``) is (N, D) and shared by
all trials; per-trial arrays carry a leading T axis (``parts`` (T, N),
``nbr_parts`` (T, N, D)), or none.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.jet_gain.ref import jet_gain_ref


def csr_to_ell(g, max_degree: int | None = None):
    """Pad CSR adjacency to (N, D). Returns (nbr (N,D), wgt (N,D)).

    Slots beyond a vertex's degree have nbr == N (ghost) and weight 0.
    """
    deg = g.degrees()
    d = int(max_degree) if max_degree else int(deg.max())
    slots = torch.arange(d, dtype=torch.int32, device=g.device)
    eidx = (g.xadj[:-1, None] + slots[None, :]).clamp(0, g.m_max - 1).long()
    valid = slots[None, :] < deg[:, None]
    nbr = torch.where(valid, g.adjncy[eidx], g.n_max)
    wgt = torch.where(valid, g.adjwgt[eidx], 0)
    return nbr, wgt


def _ext(x: torch.Tensor, fill) -> torch.Tensor:
    """Append one ``fill`` entry to the last axis (the ghost neighbor N)."""
    pad = torch.full((*x.shape[:-1], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], -1)


def lookup_nbr_parts(nbr, parts, k: int):
    """(..., N, D) neighbor part ids from a parts vector; ghost slots map to k."""
    n = parts.shape[-1]
    nbr_parts = _ext(parts.int(), k)[..., nbr.clamp(0, n).long()]
    return torch.where(nbr >= n, k, nbr_parts)


def update_nbr_parts(nbr, nbr_parts, move, dest, k: int):
    """Rewrite the slots whose neighbor moved (paper Alg 4.4)."""
    idx = nbr.clamp(0, move.shape[-1]).long()
    return torch.where(_ext(move, False)[..., idx], _ext(dest.int(), k)[..., idx],
                       nbr_parts)


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
    return mat.scatter_add_(-1, torch.where(valid, p, 0),
                            torch.where(valid, wgt, 0))


def _check(nbr_parts, wgt, parts):
    d = nbr_parts.shape[-1]
    if nbr_parts.dim() not in (2, 3) or wgt.dim() != 2:
        raise ValueError(f"nbr_parts must be (T, N, D) or (N, D) and wgt "
                         f"(N, D), got {tuple(nbr_parts.shape)}, "
                         f"{tuple(wgt.shape)}")
    if tuple(wgt.shape) != tuple(nbr_parts.shape[-2:]) or \
            tuple(parts.shape) != tuple(nbr_parts.shape[:-1]):
        raise ValueError(f"shape mismatch: nbr_parts {tuple(nbr_parts.shape)}, "
                         f"wgt {tuple(wgt.shape)}, parts {tuple(parts.shape)}")
    for name, x in (("nbr_parts", nbr_parts), ("wgt", wgt), ("parts", parts)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != nbr_parts.device:
            raise ValueError(f"{name} is on {x.device}, nbr_parts on "
                             f"{nbr_parts.device}")
    return d


@functools.cache
def _launcher():
    """The C launcher ``jet_gain_launch`` of ``jet_gain.cu``, built at first use."""
    fn = _build.load("jet_gain").jet_gain_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _jet_gain_cuda(nbr_parts, wgt, parts, k: int):
    """Launch ``jet_gain.cu`` on the current stream."""
    d = _check(nbr_parts, wgt, parts)
    if not all(x.is_contiguous() for x in (nbr_parts, wgt, parts)):
        raise ValueError("jet_gain needs contiguous nbr_parts, wgt and parts")
    fn = _launcher()
    out = torch.empty((3, *parts.shape), dtype=torch.int32,
                      device=parts.device)
    with torch.cuda.device(parts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(nbr_parts.data_ptr(), wgt.data_ptr(), parts.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 parts.numel(), wgt.shape[0], d, k, stream)
    if err != 0:
        raise RuntimeError(f"jet_gain kernel launch failed with CUDA error {err}")
    launch_counts["jet_gain"] += 1
    return out[0], out[1], out[2]


def jet_gain_from_parts(nbr_parts, wgt, parts, k: int):
    """Fused conn_self / best_part / best_conn from maintained neighbor parts
    — the entry point of the stateful ELL backend.

    A CPU tensor goes to the plain version, a CUDA tensor to the kernel.
    """
    if nbr_parts.device.type == "cuda":
        return _jet_gain_cuda(nbr_parts, wgt, parts, k)
    if nbr_parts.device.type == "cpu":
        _check(nbr_parts, wgt, parts)
        return jet_gain_ref(nbr_parts, wgt, parts, k)
    raise ValueError(f"jet_gain runs on cpu or cuda, not {nbr_parts.device}")


def jet_gain(nbr, wgt, parts, k: int):
    """Fused conn_self / best_part / best_conn from neighbor ids: part ids
    are looked up here and the ghost id N maps to ghost part k."""
    return jet_gain_from_parts(lookup_nbr_parts(nbr, parts, k), wgt, parts, k)
