"""Plain PyTorch version of the jet_gain kernel (counterpart of
``repro.kernels.jet_gain.ref.jet_gain_ref``).

Inputs (ELL padded adjacency):
  nbr_parts : ([B,] [T,] N, D) int32 — part id of each neighbor (k on ghost slots)
  nwgt      : ([B,] N, D) int32 — edge weight (0 on ghost slots), shared by
              all trials of a lane
  parts     : ([B,] [T,] N) int32 — current part of each vertex
  k         : number of parts

Outputs, each shaped like ``parts``:
  conn_self : conn(v, P_s(v))
  best_part : argmax_{p != P_s(v), p != k} conn(v, p), smallest p on ties; k if none
  best_conn : its connectivity (0 if none)

Slot part ids outside [0, k] count for nothing, as in the reference's
one-hot sum.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import trial_axis


def jet_gain_ref(nbr_parts, nwgt, parts, k: int):
    d = nbr_parts.shape[-1]
    p = nbr_parts.reshape(-1, d).long()
    w = trial_axis(nwgt, nbr_parts.dim(), at=-3).expand(nbr_parts.shape)
    w = w.reshape(-1, d)
    own = parts.reshape(-1, 1).long()
    valid = (p >= 0) & (p <= k)
    mat = torch.zeros(p.shape[0], k + 1, dtype=torch.int32, device=p.device)
    mat.scatter_add_(1, torch.where(valid, p, 0), torch.where(valid, w, 0))
    conn_self = mat.gather(1, own.clamp(0, k))[:, 0]
    cols = torch.arange(k + 1, device=p.device)
    masked = torch.where((cols == own) | (cols == k), -1, mat)
    best_part = torch.argmax(masked, dim=1).int()
    best_conn = masked.amax(dim=1)
    none = best_conn <= 0
    shape = parts.shape
    return (
        conn_self.reshape(shape),
        torch.where(none, k, best_part).reshape(shape),
        torch.where(none, 0, best_conn).reshape(shape),
    )
