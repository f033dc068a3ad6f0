"""Factorization Machine (Rendle, ICDM'10) with a hashed embedding table.

Counterpart of ``repro.models.recsys.fm``: plain functions over a dict of
tensors ``{"table" (V, D), "linear" (V,), "bias" ()}``.  Lookups index a
single hashed table with per-field offsets, and the second-order term is
the fm_interaction kernel (``kernels/fm_interaction``; its plain version on
the CPU).  In training the lookups go through ``models/gather.py``: one
sorted index of the batch's flat ids serves ``table`` and ``linear``, and
each table's gradient is one segment_reduce sum; fm_interaction's gradient
is its backward kernel.  On DTensors (a sharded step: both tables' rows
over ("data", "model")) the lookups are vocab-parallel and each rank sorts
its own ids for the gradient (``models/gather.py``); fm_interaction takes
the lookup's ``Partial`` rows reduced onto the batch
(``kernels/fm_interaction/ops.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.dist import regions
from repro_torch.kernels.fm_interaction import ops
from repro_torch.models.gather import embedding, sorted_index
from repro_torch.models.layers import embed_init


@dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_fields: int = 39
    embed_dim: int = 10
    rows_per_field: int = 262144   # hashed vocabulary per sparse field
    dtype: str = "float32"

    @property
    def vocab_total(self) -> int:
        return self.n_fields * self.rows_per_field

    def param_count(self) -> int:
        return self.vocab_total * (self.embed_dim + 1) + 1


def init_params(cfg: FMConfig, gen: torch.Generator, device=None):
    """Draws on ``gen``'s device, then moves to ``device`` (default: there)."""
    device = gen.device if device is None else torch.device(device)
    params = {
        "table": embed_init(gen, cfg.vocab_total, cfg.embed_dim,
                            getattr(torch, cfg.dtype)),
        "linear": torch.randn(cfg.vocab_total, generator=gen,
                              device=gen.device) * 0.01,
        "bias": torch.zeros((), device=gen.device),
    }
    return {k: v.to(device) for k, v in params.items()}


def _flat_ids(cfg: FMConfig, ids, fields: int):
    """Raw per-field ids (..., fields) -> rows of the hashed table."""
    offsets = torch.arange(fields, device=ids.device) * cfg.rows_per_field
    return (ids.long() % cfg.rows_per_field) + offsets


def forward(cfg: FMConfig, params, ids):
    """ids (B, F) integer per-field raw ids -> scores (B,) float32."""
    flat = _flat_ids(cfg, ids, cfg.n_fields)                 # (B, F)
    index = None
    if torch.is_grad_enabled() and params["table"].requires_grad and \
            not regions.is_dtensor(params["table"]):
        index = sorted_index(flat.reshape(-1), cfg.vocab_total, counts=False)
    emb = embedding(params["table"], flat, index)            # (B, F, D)
    lin = embedding(params["linear"], flat, index)           # (B, F)
    second = ops.fm_interaction(emb)
    return params["bias"] + torch.sum(lin, -1) + second.float()


def loss_fn(cfg: FMConfig, params, batch):
    scores = forward(cfg, params, batch["ids"])
    y = batch["labels"].float()
    # BCE with logits
    loss = torch.mean(torch.clamp(scores, min=0) - scores * y
                      + torch.log1p(torch.exp(-torch.abs(scores))))
    return loss, {"auc_proxy": torch.mean(((scores > 0) == (y > 0.5)).float())}


def serve(cfg: FMConfig, params, ids):
    """Online/bulk scoring path."""
    return forward(cfg, params, ids)


def retrieval_scores(cfg: FMConfig, params, user_ids, cand_ids):
    """Score one user against C candidate items (batched dot, no loop).

    The FM score decomposes as const(u) + <sum_f v_uf, v_i> + lin_i for a
    single candidate field; this returns the candidate-dependent part.
    user_ids (1, F-1); cand_ids (C,) raw ids in the item field (field F-1).
    Both lookups go through ``embedding``, so a sharded table serves them.
    """
    f_user = cfg.n_fields - 1
    u_emb = embedding(params["table"], _flat_ids(cfg, user_ids, f_user))
    u_vec = torch.sum(u_emb, dim=1)                            # (1, D)
    flat_c = (cand_ids.long() % cfg.rows_per_field) + f_user * cfg.rows_per_field
    c_emb = embedding(params["table"], flat_c)                 # (C, D)
    c_lin = embedding(params["linear"], flat_c)                # (C,)
    return c_emb.float() @ u_vec[0].float() + c_lin            # (C,)
