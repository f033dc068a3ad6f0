"""GraphSAGE (Hamilton et al. 2017): sampled mean-aggregation node classifier
(counterpart of ``repro.models.gnn.graphsage``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.gnn.common import (
    GraphBatch, gather_nodes, plan_of, scatter_mean,
)
from repro_torch.models.layers import cross_entropy_loss, dense_init


@dataclass(frozen=True)
class SageConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    aggregator: str = "mean"
    sample_sizes: tuple = (25, 10)
    dtype: str = "float32"

    def param_count(self) -> int:
        total, d = 0, self.d_in
        for i in range(self.n_layers):
            out = self.n_classes if i == self.n_layers - 1 else self.d_hidden
            total += 2 * d * out
            d = out
        return total


def init_params(cfg: SageConfig, gen: torch.Generator):
    dt = getattr(torch, cfg.dtype)
    layers = []
    d = cfg.d_in
    for i in range(cfg.n_layers):
        out = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        layers.append({
            "w_self": dense_init(gen, d, out, dt),
            "w_neigh": dense_init(gen, d, out, dt),
        })
        d = out
    return {"layers": layers}


def forward(cfg: SageConfig, params, batch: GraphBatch):
    n = batch.node_feat.shape[0]
    plan = plan_of(batch)
    h = batch.node_feat
    for i, lp in enumerate(params["layers"]):
        msg = gather_nodes(h, plan.senders)
        agg = scatter_mean(msg, plan.receivers, n)
        h_new = h @ lp["w_self"] + agg @ lp["w_neigh"]
        if i < cfg.n_layers - 1:
            h_new = F.relu(h_new)
            # L2 normalize (paper's trick for stability)
            h_new = h_new / torch.clamp(
                torch.linalg.vector_norm(h_new, dim=-1, keepdim=True),
                min=1e-6)
        h = h_new
    return h  # (N, n_classes) logits


def loss_fn(cfg: SageConfig, params, batch_and_labels):
    batch, labels = batch_and_labels["graph"], batch_and_labels["labels"]
    logits = forward(cfg, params, batch)
    return cross_entropy_loss(logits, labels), {}
