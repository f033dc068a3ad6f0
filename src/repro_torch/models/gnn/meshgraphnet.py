"""MeshGraphNet (Pfaff et al. 2020): encode-process-decode mesh simulator
(counterpart of ``repro.models.gnn.meshgraphnet``).

The reference runs its 15 identical processor blocks as a ``lax.scan``
over stacked (L, ...) params under ``jax.checkpoint``.  Here they are a
Python loop over the layer slices, each block under
``torch.utils.checkpoint``: the backward pass keeps only each block's
input (h, e) and recomputes the block, so the saved activations are 15 x
(N + E) x d_hidden floats, not every edge MLP's intermediates.  On a mesh
each block's node and edge rows are sharded over every axis
(``constrain(h, "all", None)`` at the reference's sites).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.constrain import constrain
from repro_torch.models.gnn.common import (
    GraphBatch, edge_vectors, gather_nodes, layer, mlp_apply, mlp_init,
    plan_of, scatter_sum,
)


@dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_in: int = 4          # node input features
    d_edge_in: int = 4     # rel pos (3) + dist (1)
    d_out: int = 2
    dtype: str = "float32"

    def _mlp(self, d_in):
        return d_in * self.d_hidden + (self.mlp_layers - 1) * self.d_hidden ** 2

    def param_count(self) -> int:
        enc = self._mlp(self.d_in) + self._mlp(self.d_edge_in)
        proc = self.n_layers * (self._mlp(3 * self.d_hidden)
                                + self._mlp(2 * self.d_hidden))
        return enc + proc + self.d_hidden * self.d_out


def _mlp_dims(cfg, d_in, d_out=None):
    return (d_in,) + (cfg.d_hidden,) * (cfg.mlp_layers - 1) + (
        d_out or cfg.d_hidden,)


def init_params(cfg: MGNConfig, gen: torch.Generator):
    lead = (cfg.n_layers,)
    return {
        "enc_n": mlp_init(gen, _mlp_dims(cfg, cfg.d_in)),
        "enc_e": mlp_init(gen, _mlp_dims(cfg, cfg.d_edge_in)),
        "blocks": {   # stacked (L, ...) leaves
            "edge": mlp_init(gen, _mlp_dims(cfg, 3 * cfg.d_hidden),
                             lead=lead),
            "node": mlp_init(gen, _mlp_dims(cfg, 2 * cfg.d_hidden),
                             lead=lead),
        },
        "dec": mlp_init(gen, _mlp_dims(cfg, cfg.d_hidden, cfg.d_out)),
    }


def _block(blk, h, e, senders, receivers, valid):
    h = constrain(h, "all", None)
    e = constrain(e, "all", None)
    hs = gather_nodes(h, senders)
    hr = gather_nodes(h, receivers)
    e = e + mlp_apply(blk["edge"], torch.cat([e, hs, hr], -1),
                      act=F.relu) * valid
    agg = scatter_sum(e, receivers, h.shape[0])
    h = h + mlp_apply(blk["node"], torch.cat([h, agg], -1), act=F.relu)
    return constrain(h, "all", None), constrain(e, "all", None)


def forward(cfg: MGNConfig, params, batch: GraphBatch):
    plan = plan_of(batch)
    rel, dist, valid = edge_vectors(batch)
    valid = valid[:, None].to(rel.dtype)
    efeat = torch.cat([rel, dist[:, None]], -1)
    h = mlp_apply(params["enc_n"], batch.node_feat, act=F.relu)
    e = mlp_apply(params["enc_e"], efeat, act=F.relu)
    e = e * valid
    for i in range(cfg.n_layers):
        h, e = checkpoint(_block, layer(params["blocks"], i), h, e,
                          plan.senders, plan.receivers, valid,
                          use_reentrant=False, preserve_rng_state=False)
    return mlp_apply(params["dec"], h, act=F.relu)  # (N, d_out)


def loss_fn(cfg: MGNConfig, params, batch_and_labels):
    batch, target = batch_and_labels["graph"], batch_and_labels["target"]
    pred = forward(cfg, params, batch)
    mask = (batch.graph_id < batch.n_graphs).float()[:, None]
    loss = torch.sum(((pred - target) ** 2) * mask) / torch.clamp(
        torch.sum(mask) * cfg.d_out, min=1.0)
    return loss, {}
