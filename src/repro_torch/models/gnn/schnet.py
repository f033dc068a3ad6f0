"""SchNet (Schuett et al. 2017): continuous-filter convolutions for molecules
(counterpart of ``repro.models.gnn.schnet``).

The species embedding lookup is a :func:`gather_nodes` over the species'
sorted order, so its backward sums on the segment_reduce kernel (an
indexing backward would add floats with atomics); the per-graph energy is
a sum over the sorted ``graph_id`` on the kernel too.  ``constrain`` marks
the node and message rows at the reference's sites.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.constrain import constrain
from repro_torch.models.gnn.common import (
    GraphBatch, cosine_cutoff, edge_vectors, gather_nodes, graph_sum, layer,
    mlp_apply, mlp_init, plan_of, rbf_expand, scatter_sum, sorted_index,
)
from repro_torch.models.layers import embed_init


def shifted_softplus(x):
    return F.softplus(x) - math.log(2.0)


@dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    dtype: str = "float32"

    def param_count(self) -> int:
        d, r = self.d_hidden, self.n_rbf
        per = (r * d + d * d) + 3 * d * d  # filter net + in/out dense
        return self.n_species * d + self.n_interactions * per + d * (d // 2) + (d // 2)


def init_params(cfg: SchNetConfig, gen: torch.Generator):
    lead = (cfg.n_interactions,)
    return {
        "embed": embed_init(gen, cfg.n_species, cfg.d_hidden, torch.float32),
        "interactions": {   # stacked (L, ...) leaves
            "filter": mlp_init(gen, (cfg.n_rbf, cfg.d_hidden, cfg.d_hidden),
                               lead=lead),
            "in": mlp_init(gen, (cfg.d_hidden, cfg.d_hidden), lead=lead),
            "out": mlp_init(gen, (cfg.d_hidden, cfg.d_hidden, cfg.d_hidden),
                            lead=lead),
        },
        "head": mlp_init(gen, (cfg.d_hidden, cfg.d_hidden // 2, 1)),
    }


def species_index(batch: GraphBatch, n_species: int):
    """node_feat[:, 0] truncated toward zero and clipped to the table, as a
    sorted index into the (n_species, d) embedding."""
    z = batch.node_feat[:, 0].to(torch.int32)
    return sorted_index(torch.clamp(z, 0, n_species - 1), n_species)


def _block(blk, h, rbf, env, senders, receivers):
    h = constrain(h, "all", None)
    w = mlp_apply(blk["filter"], rbf, act=shifted_softplus,
                  final_act=True) * env            # (E, d)
    src = gather_nodes(mlp_apply(blk["in"], h), senders)
    msg = constrain(src * w, "all", None)
    agg = scatter_sum(msg, receivers, h.shape[0])
    return constrain(h + mlp_apply(blk["out"], agg, act=shifted_softplus),
                     "all", None)


def forward(cfg: SchNetConfig, params, batch: GraphBatch):
    """Per-graph energies (G,). node_feat[:, 0] carries the species id."""
    plan = plan_of(batch)
    h = gather_nodes(params["embed"], species_index(batch, cfg.n_species))
    rel, dist, valid = edge_vectors(batch)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    env = (cosine_cutoff(dist, cfg.cutoff) * valid)[:, None]
    for i in range(cfg.n_interactions):
        h = checkpoint(_block, layer(params["interactions"], i), h, rbf, env,
                       plan.senders, plan.receivers, use_reentrant=False,
                       preserve_rng_state=False)
    atom_e = mlp_apply(params["head"], h, act=shifted_softplus)[:, 0]  # (N,)
    return graph_sum(atom_e, batch._replace(plan=plan))


def loss_fn(cfg: SchNetConfig, params, batch_and_labels):
    batch, energy = batch_and_labels["graph"], batch_and_labels["energy"]
    pred = forward(cfg, params, batch)
    loss = torch.mean((pred - energy) ** 2)
    return loss, {"mae": torch.mean(torch.abs(pred - energy))}
