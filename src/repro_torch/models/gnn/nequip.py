"""NequIP-lite (Batzner et al. 2021): E(3)-equivariant interatomic potential
(counterpart of ``repro.models.gnn.nequip``).

l_max=2 irrep features (scalars, vectors, traceless symmetric rank-2
tensors), a radial MLP on a Gaussian basis, a cutoff envelope, a gated
equivariant nonlinearity and a per-atom energy readout; the Clebsch-Gordan
tensor product is replaced, as in the reference, by the closed-form l<=2
covariant products (dot, cross, outer - trace, tensor contraction).

The reference's quirks are kept: radial path 4 feeds both the vector and
the tensor messages; ``mix_v`` and ``mix_t`` use only their first layer's
``w`` (their biases get zero gradients); ``v_norm`` is sqrt(sum + 1e-12).
Three scatter sums per layer; each layer runs under
``torch.utils.checkpoint`` as the reference's under ``jax.checkpoint``, its
features' node rows under ``constrain`` at the reference's sites.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import regions
from repro_torch.dist.constrain import constrain
from repro_torch.models.gnn.common import (
    GraphBatch, cosine_cutoff, edge_vectors, gather_nodes, graph_sum, layer,
    mlp_apply, mlp_init, plan_of, rbf_expand, scatter_sum,
)
from repro_torch.models.gnn.schnet import species_index
from repro_torch.models.layers import embed_init


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _y2(rhat):
    """l=2 spherical tensor: traceless symmetric outer product (E, 3, 3)."""
    outer = rhat[:, :, None] * rhat[:, None, :]
    return outer - _eye3(rhat)[None] / 3.0


def _sym_traceless(t):
    """The traceless symmetric part of (..., 3, 3) ``t``; on DTensors each
    rank's rows on their own (the ``per_row`` region: DTensor gathers a
    sharded tensor whole for ``diagonal``)."""
    if regions.is_dtensor(t):
        return regions.run("per_row", _sym_traceless, t.device_mesh, (t,),
                           (t.placements,), t.placements, None, t.shape)
    sym = 0.5 * (t + t.transpose(-1, -2))
    tr = torch.diagonal(sym, dim1=-2, dim2=-1).sum(-1)
    return sym - tr[..., None, None] * _eye3(t) / 3.0


@dataclass(frozen=True)
class NequipConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32      # channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 20
    dtype: str = "float32"
    n_paths: int = 8        # radial outputs per layer (see _interact)

    def param_count(self) -> int:
        c, r = self.d_hidden, self.n_rbf
        radial = r * 32 + 32 * (self.n_paths * c)
        mix = 6 * c * c
        return (self.n_species * c
                + self.n_layers * (radial + mix)
                + c * 16 + 16)


def init_params(cfg: NequipConfig, gen: torch.Generator):
    c, lead = cfg.d_hidden, (cfg.n_layers,)
    return {
        "embed": embed_init(gen, cfg.n_species, c, torch.float32),
        "layers": {   # stacked (L, ...) leaves
            "radial": mlp_init(gen, (cfg.n_rbf, 32, cfg.n_paths * c),
                               lead=lead),
            "mix_s": mlp_init(gen, (2 * c, c), lead=lead),
            "mix_v": mlp_init(gen, (c, c), lead=lead),  # channel mix of V
            "mix_t": mlp_init(gen, (c, c), lead=lead),  # channel mix of T
            "gate": mlp_init(gen, (c, 2 * c), lead=lead),  # gates of V, T
        },
        "head": mlp_init(gen, (c, 16, 1)),
    }


def _interact(cfg, lp, s, V, T, rbf, env, rhat, senders, receivers):
    """One equivariant message-passing layer.

    s (N, C) scalars; V (N, C, 3) vectors; T (N, C, 3, 3) traceless sym.
    """
    s = constrain(s, "all", None)
    V = constrain(V, "all", None, None)
    T = constrain(T, "all", None, None, None)
    n, c = s.shape
    R = mlp_apply(lp["radial"], rbf, act=F.silu) * env     # (E, P*C)
    R = R.reshape(R.shape[0], cfg.n_paths, c)              # (E, P, C)
    s_j = gather_nodes(s, senders)                         # (E, C)
    V_j = gather_nodes(V, senders)                         # (E, C, 3)
    T_j = gather_nodes(T, senders)                         # (E, C, 3, 3)
    y2 = _y2(rhat)                                         # (E, 3, 3)

    # scalars: l0xl0->l0, l1.Y1->l0, T:Y2->l0
    m_s = (R[:, 0] * s_j
           + R[:, 1] * torch.einsum("eci,ei->ec", V_j, rhat)
           + R[:, 2] * torch.einsum("ecij,eij->ec", T_j, y2))
    # vectors: l0xY1->l1, l1xl0->l1, l1 x Y1 (cross) -> l1, T.Y1->l1
    m_v = (R[:, 3, :, None] * s_j[:, :, None] * rhat[:, None, :]
           + R[:, 4, :, None] * V_j
           + R[:, 5, :, None] * torch.linalg.cross(
               V_j, rhat[:, None, :].expand(V_j.shape), dim=-1)
           + R[:, 6, :, None] * torch.einsum("ecij,ej->eci", T_j, rhat))
    # tensors: l0xY2->l2, sym(V (x) r)->l2
    m_t = (R[:, 7, :, None, None] * s_j[:, :, None, None] * y2[:, None]
           + _sym_traceless(
               R[:, 4, :, None, None]
               * V_j[:, :, :, None] * rhat[:, None, None, :]))

    ds = scatter_sum(m_s, receivers, n)
    dV = scatter_sum(m_v, receivers, n)
    dT = scatter_sum(m_t, receivers, n)

    # node update: invariant pathway + gated equivariant channels
    v_norm = torch.sqrt(torch.sum(dV * dV, dim=-1) + 1e-12)  # (N, C)
    s_new = s + mlp_apply(lp["mix_s"], torch.cat([ds, v_norm], -1),
                          act=F.silu)
    gates = torch.sigmoid(mlp_apply(lp["gate"], s_new))     # (N, 2C)
    gv, gt = gates[:, :c], gates[:, c:]
    V_new = V + gv[:, :, None] * torch.einsum(
        "ncj,cd->ndj", dV, lp["mix_v"][0]["w"])
    T_new = T + gt[:, :, None, None] * torch.einsum(
        "ncij,cd->ndij", dT, lp["mix_t"][0]["w"])
    return s_new, V_new, T_new


def forward(cfg: NequipConfig, params, batch: GraphBatch):
    plan = plan_of(batch)
    n, c = batch.node_feat.shape[0], cfg.d_hidden
    s = gather_nodes(params["embed"], species_index(batch, cfg.n_species))
    V = s.new_zeros((n, c, 3))
    T = s.new_zeros((n, c, 3, 3))
    rel, dist, valid = edge_vectors(batch)
    rhat = rel / torch.clamp(dist, min=1e-9)[:, None]
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    env = (cosine_cutoff(dist, cfg.cutoff) * valid)[:, None]
    for i in range(cfg.n_layers):
        s, V, T = checkpoint(_interact, cfg, layer(params["layers"], i), s, V,
                             T, rbf, env, rhat, plan.senders, plan.receivers,
                             use_reentrant=False, preserve_rng_state=False)
    atom_e = mlp_apply(params["head"], s, act=F.silu)[:, 0]
    return graph_sum(atom_e, batch._replace(plan=plan))


def loss_fn(cfg: NequipConfig, params, batch_and_labels):
    batch, energy = batch_and_labels["graph"], batch_and_labels["energy"]
    pred = forward(cfg, params, batch)
    loss = torch.mean((pred - energy) ** 2)
    return loss, {"mae": torch.mean(torch.abs(pred - energy))}
