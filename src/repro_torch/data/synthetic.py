"""Synthetic data of the ported models (counterpart of
``repro.data.synthetic``): LM tokens, molecules and meshes, labelled
community graphs with the GraphSAGE neighbor sampler, and recsys batches.

The same numpy draws as the reference, so the same seed gives the same
numbers; each batch is returned as int32/float32 tensors on ``device``
(graph batches with their edge plan built there).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.gnn.common import GraphBatch, with_plan


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               device="cpu"):
    """Infinite stream of (tokens, labels) — Zipf-ish synthetic LM data."""
    rng = np.random.default_rng(seed)
    while True:
        probs = 1.0 / np.arange(1, vocab + 1)
        probs /= probs.sum()
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        yield {
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device),
        }


# ---------------------------------------------------------------------------
# molecules / meshes (SchNet, NequIP, MeshGraphNet)
# ---------------------------------------------------------------------------

def _radius_edges(pos, cutoff, max_edges):
    n = pos.shape[0]
    d2 = np.sum((pos[:, None] - pos[None, :]) ** 2, -1)
    src, dst = np.nonzero((d2 < cutoff**2) & ~np.eye(n, dtype=bool))
    if src.shape[0] > max_edges:  # the first pairs in row order, as the reference
        src, dst = src[:max_edges], dst[:max_edges]
    return src, dst


def molecule_batch(n_graphs: int, atoms: int = 30, n_species: int = 10,
                   cutoff: float = 3.0, edges_per_graph: int = 512,
                   seed: int = 0, energy_rule: str = "pairs", device="cpu"):
    """Batched small molecules. Energy label = #close pairs (learnable)."""
    rng = np.random.default_rng(seed)
    N = n_graphs * atoms
    E = n_graphs * edges_per_graph
    feats = np.zeros((N, 1), np.float32)
    pos = np.zeros((N, 3), np.float32)
    gid = np.repeat(np.arange(n_graphs), atoms).astype(np.int32)
    senders = np.full(E, N, np.int32)
    receivers = np.full(E, N, np.int32)
    energy = np.zeros(n_graphs, np.float32)
    e_at = 0
    for g in range(n_graphs):
        p = rng.random((atoms, 3)).astype(np.float32) * 3.0
        z = rng.integers(1, n_species, atoms)
        s, d = _radius_edges(p, cutoff, edges_per_graph)
        base = g * atoms
        m = min(s.shape[0], edges_per_graph)
        senders[e_at:e_at + m] = base + s[:m]
        receivers[e_at:e_at + m] = base + d[:m]
        e_at += edges_per_graph
        feats[base:base + atoms, 0] = z
        pos[base:base + atoms] = p
        energy[g] = 0.05 * m + 0.1 * z.sum()
    batch = GraphBatch(
        node_feat=_t(feats, device),
        senders=_t(senders, device),
        receivers=_t(receivers, device),
        edge_feat=None,
        pos=_t(pos, device),
        graph_id=_t(gid, device),
        n_graphs=n_graphs,
    )
    return {"graph": with_plan(batch), "energy": _t(energy, device)}


def mesh_batch(nx: int = 16, ny: int = 16, seed: int = 0, device="cpu"):
    """A 2D triangulated grid mesh with a synthetic smooth target field."""
    rng = np.random.default_rng(seed)
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    e.append(np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1))
    edges = np.concatenate(e)
    edges = np.concatenate([edges, edges[:, ::-1]])  # both directions
    pos3 = np.zeros((n, 3), np.float32)
    pos3[:, 0] = (np.arange(n) // ny) / nx
    pos3[:, 1] = (np.arange(n) % ny) / ny
    feats = rng.standard_normal((n, 4)).astype(np.float32)
    target = np.stack(
        [np.sin(3 * pos3[:, 0]) * np.cos(2 * pos3[:, 1]),
         np.cos(4 * pos3[:, 0] * pos3[:, 1])], -1
    ).astype(np.float32)
    batch = GraphBatch(
        node_feat=_t(feats, device),
        senders=_t(edges[:, 0].astype(np.int32), device),
        receivers=_t(edges[:, 1].astype(np.int32), device),
        edge_feat=None,
        pos=_t(pos3, device),
        graph_id=torch.zeros((n,), dtype=torch.int32, device=device),
        n_graphs=1,
    )
    return {"graph": with_plan(batch), "target": _t(target, device)}


# ---------------------------------------------------------------------------
# node classification + neighbor sampler (GraphSAGE)
# ---------------------------------------------------------------------------

def community_graph(n: int = 1000, n_classes: int = 8, d_feat: int = 64,
                    p_in: float = 0.02, p_out: float = 0.001, seed: int = 0):
    """SBM-style labeled graph (host arrays) for node classification: the
    reference's dense (n, n) draw, so O(n^2) memory; ``data/graphs.py``'s
    ``planted_partition`` draws a large one in O(m)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    blocks = labels[:, None] == labels[None, :]
    probs = np.where(blocks, p_in, p_out)
    adj = rng.random((n, n)) < probs
    adj = np.triu(adj, 1)
    src, dst = np.nonzero(adj)
    edges = np.concatenate(
        [np.stack([src, dst], 1), np.stack([dst, src], 1)])
    feats = (np.eye(n_classes)[labels] @ rng.standard_normal(
        (n_classes, d_feat)) + 0.5 * rng.standard_normal((n, d_feat))
             ).astype(np.float32)
    return edges.astype(np.int64), feats, labels.astype(np.int32)


class NeighborSampler:
    """GraphSAGE fanout sampler: k-hop sampled subgraph batches (numpy)."""

    def __init__(self, edges: np.ndarray, n: int, fanouts=(15, 10), seed=0):
        self.n = n
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        order = np.argsort(edges[:, 1], kind="stable")  # CSC by dst
        self.sorted_src = edges[order, 0]
        self.offsets = np.zeros(n + 1, np.int64)
        np.add.at(self.offsets, edges[:, 1] + 1, 1)
        self.offsets = np.cumsum(self.offsets)

    def _sample_neighbors(self, nodes, fanout):
        src_list, dst_list = [], []
        for v in nodes:
            lo, hi = self.offsets[v], self.offsets[v + 1]
            if hi == lo:
                continue
            take = min(fanout, hi - lo)
            sel = self.rng.choice(hi - lo, take, replace=False) + lo
            src_list.append(self.sorted_src[sel])
            dst_list.append(np.full(take, v))
        if not src_list:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(src_list), np.concatenate(dst_list)

    def sample(self, seeds: np.ndarray, feats: np.ndarray,
               labels: np.ndarray, pad_nodes: int, pad_edges: int,
               device="cpu"):
        """Returns a padded GraphBatch over the union of sampled nodes with
        labels only on the seed nodes (-1 elsewhere)."""
        nodes = list(seeds)
        node_set = set(seeds.tolist())
        all_src, all_dst = [], []
        frontier = seeds
        for fanout in self.fanouts:
            s, d = self._sample_neighbors(frontier, fanout)
            all_src.append(s)
            all_dst.append(d)
            new = [v for v in np.unique(s) if v not in node_set]
            node_set.update(new)
            nodes.extend(new)
            frontier = np.asarray(new, dtype=np.int64)
            if frontier.size == 0:
                break
        nodes = np.asarray(nodes[:pad_nodes], dtype=np.int64)
        remap = {int(v): i for i, v in enumerate(nodes)}
        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
        keep = [i for i in range(src.shape[0])
                if int(src[i]) in remap and int(dst[i]) in remap]
        keep = keep[:pad_edges]
        e_src = np.full(pad_edges, pad_nodes, np.int32)
        e_dst = np.full(pad_edges, pad_nodes, np.int32)
        for j, i in enumerate(keep):
            e_src[j] = remap[int(src[i])]
            e_dst[j] = remap[int(dst[i])]
        nf = np.zeros((pad_nodes, feats.shape[1]), np.float32)
        nf[: nodes.shape[0]] = feats[nodes]
        lab = np.full(pad_nodes, -1, np.int32)
        seed_local = [remap[int(v)] for v in seeds if int(v) in remap]
        lab[seed_local] = labels[seeds[: len(seed_local)]]
        batch = GraphBatch(
            node_feat=_t(nf, device),
            senders=_t(e_src, device),
            receivers=_t(e_dst, device),
            edge_feat=None,
            pos=torch.zeros((pad_nodes, 3), dtype=torch.float32,
                            device=device),
            graph_id=torch.zeros((pad_nodes,), dtype=torch.int32,
                                 device=device),
            n_graphs=1,
        )
        return {"graph": with_plan(batch), "labels": _t(lab, device)}


# ---------------------------------------------------------------------------
# recsys
# ---------------------------------------------------------------------------

def recsys_batches(n_fields: int, rows_per_field: int, batch: int,
                   seed: int = 0, device="cpu"):
    """Clickthrough-style batches with a planted preference rule."""
    rng = np.random.default_rng(seed)
    w_secret = rng.standard_normal(n_fields)
    while True:
        ids = rng.integers(0, rows_per_field, (batch, n_fields))
        signal = ((ids % 7) / 3.0 - 1.0) @ w_secret
        labels = (signal + 0.5 * rng.standard_normal(batch) > 0).astype(
            np.float32)
        yield {
            "ids": torch.from_numpy(ids.astype(np.int32)).to(device),
            "labels": torch.from_numpy(labels).to(device),
        }
