"""Shared GNN machinery (counterpart of ``repro.models.gnn.common``): padded
graph batches and message passing on the segment_reduce kernel.

Convention, as in the reference: node arrays have N rows; edge indices lie
in [0, N], where N is the ghost node (padding edges point there and their
messages are dropped).

The reference sums messages with ``jax.ops.segment_sum`` over an unsorted
index.  Here every sum goes to ``segment_sum_sorted`` (the kernel on a
CUDA tensor, its plain version on a CPU tensor), which needs non-decreasing
ids: an :class:`EdgePlan`, built once per batch on the batch's device,
holds a stable argsort of ``receivers`` and one of ``senders``, which every
layer and every backward pass reuse.  The kernel drops ids >= its segment
count, so the ghost row falls away by itself.

:func:`scatter_sum` and :func:`gather_nodes` are autograd functions whose
backward passes are each other: a scatter's gradient is a gather (a plain
index op), and a gather's gradient is a scatter by the same index, on the
kernel through the index's sorted order.  Neither goes through
``index_add_`` or indexing's own backward, which add floats with atomics
on CUDA, so a training step is repeatable bit for bit.  Data of more than
two dimensions is summed as (E, F) rows.

On DTensors (a sharded step: node and edge rows over every mesh axis) the
plan is built rank by rank (:func:`edge_plan`: each rank sorts its own
edges, ``models/gather.py``), a gather replicates the node rows it reads,
and a sum over a rank's edges is reduced onto the nodes' rows, or
replicated for the per-graph sums.  The models ``constrain`` their node
and edge activations at the reference's sites (``dist/constrain.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.gather import (  # noqa: F401 (re-exported)
    SortedIndex, gather_nodes, scatter_mean, scatter_sum, sorted_index)
from repro_torch.models.layers import dense_init


class EdgePlan(NamedTuple):
    """A batch's sorted indices, built once by :func:`edge_plan`."""

    senders: SortedIndex
    receivers: SortedIndex
    graph: SortedIndex | None  # graph_id, where it is non-decreasing


def edge_plan(senders, receivers, graph_id, n_graphs: int,
              check: bool = True) -> EdgePlan:
    """The batch's plan; ``graph`` is None unless ``graph_id`` is
    non-decreasing, which ``check`` False trusts without looking (fake
    tensors hold no values).  On DTensors each rank's rows are sorted on
    their own (a rank's graph ids need only be non-decreasing within it),
    and the per-graph counts are replicated."""
    from repro_torch.dist import regions

    n = graph_id.shape[0]
    try:
        graph = sorted_index(graph_id, n_graphs, presorted=True, check=check)
    except ValueError:
        graph = None
    if graph is not None and regions.is_dtensor(graph.counts):
        graph = graph._replace(counts=regions.to(
            graph.counts, regions.replicated_placements(graph_id)))
    return EdgePlan(sorted_index(senders, n), sorted_index(receivers, n),
                    graph)


class GraphBatch(NamedTuple):
    """Static-shape graph batch.

    senders/receivers: (E,) int32 in [0, N]; N = padding/ghost.
    node_feat: (N, F) float; pos: (N, 3) or zeros; graph_id: (N,) int32 in
    [0, G] mapping nodes to molecules/meshes (G = ghost graph for pad nodes).
    ``plan``: the sorted indices (:func:`plan_of` builds them if None).
    """

    node_feat: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    edge_feat: torch.Tensor | None
    pos: torch.Tensor | None
    graph_id: torch.Tensor
    n_graphs: int
    plan: EdgePlan | None = None


def with_plan(batch: GraphBatch) -> GraphBatch:
    """``batch`` with its edge plan built (on the batch's device)."""
    if batch.plan is not None:
        return batch
    return batch._replace(plan=edge_plan(batch.senders, batch.receivers,
                                         batch.graph_id, batch.n_graphs))


def plan_of(batch: GraphBatch) -> EdgePlan:
    return with_plan(batch).plan


def mlp_init(gen: torch.Generator, dims, dtype=torch.float32,
             lead: tuple = ()):
    """``lead`` prepends axes to every leaf (the stacked layer axis)."""
    return [{"w": dense_init(gen, a, b, dtype, lead),
             "b": torch.zeros((*lead, b), dtype=dtype, device=gen.device)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(params, x, act=F.relu, final_act=False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def layer(tree, i: int):
    """Layer ``i`` of a tree of stacked (L, ...) leaves."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [layer(v, i) for v in tree]
    return tree[i]


def rbf_expand(d, n_rbf: int, cutoff: float):
    """Gaussian radial basis on distances d (E,) -> (E, n_rbf)."""
    centers = torch.linspace(0.0, cutoff, n_rbf, device=d.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (d[:, None] - centers[None, :]) ** 2)


def cosine_cutoff(d, cutoff: float):
    """Smooth envelope that zeroes messages at the cutoff radius."""
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    return 0.5 * (torch.cos(math.pi * x) + 1.0)


def edge_vectors(batch: GraphBatch):
    """(E, 3) displacement, (E,) distance; padding edges give 0/0.  The
    distance is ``norm(rel + 1e-12)``, as the reference takes it."""
    n = batch.node_feat.shape[0]
    rel = _displacements(batch.pos, batch.receivers, batch.senders)
    dist = torch.linalg.vector_norm(rel + 1e-12, dim=-1)
    valid = (batch.senders < n) & (batch.receivers < n)
    return (torch.where(valid[:, None], rel, 0.0),
            torch.where(valid, dist, 0.0), valid)


def _displacements(pos, receivers, senders):
    """pos[receivers] - pos[senders] (E, 3), the ghost index N at the
    origin (no gradient); on DTensors each rank reads its own edges' rows
    of the positions, replicated (the ``rows`` region)."""
    from repro_torch.dist import regions

    def rel(p, r, s):
        p = torch.cat([p, p.new_zeros((1, 3))])
        return p[r.long()] - p[s.long()]

    if not regions.is_dtensor(pos):
        return rel(pos, receivers, senders)
    rep = regions.replicated_placements(pos)
    return regions.run("rows", rel, pos.device_mesh,
                       (regions.to(pos, rep), receivers, senders),
                       (rep, receivers.placements, senders.placements),
                       receivers.placements, None, (receivers.shape[0], 3))


def graph_sum(atom_e, batch: GraphBatch):
    """Per-graph sums (G,) of per-node values (N,), pad nodes (graph_id G)
    dropped; ``graph_id`` must be non-decreasing (on DTensors, within each
    rank's rows).  A sharded sum is replicated on every rank."""
    graph = plan_of(batch).graph
    if graph is None:
        raise ValueError("graph_id must be non-decreasing for the per-graph "
                         "sum on segment_reduce")
    return scatter_sum(atom_e, graph, batch.n_graphs, replicated=True)
