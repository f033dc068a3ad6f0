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
two dimensions is summed as (E, F) rows.  ``repro.dist.constrain`` is a
no-op on one card and has no counterpart here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.segment_reduce import ops as sr
from repro_torch.models.layers import dense_init


class SortedIndex(NamedTuple):
    """An (E,) index in [0, n] with its stable sorted order."""

    index: torch.Tensor   # (E,) int32, in the data's order
    order: torch.Tensor   # (E,) int32: index[order] is non-decreasing
    ids: torch.Tensor     # (E,) int32: index[order]
    counts: torch.Tensor  # (n,) float32: rows with each id < n


def sorted_index(index: torch.Tensor, n: int,
                 presorted: bool = False) -> SortedIndex:
    """Sort ``index`` (values in [0, n]; n, the ghost, is dropped by every
    sum) once.  ``presorted`` takes an index that must already be
    non-decreasing, and raises ``ValueError`` if it is not."""
    index = index.to(torch.int32)
    if presorted:
        if index.numel() > 1 and not bool((index[1:] >= index[:-1]).all()):
            raise ValueError("index must be non-decreasing")
        ids, order = index, torch.arange(index.numel(), dtype=torch.int32,
                                         device=index.device)
    else:
        ids, order = torch.sort(index, stable=True)
        order = order.to(torch.int32)
    bounds = torch.searchsorted(
        ids, torch.arange(n + 1, dtype=torch.int32, device=ids.device))
    return SortedIndex(index, order, ids, (bounds[1:] - bounds[:-1]).float())


class EdgePlan(NamedTuple):
    """A batch's sorted indices, built once by :func:`edge_plan`."""

    senders: SortedIndex
    receivers: SortedIndex
    graph: SortedIndex | None  # graph_id, where it is non-decreasing


def edge_plan(senders, receivers, graph_id, n_graphs: int) -> EdgePlan:
    n = graph_id.shape[0]
    try:
        graph = sorted_index(graph_id, n_graphs, presorted=True)
    except ValueError:
        graph = None
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


def _gather(x, index):
    """x (N, ...) at (E,) indices in [0, N]; the ghost index N reads a zero
    row."""
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xz.index_select(0, index)


def _segment_sum(values, order, ids, n: int):
    """values (E, ...) summed by ``ids`` after the sort ``order``: (n, ...),
    rows with id >= n dropped."""
    rows = values.reshape(values.shape[0], -1).index_select(0, order)
    out = sr.segment_sum_sorted(rows, ids, n)
    return out.reshape((n,) + tuple(values.shape[1:]))


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, index, order, ids, n):
        ctx.save_for_backward(index)
        return _segment_sum(values, order, ids, n)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return _gather(grad, index), None, None, None, None


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, order, ids):
        ctx.save_for_backward(order, ids)
        ctx.n = x.shape[0]
        return _gather(x, index)

    @staticmethod
    def backward(ctx, grad):
        order, ids = ctx.saved_tensors
        return _segment_sum(grad, order, ids, ctx.n), None, None, None


def scatter_sum(values, index: SortedIndex, n: int):
    """values (E, ...), index in [0, n] -> (n, ...) (ghost dropped)."""
    return _ScatterSum.apply(values, index.index, index.order, index.ids, n)


def scatter_mean(values, index: SortedIndex, n: int):
    s = scatter_sum(values, index, n)
    cnt = index.counts[:n]
    return s / torch.clamp(cnt, min=1.0)[:, None]


def gather_nodes(x, index: SortedIndex):
    """x (N, ...) gathered at (E,) indices in [0, N] (ghost row = zeros)."""
    return _GatherNodes.apply(x, index.index, index.order, index.ids)


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
    pos = torch.cat([batch.pos, batch.pos.new_zeros((1, 3))])
    rel = pos[batch.receivers.long()] - pos[batch.senders.long()]
    dist = torch.linalg.vector_norm(rel + 1e-12, dim=-1)
    valid = (batch.senders < n) & (batch.receivers < n)
    return (torch.where(valid[:, None], rel, 0.0),
            torch.where(valid, dist, 0.0), valid)


def graph_sum(atom_e, batch: GraphBatch):
    """Per-graph sums (G,) of per-node values (N,), pad nodes (graph_id G)
    dropped; ``graph_id`` must be non-decreasing."""
    graph = plan_of(batch).graph
    if graph is None:
        raise ValueError("graph_id must be non-decreasing for the per-graph "
                         "sum on segment_reduce")
    return scatter_sum(atom_e, graph, batch.n_graphs)
