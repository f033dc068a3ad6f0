"""Deterministic row gathers and scatter sums on the segment_reduce kernel.

A gather's gradient is a sum of rows by index.  PyTorch's own (indexing's
backward, ``index_add_``, ``embedding``'s backward) adds floats with
atomics on CUDA, in an order that changes from run to run.  Here the index
is sorted once (:func:`sorted_index`, a stable argsort) and every such sum
goes to ``segment_sum_sorted`` in that order: the kernel on a CUDA tensor,
its plain version on a CPU tensor.  So a training step repeats bit for bit.

* :func:`scatter_sum` and :func:`gather_nodes` (the GNNs' message passing,
  ``models/gnn/common.py``) are autograd functions whose backward passes
  are each other; the ghost index n reads a zero row and is dropped by
  every sum.
* :func:`embedding` is a table lookup (the LM's ``embed``, FM's ``table``
  and ``linear``) whose gradient is one kernel sum into the table's rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.segment_reduce import ops as sr


class SortedIndex(NamedTuple):
    """An (E,) index in [0, n] with its stable sorted order."""

    index: torch.Tensor   # (E,) int32, in the data's order
    order: torch.Tensor   # (E,) int32: index[order] is non-decreasing
    ids: torch.Tensor     # (E,) int32: index[order]
    counts: torch.Tensor | None  # (n,) float32: rows with each id < n


def sorted_index(index: torch.Tensor, n: int, presorted: bool = False,
                 counts: bool = True) -> SortedIndex:
    """Sort ``index`` (values in [0, n]; n, the ghost, is dropped by every
    sum) once.  ``presorted`` takes an index that must already be
    non-decreasing, and raises ``ValueError`` if it is not.  ``counts``
    False leaves the rows per id uncounted (None)."""
    index = index.to(torch.int32)
    if presorted:
        if index.numel() > 1 and not bool((index[1:] >= index[:-1]).all()):
            raise ValueError("index must be non-decreasing")
        ids, order = index, torch.arange(index.numel(), dtype=torch.int32,
                                         device=index.device)
    else:
        ids, order = torch.sort(index, stable=True)
        order = order.to(torch.int32)
    if not counts:
        return SortedIndex(index, order, ids, None)
    bounds = torch.searchsorted(
        ids, torch.arange(n + 1, dtype=torch.int32, device=ids.device))
    return SortedIndex(index, order, ids, (bounds[1:] - bounds[:-1]).float())


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


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, index, order, ids):
        ctx.save_for_backward(order, ids)
        ctx.rows = table.shape[0]
        return table.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        order, ids = ctx.saved_tensors
        return _segment_sum(grad, order, ids, ctx.rows), None, None, None


def embedding(table, ids, index: SortedIndex | None = None):
    """table (V, ...) at integer ``ids`` (any shape, values in [0, V)) ->
    (*ids.shape, ...).

    Where the table needs a gradient, the rows are gathered through
    ``index`` (built here from the flat ids when not given; a caller that
    looks up several tables by the same ids builds it once) and the
    gradient is one segment_reduce sum of the output's rows in its sorted
    order.  Otherwise it is plain indexing, as a serving path has it.
    """
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[ids.long()]
    if index is None:
        index = sorted_index(ids.reshape(-1), table.shape[0], counts=False)
    out = _Embedding.apply(table, index.index, index.order, index.ids)
    return out.reshape(*ids.shape, *table.shape[1:])
