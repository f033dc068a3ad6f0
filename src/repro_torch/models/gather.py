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

On DTensors (a sharded step, ``launch/steps.sharded_step``) each runs in a
named region of ``dist/regions.py``.  A table sharded by rows over some
mesh axes is looked up vocab-parallel: each rank gathers the ids that fall
in its rows, zeros elsewhere, and the output is the sum over those axes
(``Partial``); its gradient is the segment_reduce kernel's sum with the
output sharded by row range (each rank's ids shifted by its range's
start), over each rank's own rows in their sorted order.

:func:`sorted_index` of a DTensor sorts each rank's rows of the index on
their own (``sorted_index`` region): the result's arrays are DTensors laid
out as the index, each rank's ``order`` a permutation of its own rows,
and ``counts`` the sum over the ranks, sharded by rows where they divide
evenly.  :func:`gather_nodes` and :func:`scatter_sum` (``rows`` region)
take such an index, or a plain one (the same on every rank): along a mesh
dim where the index's rows are sharded (a GNN batch's edges), the gathered
rows are replicated there (an all-gather of the nodes) and the gather's
output sharded alike, and the sum over a rank's rows is a ``Partial``,
reduced onto rows (a reduce-scatter) where they divide evenly, else
replicated; along any other dim the rows are replicated and the features
keep their layout.  The sums keep one fixed order within a rank.
"""
from __future__ import annotations

import math
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
                 counts: bool = True, check: bool = True) -> SortedIndex:
    """Sort ``index`` (values in [0, n]; n, the ghost, is dropped by every
    sum) once.  ``presorted`` takes an index that must already be
    non-decreasing, and raises ``ValueError`` if it is not (unchecked with
    ``check`` False: fake tensors hold no values to check).  ``counts``
    False leaves the rows per id uncounted (None).  A DTensor is sorted
    rank by rank (:func:`_sharded_sorted_index`)."""
    from repro_torch.dist import regions

    if regions.is_dtensor(index):
        return _sharded_sorted_index(index, n, presorted, counts, check)
    index = index.to(torch.int32)
    if presorted:
        if check and not _non_decreasing(index):
            raise ValueError("index must be non-decreasing")
        ids, order = index, torch.arange(index.numel(), dtype=torch.int32,
                                         device=index.device)
    else:
        ids, order = torch.sort(index, stable=True)
        order = order.to(torch.int32)
    if not counts:
        return SortedIndex(index, order, ids, None)
    return SortedIndex(index, order, ids, _counts(ids, n))


def _non_decreasing(index) -> bool:
    return index.numel() <= 1 or bool((index[1:] >= index[:-1]).all())


def _counts(ids, n: int):
    """(n,) float32: the rows of sorted ``ids`` with each id < n."""
    bounds = torch.searchsorted(
        ids, torch.arange(n + 1, dtype=torch.int32, device=ids.device))
    return (bounds[1:] - bounds[:-1]).float()


def _sharded_sorted_index(index, n: int, presorted: bool, counts: bool,
                          check: bool) -> SortedIndex:
    """:func:`sorted_index` of a DTensor (see the module): its rows sharded
    (``Shard(0)``) or replicated along each mesh dim; any other layout is
    replicated first.  ``presorted`` checks every rank's rows (a
    collective, so every rank raises or none does)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.dist import regions

    mesh = index.device_mesh
    pl = [p if p == Shard(0) else Replicate() for p in index.placements]
    index = regions.to(index, pl).to(torch.int32)
    if presorted and check:
        ok = torch.tensor([int(_non_decreasing(index.to_local()))],
                          dtype=torch.int32, device=index.device)
        if not bool(regions.all_reduce(ok, "min", mesh, range(mesh.ndim))):
            raise ValueError("index must be non-decreasing")
    c_pl = [Partial() if p == Shard(0) else p for p in pl]

    def local(il):
        s = sorted_index(il, n, presorted, counts=False, check=False)
        return (s.order, s.ids) + ((_counts(s.ids, n),) if counts else ())

    out = regions.run("sorted_index", local, mesh, (index,), (pl,),
                      (pl, pl) + ((c_pl,) if counts else ()), None,
                      (index.shape,) * 2 + (((n,),) if counts else ()))
    cnt = (regions.to(out[2], regions.partials_onto_rows(c_pl, mesh, n))
           if counts else None)
    return SortedIndex(index, out[0], out[1], cnt)


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


def _index_layout(index: SortedIndex, mesh) -> tuple:
    """A sorted index's placements (a plain index: the same on every rank,
    replicated), and its (index, order, ids) as region arguments with
    their in_placements (None for plain tensors)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import regions

    ix = (index.index, index.order, index.ids)
    if regions.is_dtensor(index.index):
        i_pl = tuple(index.index.placements)
        return i_pl, ix, (i_pl,) * 3
    return (Replicate(),) * mesh.ndim, ix, (None,) * 3


def _rows_gathered(p):
    """A placement with a shard of rows (dim 0) replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return Replicate() if p == Shard(0) else p


def _sharded_gather(x, index: SortedIndex):
    """:func:`gather_nodes` on DTensor ``x`` (the ``rows`` region; see the
    module): x replicated where the index's rows are sharded, its gradient
    there a ``Partial`` sum of a rank's rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.dist import regions

    mesh = x.device_mesh
    i_pl, ix, ix_pl = _index_layout(index, mesh)
    x_pl, o_pl, g_pl = [], [], []
    for p, ip in zip(x.placements, i_pl):
        if ip == Shard(0):
            x_pl.append(Replicate()), o_pl.append(ip), g_pl.append(Partial())
        else:
            q = _rows_gathered(p)
            x_pl.append(q), o_pl.append(q), g_pl.append(q)
    x = regions.to(x, x_pl)
    return regions.run(
        "rows", _GatherNodes.apply, mesh, (x,) + ix, (x_pl,) + ix_pl, o_pl,
        (g_pl, None, None, None), (index.index.shape[0], *x.shape[1:]))


def _sharded_scatter(values, index: SortedIndex, n: int, replicated: bool):
    """:func:`scatter_sum` of DTensor ``values`` (the ``rows`` region; see
    the module): values' rows sharded as the index's, each rank's sum a
    ``Partial``, reduced onto rows where they divide evenly (or
    replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.dist import regions

    mesh = values.device_mesh
    i_pl, ix, ix_pl = _index_layout(index, mesh)
    v_pl, o_pl = [], []
    for p, ip in zip(values.placements, i_pl):
        if ip == Shard(0):
            v_pl.append(ip), o_pl.append(Partial())
        else:
            q = _rows_gathered(p)
            v_pl.append(q), o_pl.append(q)
    values = regions.to(values, v_pl)
    out = regions.run(
        "rows", lambda vl, *a: _ScatterSum.apply(vl, *a, n), mesh,
        (values,) + ix, (v_pl,) + ix_pl, o_pl, (v_pl, None, None, None),
        (n, *values.shape[1:]))
    return regions.to(out, [Replicate() if isinstance(p, Partial) else p
                            for p in o_pl] if replicated else
                      regions.partials_onto_rows(o_pl, mesh, n))


def scatter_sum(values, index: SortedIndex, n: int,
                replicated: bool = False):
    """values (E, ...), index in [0, n] -> (n, ...) (ghost dropped).  On
    DTensors, ``replicated`` asks for the sum on every rank (a per-graph
    sum), where it would be sharded by rows like the nodes."""
    from repro_torch.dist import regions

    if regions.is_dtensor(values):
        return _sharded_scatter(values, index, n, replicated)
    return _ScatterSum.apply(values, index.index, index.order, index.ids, n)


def scatter_mean(values, index: SortedIndex, n: int):
    s = scatter_sum(values, index, n)
    cnt = index.counts if index.counts.shape[0] == n else index.counts[:n]
    return s / torch.clamp(cnt, min=1.0)[:, None]


def gather_nodes(x, index: SortedIndex):
    """x (N, ...) gathered at (E,) indices in [0, N] (ghost row = zeros)."""
    from repro_torch.dist import regions

    if regions.is_dtensor(x):
        return _sharded_gather(x, index)
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
    from repro_torch.dist import regions

    if regions.is_dtensor(table):
        return _sharded_embedding(table, ids)
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[ids.long()]
    if index is None:
        index = sorted_index(ids.reshape(-1), table.shape[0], counts=False)
    out = _Embedding.apply(table, index.index, index.order, index.ids)
    return out.reshape(*ids.shape, *table.shape[1:])


def _embedding_layouts(table, ids):
    """(table, ids, output) placements of a sharded lookup, along each mesh
    dim: the table's rows sharded where they are (vocab-parallel: the ids
    replicated there, the output a ``Partial`` sum), its features gathered
    (FSDP); elsewhere the ids' batch rows shard the output alike."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.dist import regions

    mesh = table.device_mesh
    i_have = ids.placements if regions.is_dtensor(ids) else \
        [Replicate()] * mesh.ndim
    # rows that the ids' axes do not divide are gathered (see constrain)
    shards = math.prod(mesh.size(d) for d, p in enumerate(i_have)
                       if p == Shard(0))
    even = ids.shape[0] % shards == 0
    t_pl, i_pl, o_pl = [], [], []
    for tp, ip in zip(table.placements, i_have):
        if isinstance(tp, Shard) and tp.dim == 0:
            t_pl.append(tp), i_pl.append(Replicate()), o_pl.append(Partial())
        elif even and ip == Shard(0):
            t_pl.append(Replicate()), i_pl.append(ip), o_pl.append(ip)
        else:
            t_pl.append(Replicate()), i_pl.append(Replicate())
            o_pl.append(Replicate())
    return t_pl, i_pl, o_pl


class _ShardedEmbedding(torch.autograd.Function):
    """The vocab-parallel lookup (``embedding`` region) and its gradient,
    one segment_reduce sum sharded by row range (``segment_reduce``
    region) over each rank's rows sorted by id (``sorted_index`` and
    ``rows`` regions)."""

    @staticmethod
    def forward(ctx, table, ids, t_pl, i_pl, o_pl):
        from repro_torch.dist import regions

        mesh, v = table.device_mesh, table.shape[0]
        ctx.save_for_backward(ids)
        ctx.layouts = (t_pl, i_pl, o_pl)
        ctx.vocab = v

        def lookup(tl, il):
            v0, v1 = regions.shard_range(mesh, t_pl, 0, v)
            flat = il.reshape(-1).long() - v0
            hit = (flat >= 0) & (flat < v1 - v0)
            rows = _gather(tl, torch.where(hit, flat, v1 - v0))
            return rows.reshape(*il.shape, *tl.shape[1:])

        return regions.run("embedding", lookup, mesh, (table, ids),
                           (t_pl, i_pl), o_pl, None,
                           (*ids.shape, *table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Partial, Replicate

        from repro_torch.dist import regions

        (ids,) = ctx.saved_tensors
        t_pl, i_pl, o_pl = ctx.layouts
        mesh = ids.device_mesh
        g_pl = [Replicate() if isinstance(p, Partial) else p for p in o_pl]
        grad = regions.to(grad, g_pl)
        width = grad.shape[ids.ndim:]
        flat_ids = ids.reshape(-1)
        rows = grad.reshape(flat_ids.shape[0], -1)

        def sort(il):
            sid, order = torch.sort(il, stable=True)
            return order.to(torch.int32), sid

        order, sid = regions.run("sorted_index", sort, mesh, (flat_ids,),
                                 (i_pl,), (i_pl, i_pl), None,
                                 (flat_ids.shape, flat_ids.shape))
        rows = regions.run("rows", lambda rl, ol: rl.index_select(0, ol),
                           mesh, (rows, order), (g_pl, i_pl), g_pl, None,
                           rows.shape)
        out = sr.segment_sum_sorted(rows, sid, ctx.vocab, out_placements=t_pl)
        return out.reshape(ctx.vocab, *width), None, None, None, None


def _sharded_embedding(table, ids):
    """:func:`embedding` on a DTensor table (see the module)."""
    from repro_torch.dist import regions

    t_pl, i_pl, o_pl = _embedding_layouts(table, ids)
    table = regions.to(table, t_pl)
    ids = regions.to(ids, i_pl) if regions.is_dtensor(ids) else \
        regions.replicated(ids, table.device_mesh, i_pl)
    return _ShardedEmbedding.apply(table, ids.to(torch.int32), t_pl, i_pl,
                                   o_pl)
