"""Named ``local_map`` regions: the places where a sharded step leaves
DTensor's sharding propagation and runs plain PyTorch on each rank's
shards, with its collectives written out.

DTensor has no strategy for some ops the models use (argsort, scatter,
``logsumexp`` and ``gather`` over a vocab-sharded logits block, an in-place
write into a sharded axis), and a hand-written kernel's custom op sees
only a rank's local shards, so each such place is a region:
:func:`run` converts its DTensor arguments to their local shards (laid out
as ``in_placements`` says), calls ``fn`` on them and wraps its tensor
results as DTensors with ``out_placements`` and their global shapes (the
role of ``local_map``, which takes every shard to be equal: a batch of 2
rows over 16 ranks, or 4 heads over 16, is not).  A region is differentiable:
``in_grad_placements`` says how the gradient of each argument is laid out
across ranks (``Partial()`` where each rank holds only its share of a sum).
No region replicates a tensor silently: every gather or reduction it needs
is a collective of ``torch.distributed._functional_collectives`` on a mesh
axis's group (:func:`all_reduce`), which ``CommDebugMode`` counts.

``region_calls`` counts the regions a process has entered, by name
(``REGIONS`` lists them all, with what each computes).
"""
from __future__ import annotations

from collections import Counter

import torch

# name -> what the region computes (PERF.md lists them)
REGIONS = {
    "flash_attention": "the flash kernel (forward and backward) on each "
                       "rank's batch rows and query heads; GQA kv heads "
                       "sliced or repeated per shard",
    "fm_interaction": "the fm_interaction kernel (forward and backward) on "
                      "each rank's batch rows or D columns (a Partial "
                      "score over D)",
    "segment_reduce": "the segment_reduce kernel on each rank's rows (a "
                      "Partial sum) or segment range (ids shifted)",
    "embedding": "vocab-parallel lookup: each rank's rows, masked; the "
                 "sum over the vocab axes is a Partial",
    "sorted_index": "the stable argsort of each rank's ids (one fixed "
                    "order within a rank)",
    "per_row": "a row-wise function that DTensor would gather whole (a "
               "diagonal), on each rank's own rows",
    "rows": "a gather or sum of rows by a rank's own index",
    "vocab_parallel_ce": "cross entropy over a vocab-sharded logits block: "
                         "max and sum of exp all-reduced over the vocab "
                         "axes, the gold logit summed there",
    "moe_dispatch": "the router's top-k, the slot tables (argsort, "
                    "scatter max/min) on every rank's replicated tokens",
    "moe_experts": "the token rows of a rank's own experts' slots, "
                   "gathered by its own sorted index",
    "moe_combine": "a rank's experts' weighted outputs summed into the "
                   "tokens by its own sorted index; the sum over the "
                   "experts' ranks a Partial",
    "microbatch": "a microbatch's slice of each rank's batch rows",
    "cache_write": "the new token's k, v written by the rank that holds "
                   "its position in a sequence-sharded cache",
}

region_calls: Counter = Counter()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def run(name: str, fn, mesh, args: tuple, in_placements, out_placements,
        in_grad_placements=None, out_shapes=None):
    """``fn`` on the local shards of ``args`` (each a DTensor laid out as
    its entry of ``in_placements``, or anything else with entry None,
    passed as it is); its results wrapped by ``out_placements`` (one
    entry a result; a tuple of entries for several), of global shapes
    ``out_shapes`` (one shape, or one a result; needed where a result is
    sharded unevenly, else the local shape times the shards).  The
    gradient of an argument is laid out by its ``in_grad_placements``
    entry (default its ``in_placements`` one)."""
    from torch.distributed.tensor import DTensor, Placement

    if name not in REGIONS:
        raise KeyError(f"unknown region {name}")
    region_calls[name] += 1
    single = all(isinstance(p, Placement) for p in out_placements)
    grads = in_grad_placements or (None,) * len(args)
    local_args = []
    for a, pl, g in zip(args, in_placements, grads):
        if is_dtensor(a):
            if tuple(a.placements) != tuple(pl):
                raise ValueError(f"region {name}: an argument is laid out "
                                 f"{a.placements}, not {tuple(pl)}")
            a = a.to_local(grad_placements=tuple(pl if g is None else g))
        local_args.append(a)
    out = fn(*local_args)
    outs, pls = ((out,), (out_placements,)) if single else (out,
                                                           out_placements)
    shapes = ((out_shapes,) if single else out_shapes) or (None,) * len(outs)
    wrapped = []
    for o, pl, shape in zip(outs, pls, shapes):
        if pl is None or not isinstance(o, torch.Tensor):
            wrapped.append(o)
            continue
        stride = None if shape is None else _contiguous(shape)
        shape = None if shape is None else torch.Size(shape)
        wrapped.append(DTensor.from_local(o, mesh, tuple(pl),
                                          run_check=False, shape=shape,
                                          stride=stride))
    return wrapped[0] if single else tuple(wrapped)


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(out))


def to(x, placements):
    """DTensor ``x`` redistributed to ``placements`` (unchanged if it has
    them)."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def local(x):
    """A DTensor's local shard; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def replicated(x, mesh, placements=None):
    """A plain tensor (the same on every rank) as a DTensor on ``mesh``
    laid out as ``placements`` (default replicated), with no
    communication."""
    from torch.distributed.tensor import DTensor, Replicate

    out = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return out if placements is None else to(out, placements)


def partials_onto_rows(placements, mesh, n: int) -> list:
    """``placements`` with each ``Partial`` reduced: onto rows
    (``Shard(0)``) where the shards of dim 0 so far, in mesh order, divide
    its ``n`` rows evenly, else replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out, rows = [], 1
    for d, p in enumerate(placements):
        if isinstance(p, Partial):
            p = Shard(0) if n % (rows * mesh.size(d)) == 0 else Replicate()
        if p == Shard(0):
            rows *= mesh.size(d)
        out.append(p)
    return out


def replicated_placements(t) -> tuple:
    """``Replicate()`` on every dim of DTensor ``t``'s mesh."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * t.device_mesh.ndim


def divisible(t, dims, size: int) -> list:
    """DTensor ``t``'s placements with ``Replicate`` where a mesh axis
    shards one of ``dims`` but the axes that shard the outer one,
    ``dims[0]``, do not divide ``size`` (a split or merge of those dims
    keeps only an even sharding of the outer one: Gemma's 4 heads over
    16 devices, a smoke batch of 2 over 16)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, out, shards = t.device_mesh, [], 1
    for d, p in enumerate(t.placements):
        keep = not (isinstance(p, Shard) and p.dim in dims)
        if not keep and p.dim == dims[0] and size % (shards *
                                                     mesh.size(d)) == 0:
            shards *= mesh.size(d)
            keep = True
        out.append(p if keep else Replicate())
    return out


def coordinate(mesh, dim: int) -> int:
    """This rank's index along mesh dim ``dim``."""
    return mesh.get_local_rank(dim)


def chunk_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of chunk ``index`` of ``n`` split in ``parts`` as
    DTensor's ``Shard`` splits it (``torch.chunk``: chunks of ceil(n /
    parts), the last ones short or empty)."""
    size = -(-n // parts) if parts else n
    start = min(index * size, n)
    return start, min(start + size, n)


def shard_range(mesh, placements, tensor_dim: int, n: int) -> tuple[int,
                                                                    int]:
    """[start, stop) of this rank's block of a dim of length ``n`` sharded
    as ``placements`` say (over each mesh dim that shards ``tensor_dim``,
    in mesh order)."""
    from torch.distributed.tensor import Shard

    start, stop = 0, n
    for d, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == tensor_dim:
            a, b = chunk_range(stop - start, mesh.size(d),
                               coordinate(mesh, d))
            start, stop = start + a, start + b
    return start, stop


def all_reduce(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``x`` (a local tensor inside a region) reduced with ``op`` ("sum",
    "max") over the mesh dims ``dims``."""
    import torch.distributed._functional_collectives as funcol

    for d in dims:
        if mesh.size(d) > 1:
            x = funcol.all_reduce(x, op, (mesh, d))
    return x
