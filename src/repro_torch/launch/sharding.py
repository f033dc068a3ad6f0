"""Per-family sharding rules by parameter path (counterpart of
``repro.launch.sharding``).

LM: 2D FSDP+TP — d_model sharded over 'data', heads/ffn/vocab/experts over
'model'; 'pod' (when present) is pure DP (params replicated across pods,
gradients all-reduced over DCN).  KV caches shard batch over data and
sequence over model (FlashDecoding-style split-K when batch is small).

GNN (baseline mode): params replicated; node/edge arrays sharded over all
mesh axes.  RecSys: embedding table sharded over (data, model) rows.

A rule returns a tree of specs of the same structure as the tree it is
given.  A spec is the content of the reference's ``PartitionSpec``, one
entry per tensor dimension: ``None`` (replicated), a mesh axis name, or a
tuple of names (sharded over their product, in that order).  A leaf's path
is its key path from ``repro_torch.tree`` written as the reference's
``_path_str`` writes it (``layers/wq``).  :func:`placements` turns a spec
into ``torch.distributed.tensor`` placements over a ``DeviceMesh``, and
:func:`shard_shape` gives the shape that each device holds.  The meshes are
``DeviceMesh``es (``launch/mesh.py``); a rule reads only their axis names
and sizes.  :func:`distribute` lays a tree of full tensors out as DTensors
by a spec tree, and :func:`full` gathers one back.
"""
from __future__ import annotations

import math
import re

from repro_torch import tree
from repro_torch.launch.mesh import dp_axes, dp_size


def _path_str(path) -> str:
    """``tree.flatten_with_path``'s key path as the reference's
    ``_path_str``: the keys and indices joined by '/'."""
    return "/".join(re.fullmatch(r"\['?(.*?)'?\]", key).group(1)
                    for key in path)


def _map_with_path(rule, tree_):
    """``rule(path string, leaf)`` over the leaves of ``tree_``."""
    return tree.unflatten(tree_, [rule(_path_str(p), leaf) for p, leaf in
                                  tree.flatten_with_path(tree_)])


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def _spec(nd: int, *entries) -> tuple:
    """A spec of ``nd`` entries: ``entries`` then ``None``s."""
    if len(entries) > nd:
        raise ValueError(f"spec {entries} has more entries than the "
                         f"tensor's {nd} dims")
    return tuple(entries) + (None,) * (nd - len(entries))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def mesh_sizes(mesh) -> dict:
    """Axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, spec) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on ``mesh``:
    ``Shard(d)`` on each mesh axis that spec entry d names, ``Replicate()``
    on the others.  A tensor dim sharded over several axes shards on each,
    and DTensor splits them in the mesh's order, so their order in the spec
    must be the mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree_, specs, mesh):
    """``tree_`` (full tensors, the same values on every rank: each rank
    builds them from the same seed) as DTensors laid out by ``specs`` (a
    rule's result for it, or one spec for a single tensor; a None subtree
    of specs replicates): each rank keeps its own block, with no
    communication, in memory of its own (not a view that would keep the
    full tensor alive).  Leaves that are not tensors (a cache's length) stay as
    they are."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from torch.distributed.tensor import DTensor

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        d = distribute_tensor(leaf, mesh, placements(
            mesh, _spec(leaf.ndim) if spec is None else
            _spec(leaf.ndim, *spec)), src_data_rank=None)
        local = d.to_local()
        if local.untyped_storage().nbytes() > local.numel() * \
                local.element_size():   # a view of the full tensor: own it
            d = DTensor.from_local(local.clone(), mesh, d.placements,
                                   run_check=False, shape=d.shape,
                                   stride=d.stride())
        return d

    if not isinstance(tree_, (dict, list, tuple)):
        return one(tree_, specs)
    return tree.unflatten(tree_, [one(leaf, spec) for _, leaf, spec in
                                  flatten_specs(tree_, specs)])


def full(tree_):
    """``tree_`` with every DTensor gathered to its full tensor (a
    collective: every rank calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    def one(leaf):
        return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf

    if not isinstance(tree_, (dict, list, tuple)):
        return one(tree_)
    return tree.tree_map(one, tree_)


def shard_shape(mesh, spec, shape) -> tuple:
    """The shape of one device's block of a ``shape`` tensor under
    ``spec`` (a dim not divisible by its axes' product rounds up, as the
    first blocks of a DTensor do)."""
    sizes = mesh_sizes(mesh)
    return tuple(-(-n // math.prod(sizes[a] for a in _axes(entry)))
                 for n, entry in zip(shape, _spec(len(shape), *spec)))


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def lm_param_sharding(mesh, params_shape):
    dp = "data"

    def rule(name, leaf):
        nd = _ndim(leaf)
        if name.endswith("embed"):
            return _spec(nd, "model", dp)
        if "moe/router" in name:
            return _spec(nd, None, dp, None)
        if "moe/shared/w_down" in name:
            return _spec(nd, None, "model", dp)
        if "moe/shared" in name:
            return _spec(nd, None, dp, "model")
        if "moe/w_down" in name:                      # (L, E, f, d)
            return _spec(nd, None, "model", None, dp)
        if "moe/" in name:                            # (L, E, d, f)
            return _spec(nd, None, "model", dp, None)
        if name.endswith(("wq", "wk", "wv")):
            return _spec(nd, None, dp, "model")
        if name.endswith("w_dkv"):                    # (L, d, r) — r replicated
            return _spec(nd, None, dp, None)
        if name.endswith("w_ukv"):                    # (L, r, H*(nope+dv))
            return _spec(nd, None, None, "model")
        if name.endswith(("wo", "w_down")):           # (L, in, d)
            return _spec(nd, None, "model", dp)
        if name.endswith(("w_gate", "w_up")):         # (L, d, ff)
            return _spec(nd, None, dp, "model")
        return _spec(nd)                              # norms, scalars

    return _map_with_path(rule, params_shape)


def lm_param_sharding_zero1(mesh, params_shape):
    """ZeRO-1: params replicated over 'data' (sharded over 'model' only);
    optimizer state keeps the full 2D FSDP sharding."""
    def rule(name, leaf):
        nd = _ndim(leaf)
        if name.endswith("embed"):
            return _spec(nd, "model", None)
        if "moe/router" in name:
            return _spec(nd, None, None, None)
        if "moe/shared/w_down" in name:
            return _spec(nd, None, "model", None)
        if "moe/shared" in name:
            return _spec(nd, None, None, "model")
        if "moe/w_down" in name:
            return _spec(nd, None, "model", None, None)
        if "moe/" in name:
            return _spec(nd, None, "model", None, None)
        if name.endswith(("wq", "wk", "wv", "w_gate", "w_up")):
            return _spec(nd, None, None, "model")
        if name.endswith("w_dkv"):
            return _spec(nd, None, None, None)
        if name.endswith("w_ukv"):
            return _spec(nd, None, None, "model")
        if name.endswith(("wo", "w_down")):
            return _spec(nd, None, "model", None)
        return _spec(nd)

    return _map_with_path(rule, params_shape)


def lm_batch_sharding(mesh):
    dp = dp_axes(mesh)
    return {"tokens": (dp, None), "labels": (dp, None)}


def lm_cache_sharding(mesh, cache_shape, batch: int):
    """KV caches: batch over dp when divisible, else sequence over all axes.

    GQA cache leaves: (L, B, Hkv, S, Dh); MLA: (L, B, S, r).
    """
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh_sizes(mesh))
    big_b = batch % n_dp == 0 and batch >= n_dp

    def rule(name, leaf):
        nd = _ndim(leaf)
        if name == "len":
            return _spec(nd)
        if nd == 5:  # (L, B, Hkv, S, Dh)
            if big_b:
                return _spec(nd, None, dp, None, "model", None)
            return _spec(nd, None, None, None, (*dp, "model"), None)
        if nd == 4:  # (L, B, S, r) MLA compressed
            if big_b:
                return _spec(nd, None, dp, "model", None)
            return _spec(nd, None, None, (*dp, "model"), None)
        return _spec(nd)

    return _map_with_path(rule, cache_shape)


def lm_logits_sharding(mesh):
    return (dp_axes(mesh), "model")


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def gnn_param_sharding(mesh, params_shape):
    return tree.tree_map(lambda leaf: _spec(_ndim(leaf)), params_shape)


def gnn_batch_sharding(mesh, batch_shape):
    """Node/edge arrays row-sharded over every mesh axis."""
    all_axes = tuple(mesh.mesh_dim_names)

    def rule(name, leaf):
        nd = _ndim(leaf)
        if name.endswith(("senders", "receivers", "graph_id")):
            return _spec(nd, all_axes)
        if name.endswith(("node_feat", "pos")):
            return _spec(nd, all_axes, None)
        if name.endswith("labels") and nd == 1:
            return _spec(nd, all_axes)
        if name.endswith("target"):
            return _spec(nd, all_axes, None)
        return _spec(nd)

    return _map_with_path(rule, batch_shape)


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

def fm_param_sharding(mesh, params_shape):
    dp = "data"

    def rule(name, leaf):
        nd = _ndim(leaf)
        if name.endswith("table"):
            return _spec(nd, (dp, "model"), None)
        if name.endswith("linear"):
            return _spec(nd, (dp, "model"))
        return _spec(nd)

    return _map_with_path(rule, params_shape)


def fm_batch_sharding(mesh):
    dp = dp_axes(mesh)
    return {"ids": (dp, None), "labels": (dp,)}


def opt_sharding_like(param_sharding, mesh):
    """AdamW state: mu/nu mirror params; step replicated."""
    return {"mu": param_sharding, "nu": param_sharding, "step": ()}


def flatten_specs(tree_, specs=None) -> list[tuple[str, object, tuple]]:
    """(path, leaf, spec) for every leaf of ``tree_``, its spec read from
    ``specs`` (a rule's result for ``tree_``) at the same place; without
    ``specs`` every leaf is replicated.  A NamedTuple's leaves are named by
    their fields."""
    def walk(t, s, path):
        if t is None:
            return []
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in walk(
                t[k], None if s is None else s[k], path + (k,))]
        if isinstance(t, (list, tuple)):
            keys = getattr(t, "_fields", range(len(t)))
            return [x for i, (k, v) in enumerate(zip(keys, t))
                    for x in walk(v, None if s is None else s[i],
                                  path + (k,))]
        return [("/".join(map(str, path)), t,
                 _spec(_ndim(t)) if s is None else s)]

    return walk(tree_, specs, ())
