"""Cells of the ported models (counterpart of ``repro.launch.steps``): the
LM, FM and GNN train cells and the LM and FM serve cells.

A cell is a plain callable with example inputs made from a seed, for one
(arch, shape) pair: ``cell.step_fn(*cell.args)`` runs the step.  Built
with a ``mesh`` (a ``DeviceMesh``), a cell also carries the
reference's ``in_shardings`` and ``out_shardings`` as spec trees
(``launch/sharding.py``): ``in_specs`` from :func:`arg_specs`, the single
source of the input specs, and ``out_specs``; :func:`sharded_step` runs it
as a sharded program on DTensors (the counterpart of ``jax.jit(step,
in_shardings=..., out_shardings=...)``).  An LM train cell on a mesh takes
the reference's microbatch count for it (the batch per data-parallel
device); without one, the one-device rule, and the cell is built as on one
card, with no specs.  Its ``zero1`` tuning (parameters replicated over the
data axes, optimizer state and gradients sharded over them) redistributes
each microbatch's gradients to the 2D FSDP specs, as the reference's
``constrain_grads`` does.  :func:`arg_specs` also gives the dry run the
per-device bytes of every cell.  MeshGraphNet's
partitioned mode (``tuning={"mode": "partitioned"}``) is one process per
rank of a ``torch.distributed`` group, each building its rank's cell
(``launch/gnn_partitioned.py``).

Under ``torch._subclasses.FakeTensorMode`` (on the CPU device) a cell is
built from fake tensors: the example inputs are zeros of the same shapes
and types, with no numpy draw, and a cell of any size costs no memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import Arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import dp_axes, dp_size
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import graphsage, meshgraphnet, nequip, schnet
from repro_torch.models.gnn.common import GraphBatch, edge_plan
from repro_torch.models.recsys import fm as fm_lib
from repro_torch.optim import adamw
from repro_torch.train.loop import value_and_grad


SEED = 0  # of the cells' parameters and example inputs


def _fake() -> bool:
    """Whether a FakeTensorMode is active (the cell is built on fake
    tensors)."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


class Cell(NamedTuple):
    step_fn: Callable
    args: tuple           # example inputs, on the cell's device
    meta: dict            # model_flops, param_count, kind, tokens
    in_specs: Any = None  # cells built with a mesh: a spec tree an arg
    out_specs: Any = None  # and a spec tree an output (None: as it comes)


GNN_MODULES = {
    "schnet": schnet,
    "nequip": nequip,
    "graphsage-reddit": graphsage,
    "meshgraphnet": meshgraphnet,
}


# ---------------------------------------------------------------------------
# model-flops estimates (roofline "useful flops")
# ---------------------------------------------------------------------------

def lm_model_flops(cfg: tf.LMConfig, shape) -> float:
    n_active = cfg.active_param_count()
    if shape["kind"] == "train":
        tokens = shape["batch"] * shape["seq"]
        return 6.0 * n_active * tokens
    if shape["kind"] == "prefill":
        tokens = shape["batch"] * shape["seq"]
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    tokens = shape["batch"]
    attn = (2.0 * shape["batch"] * shape["seq"] * cfg.n_layers
            * cfg.n_heads * cfg.qk_dim * 2)
    return 2.0 * n_active * tokens + attn


def gnn_model_flops(arch_id, cfg, shape) -> float:
    n, e = shape.get("n_nodes", shape.get("pad_nodes", 0)), shape.get(
        "n_edges", shape.get("pad_edges", 0))
    if arch_id == "graphsage-reddit":
        d = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        fwd = sum(2 * n * d[i] * d[i + 1] * 2 + e * d[i]
                  for i in range(cfg.n_layers))
    elif arch_id == "schnet":
        d, r = cfg.d_hidden, cfg.n_rbf
        per = 2 * e * (r * d + d * d) + 2 * n * 3 * d * d + e * d
        fwd = cfg.n_interactions * per + 2 * n * d * (d // 2)
    elif arch_id == "nequip":
        c, r = cfg.d_hidden, cfg.n_rbf
        per = (2 * e * (r * 32 + 32 * cfg.n_paths * c)
               + e * c * (1 + 3 * 4 + 9 * 2) * 2
               + 2 * n * (2 * c * c + 3 * c * c + 9 * c * c))
        fwd = cfg.n_layers * per + 2 * n * c * 16
    else:  # meshgraphnet
        d = cfg.d_hidden
        per = 2 * e * (3 * d * d + d * d) + 2 * n * (2 * d * d + d * d)
        fwd = cfg.n_layers * per + 2 * n * (cfg.d_in + cfg.d_out) * d
    return 3.0 * fwd  # fwd + bwd ~ 3x forward


def fm_model_flops(cfg, shape) -> float:
    if shape["kind"] == "retrieval":
        return 2.0 * shape["n_candidates"] * cfg.embed_dim
    mult = 6.0 if shape["kind"] == "train" else 2.0
    return mult * shape["batch"] * cfg.n_fields * cfg.embed_dim


def smoke_shapes(arch: Arch) -> dict:
    """Reduced shapes for CPU smoke tests (the reference's)."""
    if arch.family == "lm":
        return {
            "train_4k": {"kind": "train", "seq": 64, "batch": 2},
            "prefill_32k": {"kind": "prefill", "seq": 64, "batch": 2},
            "decode_32k": {"kind": "decode", "seq": 64, "batch": 2},
            "long_500k": (None if arch.shapes.get("long_500k") is None else
                          {"kind": "decode", "seq": 128, "batch": 1}),
        }
    if arch.family == "gnn":
        return {
            "full_graph_sm": {"kind": "train", "n_nodes": 128, "n_edges": 512,
                              "d_feat": 16, "n_graphs": 1},
            "minibatch_lg": {"kind": "train", "pad_nodes": 256,
                             "pad_edges": 512, "d_feat": 16, "n_graphs": 1,
                             "batch_nodes": 16, "fanout": (5, 5),
                             "full_nodes": 0, "full_edges": 0},
            "ogb_products": {"kind": "train", "n_nodes": 256, "n_edges": 1024,
                             "d_feat": 16, "n_graphs": 1},
            "molecule": {"kind": "train", "n_nodes": 4 * 10, "n_edges": 4 * 32,
                         "d_feat": 16, "n_graphs": 4, "atoms": 10},
        }
    return {
        "train_batch": {"kind": "train", "batch": 64},
        "serve_p99": {"kind": "serve", "batch": 16},
        "serve_bulk": {"kind": "serve", "batch": 128},
        "retrieval_cand": {"kind": "retrieval", "batch": 1,
                           "n_candidates": 256},
    }


def materialize(args, seed: int = 0):
    """Example inputs of the same shapes as ``args`` (trees of tensors):
    every float leaf N(0, 1) * 0.02 from a numpy generator seeded with
    ``seed`` (each leaf from the same seed, as the reference draws each
    from the same key), every integer leaf zero."""

    def one(x):
        if _fake():
            return torch.zeros_like(x)
        if x.dtype.is_floating_point:
            a = np.asarray(np.random.default_rng(seed).standard_normal(
                tuple(x.shape), dtype=np.float32) * np.float32(0.02))
            return torch.from_numpy(a).to(device=x.device, dtype=x.dtype)
        return torch.zeros_like(x)

    return tree.tree_map(one, args)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def lm_microbatches(cfg: tf.LMConfig, batch: int, seq: int,
                    tuning: dict, dp_size: int = 1) -> int:
    """The reference's gradient-accumulation rule for ``dp_size``
    data-parallel devices (1: one card): halve each device's batch while
    its activation working set, ~8 float32 buffers of (tokens, width) (MoE
    widens the width to the active experts'), is over ``mb_budget`` (8e9
    bytes) and the halves stay whole; ``microbatches`` in ``tuning``
    overrides it."""
    per_dev = max(batch // dp_size, 1)
    eff_d = cfg.d_model
    if cfg.moe:
        eff_d = max(eff_d, (cfg.top_k + cfg.n_shared) * cfg.d_expert)
    live = per_dev * seq * eff_d * 4 * 8
    mb = 1
    budget = tuning.get("mb_budget", 8e9)
    while live / mb > budget and mb < per_dev and \
            batch % (dp_size * mb * 2) == 0:
        mb *= 2
    return tuning.get("microbatches", mb)


def _dp_size(mesh) -> int:
    """Devices along the mesh's data-parallel axes (1 without a mesh)."""
    return 1 if mesh is None else dp_size(sh.mesh_sizes(mesh))


def _lm_batch(vocab: int, batch: int, seq: int, device) -> dict:
    """The cell's token batch: the synthetic stream's first, or zeros on
    fake tensors."""
    if _fake():
        z = torch.zeros((batch, seq), dtype=torch.int32, device=device)
        return {"tokens": z, "labels": z.clone()}
    return next(synthetic.lm_batches(vocab, batch, seq, SEED, device))


def _recsys_batch(cfg, batch: int, device) -> dict:
    if _fake():
        return {"ids": torch.zeros((batch, cfg.n_fields), dtype=torch.int32,
                                   device=device),
                "labels": torch.zeros(batch, device=device)}
    return next(synthetic.recsys_batches(
        cfg.n_fields, cfg.rows_per_field, batch, SEED, device))


def _microbatch(v, i: int, mb: int):
    """Microbatch ``i`` of ``mb`` of batch leaf ``v``: rows [i n, (i + 1)
    n) of n = rows / mb; of a DTensor, that slice of each rank's rows (the
    ``microbatch`` region), so no batch row moves between ranks: a
    microbatch holds other rows than on one device, their sum the same
    ones."""
    from repro_torch.dist import regions

    if not regions.is_dtensor(v):
        n = v.shape[0] // mb
        return v[i * n:(i + 1) * n]

    def local(vl):
        n = vl.shape[0] // mb
        return vl[i * n:(i + 1) * n]

    return regions.run("microbatch", local, v.device_mesh, (v,),
                       (v.placements,), v.placements, None,
                       (v.shape[0] // mb, *v.shape[1:]))


def _laid_out(grads, like, specs=None):
    """Gradients of DTensor parameters redistributed to the parameters'
    placements, or to ``specs`` (a spec tree) on the constraint mesh; plain
    gradients as they are."""
    from repro_torch.dist import regions
    from repro_torch.dist.constrain import current_mesh

    if not regions.is_dtensor(tree.leaves(grads)[0]):
        return grads
    if specs is None:
        return tree.tree_map(lambda g, p: regions.to(g, p.placements),
                             grads, like)
    mesh = current_mesh()
    return tree.unflatten(grads, [
        regions.to(g, sh.placements(mesh, sh._spec(g.ndim, *sp)))
        for g, (_, _, sp) in zip(tree.leaves(grads),
                                 sh.flatten_specs(like, specs))])


def make_train_step(loss, microbatches: int = 1,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    grad_specs=None):
    """The train step (params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}) of ``loss(params, batch) -> (loss,
    metrics)``: its value and gradient, then one AdamW update.  With
    ``microbatches`` > 1 the batch is cut into that many equal slices along
    its first axis, their gradients summed in float32 and averaged, and
    their losses averaged (the reference's ``lax.scan`` over microbatches).

    On DTensors (:func:`sharded_step`) each microbatch's gradients are laid
    out as the parameters, or by ``grad_specs`` (ZeRO-1: the 2D FSDP
    specs, the reference's ``constrain_grads``) before they are summed.
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def grad_of(params, part):
        (li, _), gi = value_and_grad(loss, params, part)
        return li, _laid_out(gi, params, grad_specs)

    def train_step(params, opt_state, b):
        if microbatches == 1:
            l, grads = grad_of(params, b)
        else:
            l = 0.0
            grads = _laid_out(tree.tree_map(
                lambda x: torch.zeros_like(x, dtype=torch.float32), params),
                params, grad_specs)
            for i in range(microbatches):
                part = {k: _microbatch(v, i, microbatches)
                        for k, v in b.items()}
                li, gi = grad_of(params, part)
                grads = tree.tree_map(lambda a, x: a + x.float(), grads, gi)
                l = l + li
            l = l / microbatches
            grads = tree.tree_map(lambda x: x / microbatches, grads)
        params, opt_state, om = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": l, **om}

    train_step.loss = loss
    return train_step


def _lm_cell(arch: Arch, shape_name: str, cfg: tf.LMConfig, shape, params,
             device, tuning: dict, mesh=None) -> Cell:
    kind, batch, seq = shape["kind"], shape["batch"], shape["seq"]
    meta = {
        "kind": kind,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "model_flops": lm_model_flops(cfg, shape),
        "tokens": batch * (seq if kind != "decode" else 1),
    }
    if kind == "train":
        mb = lm_microbatches(cfg, batch, seq, tuning, _dp_size(mesh))
        meta["microbatches"] = mb
        b = _lm_batch(cfg.vocab, batch, seq, device)
        grad_specs = (sh.lm_param_sharding(mesh, params)
                      if mesh is not None and tuning.get("zero1") else None)
        return Cell(make_train_step(lambda p, bb: tf.loss_fn(cfg, p, bb), mb,
                                    grad_specs=grad_specs),
                    (params, adamw.init_state(params), b), meta)
    tokens = _lm_batch(cfg.vocab, batch, seq if kind == "prefill" else 1,
                       device)["tokens"]
    if kind == "prefill":
        def prefill_step(params, tokens):
            return tf.prefill(cfg, params, tokens)

        return Cell(prefill_step, (params, tokens), meta)

    def serve_step(params, cache, tokens):
        # decode against an almost-full cache
        cache = dict(cache, len=seq - 1)
        return tf.decode_step(cfg, params, cache, tokens)

    cache = tf.init_cache(cfg, batch, seq, device=device)
    return Cell(serve_step, (params, cache, tokens[:, 0]), meta)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_shape_config(arch: Arch, shape_name: str, smoke: bool):
    cfg = arch.smoke if smoke else arch.config
    shape = arch.shapes[shape_name]
    if arch.id == "graphsage-reddit":
        cfg = dataclasses.replace(cfg, d_in=shape["d_feat"])
    elif arch.id == "meshgraphnet":
        cfg = dataclasses.replace(cfg, d_in=shape["d_feat"])
    return cfg, shape


def _pad512(x: int) -> int:
    """Mesh-divisible padding (512 = the reference's largest mesh device
    count); the models' ghost-index convention makes padded rows inert."""
    return ((x + 511) // 512) * 512


def _gnn_batch_spec(arch_id: str, shape) -> dict:
    """name -> (shape, dtype) of the cell's batch."""
    n = _pad512(shape.get("n_nodes", shape.get("pad_nodes")))
    e = _pad512(shape.get("n_edges", shape.get("pad_edges")))
    g = shape["n_graphs"]
    d_feat = shape["d_feat"]
    molecular = arch_id in ("schnet", "nequip")
    b = {
        "node_feat": ((n, 1 if molecular else d_feat), torch.float32),
        "senders": ((e,), torch.int32),
        "receivers": ((e,), torch.int32),
        "pos": ((n, 3), torch.float32),
        "graph_id": ((n,), torch.int32),
    }
    if molecular:
        b["energy"] = ((g,), torch.float32)
    elif arch_id == "graphsage-reddit":
        b["labels"] = ((n,), torch.int32)
    else:
        b["target"] = ((n, 2), torch.float32)
    return b


def with_edge_plan(b: dict, n_graphs: int) -> dict:
    """The batch dict with its edge plan (``"plan"``), built once: every
    step over this batch reuses it.  On fake tensors the graph ids are
    taken as sorted (a cell's are zeros)."""
    return {**b, "plan": edge_plan(b["senders"], b["receivers"],
                                   b["graph_id"], n_graphs,
                                   check=not _fake())}


def gnn_loss(arch_id: str, cfg, n_graphs: int):
    """loss(params, b) over a cell's batch dict ``b``."""
    mod = GNN_MODULES[arch_id]

    def loss(params, b):
        graph = GraphBatch(
            node_feat=b["node_feat"], senders=b["senders"],
            receivers=b["receivers"], edge_feat=None, pos=b["pos"],
            graph_id=b["graph_id"], n_graphs=n_graphs, plan=b.get("plan"))
        if arch_id in ("schnet", "nequip"):
            payload = {"graph": graph, "energy": b["energy"]}
        elif arch_id == "graphsage-reddit":
            payload = {"graph": graph, "labels": b["labels"]}
        else:
            payload = {"graph": graph, "target": b["target"]}
        return mod.loss_fn(cfg, params, payload)

    return loss


def _gnn_cell(arch: Arch, shape_name: str, cfg, shape, params,
              device, tuning: dict, mesh=None) -> Cell:
    n_graphs = shape["n_graphs"]
    spec = _gnn_batch_spec(arch.id, shape)
    batch = materialize({k: torch.empty(s, dtype=dt, device=device)
                         for k, (s, dt) in spec.items()}, SEED)
    return Cell(
        step_fn=make_train_step(gnn_loss(arch.id, cfg, n_graphs)),
        args=(params, adamw.init_state(params),
              with_edge_plan(batch, n_graphs)),
        meta={
            "kind": "train",
            "param_count": cfg.param_count(),
            "active_param_count": cfg.param_count(),
            "model_flops": gnn_model_flops(arch.id, cfg, shape),
            "tokens": shape.get("n_nodes", shape.get("pad_nodes")),
            "n_graphs": n_graphs,
        },
    )


def materialize_cell(cell: Cell, seed: int = 0):
    """A train cell's (params, opt_state, batch) drawn anew from ``seed``
    by :func:`materialize`; the optimizer state must be *valid* (zero
    moments), not random — sqrt(random nu) is NaN.  A GNN batch gets its
    edge plan."""
    params, _, batch = cell.args
    params = materialize(params, seed)
    batch = materialize({k: v for k, v in batch.items() if k != "plan"},
                        seed)
    if "n_graphs" in cell.meta:
        batch = with_edge_plan(batch, cell.meta["n_graphs"])
    return params, adamw.init_state(params), batch


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def _fm_cell(arch: Arch, shape_name: str, cfg: fm_lib.FMConfig, shape,
             params, device, tuning: dict, mesh=None) -> Cell:
    kind = shape["kind"]
    meta = {
        "kind": kind,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.param_count(),
        "model_flops": fm_model_flops(cfg, shape),
        "tokens": shape.get("batch", 1),
    }
    if kind == "train":
        batch = _recsys_batch(cfg, shape["batch"], device)
        return Cell(make_train_step(lambda p, b: fm_lib.loss_fn(cfg, p, b)),
                    (params, adamw.init_state(params), batch), meta)
    if kind == "serve":
        ids = _recsys_batch(cfg, shape["batch"], device)["ids"]

        def serve_step(params, ids):
            return fm_lib.serve(cfg, params, ids)

        return Cell(serve_step, (params, ids), meta)

    # retrieval: one query against n_candidates items of the last field
    def retrieval_step(params, user_ids, cand_ids):
        return fm_lib.retrieval_scores(cfg, params, user_ids, cand_ids)

    if _fake():
        return Cell(retrieval_step, (params, torch.zeros(
            (1, cfg.n_fields - 1), dtype=torch.int32, device=device),
            torch.zeros(shape["n_candidates"], dtype=torch.int32,
                        device=device)), meta)
    rng = np.random.default_rng(SEED)
    user_ids = rng.integers(0, cfg.rows_per_field, (1, cfg.n_fields - 1))
    cand_ids = rng.integers(0, cfg.rows_per_field, shape["n_candidates"])
    return Cell(retrieval_step, (
        params, torch.from_numpy(user_ids.astype(np.int32)).to(device),
        torch.from_numpy(cand_ids.astype(np.int32)).to(device)), meta)


def build_cell(arch: Arch, shape_name: str, device=None, smoke: bool = False,
               params=None, tuning: dict | None = None, mesh=None) -> Cell:
    """The cell of ``arch`` at ``shape_name``: a train cell (args: params,
    optimizer state, batch) or an LM or FM serve cell.

    ``smoke`` takes the reduced config and shapes.  ``params`` defaults to
    the model's ``init_params`` from a generator seeded with ``SEED`` on
    ``device`` (default: the card); the example inputs come from ``SEED``.
    ``tuning`` is the reference's, for LMs: ``config`` (fields of the
    config to replace), ``microbatches``, ``mb_budget``; ``zero1`` is
    taken and changes only :func:`arg_specs`.  ``mesh`` (a DeviceMesh,
    ``launch/mesh.py``) gives the cell its specs (:func:`sharded_step`
    runs it on the mesh) and sets an LM train cell's microbatches by the
    reference's rule for its data-parallel devices.  For GNNs, ``mode`` =
    ``"partitioned"`` builds this rank's cell of
    ``launch/gnn_partitioned.partitioned_gnn_cell`` (MeshGraphNet only;
    ``halo_frac`` sizes its halo) over ``mesh`` (a DeviceMesh, or None for
    the default group); it needs an initialised process group and raises
    ``RuntimeError`` without one.
    """
    tuning = tuning or {}
    device = resolve_device(device)
    if smoke:
        arch = dataclasses.replace(arch, shapes=smoke_shapes(arch))
    if shape_name not in arch.shapes:
        raise KeyError(f"{arch.id} has no shape {shape_name}")
    shape = arch.shapes[shape_name]
    if shape is None:
        raise ValueError(f"{arch.id} {shape_name}: "
                         f"{arch.skip_notes.get(shape_name, 'skipped')}")
    if arch.family == "gnn":
        if tuning.get("mode") == "partitioned":
            from repro_torch.launch.gnn_partitioned import \
                partitioned_gnn_cell

            return partitioned_gnn_cell(arch, shape_name, mesh, device,
                                        smoke, tuning, params)
        cfg, shape = _gnn_shape_config(arch, shape_name, smoke)
        module: Any = GNN_MODULES[arch.id]
        make = _gnn_cell
    else:
        cfg = arch.smoke if smoke else arch.config
        if arch.family == "lm" and "config" in tuning:
            cfg = dataclasses.replace(cfg, **tuning["config"])
        module = {"lm": tf, "recsys": fm_lib}[arch.family]
        make = _lm_cell if arch.family == "lm" else _fm_cell
    if params is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = module.init_params(cfg, gen)
    cell = make(arch, shape_name, cfg, shape, params, device, tuning, mesh)
    if mesh is None:
        return cell
    return cell._replace(in_specs=arg_specs(arch, cell, mesh, tuning),
                         out_specs=_out_specs(cfg, cell, mesh, tuning, arch))


# ---------------------------------------------------------------------------
# argument specs on a mesh (the reference's in_shardings)
# ---------------------------------------------------------------------------

# batch leaves that the reference's cells do not have: a GNN batch's edge
# plan (``models/gnn/common.py:edge_plan``: the senders' and receivers'
# stable argsorts, their sorted ids and per-node counts, and the graph ids'
# index), which the port builds once a batch so that every sum runs on
# segment_reduce in a fixed order
PORT_ONLY = ("plan",)


def _plan_specs(mesh, plan):
    """Specs of an edge plan: its (E,) and (N,) arrays rows-sharded over
    every axis, as the senders and node arrays are; the per-graph counts
    replicated."""
    rows = (tuple(mesh.mesh_dim_names),)

    def index_specs(ix, counts_rows: bool):
        if ix is None:
            return None
        return ix._replace(index=rows, order=rows, ids=rows,
                           counts=None if ix.counts is None else
                           (rows if counts_rows else (None,)))

    return plan._replace(senders=index_specs(plan.senders, True),
                         receivers=index_specs(plan.receivers, True),
                         graph=index_specs(plan.graph, False))


def arg_specs(arch: Arch, cell: Cell, mesh, tuning: dict | None = None):
    """The spec tree (``launch/sharding.py``) of each of ``cell.args`` on
    ``mesh``, as the reference's cell gives its ``in_shardings``; a GNN
    batch's edge plan (``PORT_ONLY``) gets :func:`_plan_specs`."""
    tuning = tuning or {}
    kind, params = cell.meta["kind"], cell.args[0]
    dp = dp_axes(mesh)
    if arch.family == "gnn":
        p_sh = sh.gnn_param_sharding(mesh, params)
        batch = cell.args[2]
        b_sh = sh.gnn_batch_sharding(
            mesh, {k: v for k, v in batch.items() if k not in PORT_ONLY})
        if "plan" in batch:
            b_sh["plan"] = _plan_specs(mesh, batch["plan"])
        return p_sh, sh.opt_sharding_like(p_sh, mesh), b_sh
    if arch.family == "recsys":
        p_sh = sh.fm_param_sharding(mesh, params)
        if kind == "train":
            return (p_sh, sh.opt_sharding_like(p_sh, mesh),
                    sh.fm_batch_sharding(mesh))
        if kind == "serve":
            return p_sh, (dp, None)
        return p_sh, (None, None), (dp,)
    zero1 = tuning.get("zero1", False)
    p_sh = (sh.lm_param_sharding_zero1 if zero1
            else sh.lm_param_sharding)(mesh, params)
    if kind == "train":
        grad_sh = sh.lm_param_sharding(mesh, params)
        return (p_sh, sh.opt_sharding_like(grad_sh if zero1 else p_sh, mesh),
                sh.lm_batch_sharding(mesh))
    if kind == "prefill":
        return p_sh, (dp, None)
    cache, tokens = cell.args[1], cell.args[2]
    batch, n_dp = tokens.shape[0], _dp_size(mesh)
    big_b = batch % n_dp == 0 and batch >= n_dp
    return (p_sh, sh.lm_cache_sharding(mesh, cache, batch),
            (dp,) if big_b else (None,))


def _out_specs(cfg, cell: Cell, mesh, tuning: dict, arch: Arch):
    """The reference's ``out_shardings`` of a cell on ``mesh``: train
    (params, opt_state, None); FM serve and retrieval (dp,); LM prefill
    (the logits', the cache's); LM decode ((dp or None, "model"), the
    cache's)."""
    kind = cell.meta["kind"]
    p_sh, second = arg_specs(arch, cell, mesh, tuning)[:2]
    if kind == "train":
        return p_sh, second, None
    dp = dp_axes(mesh)
    if arch.family == "recsys":
        return (dp,)
    if kind == "prefill":
        batch, seq = cell.args[1].shape
        cache = tf.init_cache(cfg, batch, seq, device="meta")
        return (sh.lm_logits_sharding(mesh),
                sh.lm_cache_sharding(mesh, cache, batch))
    batch, n_dp = cell.args[2].shape[0], _dp_size(mesh)
    big_b = batch % n_dp == 0 and batch >= n_dp
    return (dp if big_b else None, "model"), second


def sharded_args(cell: Cell, mesh) -> tuple:
    """The cell's example inputs laid out on ``mesh`` as DTensors by its
    ``in_specs`` (every rank builds the same seeded inputs and keeps its
    blocks).  A GNN batch's edge plan is built anew from the laid-out
    batch, each rank sorting its own edges (``models/gnn/common.py``): its
    arrays have the plan's specs, each rank's block of them its own
    edges' order."""
    args = []
    for a, spec in zip(cell.args, cell.in_specs):
        if isinstance(a, dict) and "plan" in a:
            a = with_edge_plan(sh.distribute(
                {k: v for k, v in a.items() if k != "plan"},
                {k: v for k, v in spec.items() if k != "plan"}, mesh),
                cell.meta["n_graphs"])
        else:
            a = sh.distribute(a, spec, mesh)
        args.append(a)
    return tuple(args)


def _lay_out(out, specs, mesh):
    """Each DTensor of ``out`` redistributed to its spec in ``specs`` (a
    spec tree of ``out``'s structure; None leaves a subtree as it comes)."""
    from repro_torch.dist import regions

    if specs is None:
        return out
    if isinstance(out, dict):
        return {k: _lay_out(v, specs[k], mesh) for k, v in out.items()}
    if isinstance(out, (list, tuple)) and not regions.is_dtensor(out):
        return type(out)(_lay_out(v, sp, mesh) for v, sp in zip(out, specs))
    if regions.is_dtensor(out):
        return regions.to(out, sh.placements(
            mesh, sh._spec(out.ndim, *specs)))
    return out


def sharded_step(cell: Cell, mesh):
    """``cell.step_fn`` as a sharded program on ``mesh`` (the counterpart
    of ``jax.jit(step, in_shardings, out_shardings)``): a function of
    DTensors laid out by ``cell.in_specs`` (:func:`sharded_args`) that
    runs the step with ``constrain`` resolving against ``mesh`` and
    returns its outputs redistributed to ``cell.out_specs``.  Plain
    tensors the step makes (positions, masks: the same on every rank) are
    taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.constrain import constraint_mesh

    if cell.in_specs is None:
        raise ValueError("the cell carries no specs: build it with a mesh")

    def step(*args):
        with constraint_mesh(mesh), implicit_replication():
            out = cell.step_fn(*args)
        return _lay_out(out, cell.out_specs, mesh)

    return step


def argument_leaves(cell: Cell, specs=None, mesh=None) -> list[dict]:
    """Every argument leaf of ``cell`` with its path (``<arg>/<path>``),
    spec, per-device shape and bytes, and whether the reference has it;
    without ``specs`` and ``mesh`` (one card) every leaf is whole.
    The LM cache's length, a Python int here, is counted as the
    reference's int32 scalar."""
    out = []
    for path, leaf, spec in sh.flatten_specs(cell.args, specs):
        shape, dtype = ((tuple(leaf.shape), leaf.dtype)
                        if isinstance(leaf, torch.Tensor)
                        else ((), torch.int32))
        local = shape if mesh is None else sh.shard_shape(mesh, spec, shape)
        keys = path.split("/")
        out.append({"path": path, "spec": spec, "shard_shape": local,
                    "device_bytes": int(np.prod(local)) * dtype.itemsize,
                    "port_only": len(keys) > 1 and keys[1] in PORT_ONLY})
    return out
