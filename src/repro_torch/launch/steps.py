"""Cells of the ported models (counterpart of ``repro.launch.steps``): the
LM, FM and GNN train cells and the LM and FM serve cells.

A cell is a plain callable with example inputs made from a seed, for one
(arch, shape) pair: ``cell.step_fn(*cell.args)`` runs the step.  The
reference's cells carry shardings over a device mesh; the port runs on one
card, so it has none: its ``zero1`` tuning (optimizer state sharded over
the data axis) is a no-op here.
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
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import graphsage, meshgraphnet, nequip, schnet
from repro_torch.models.gnn.common import GraphBatch, edge_plan
from repro_torch.models.recsys import fm as fm_lib
from repro_torch.optim import adamw
from repro_torch.train.loop import value_and_grad


SEED = 0  # of the cells' parameters and example inputs


class Cell(NamedTuple):
    step_fn: Callable
    args: tuple           # example inputs, on the cell's device
    meta: dict            # model_flops, param_count, kind, tokens


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
                    tuning: dict) -> int:
    """The reference's gradient-accumulation rule on one device: halve the
    batch while its activation working set, ~8 float32 buffers of
    (tokens, width) (MoE widens the width to the active experts'), is over
    ``mb_budget`` (8e9 bytes) and the halves stay whole; ``microbatches``
    in ``tuning`` overrides it."""
    eff_d = cfg.d_model
    if cfg.moe:
        eff_d = max(eff_d, (cfg.top_k + cfg.n_shared) * cfg.d_expert)
    live = batch * seq * eff_d * 4 * 8
    mb = 1
    budget = tuning.get("mb_budget", 8e9)
    while live / mb > budget and mb < batch and batch % (mb * 2) == 0:
        mb *= 2
    return tuning.get("microbatches", mb)


def make_train_step(loss, microbatches: int = 1,
                    opt_cfg: adamw.AdamWConfig | None = None):
    """The train step (params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}) of ``loss(params, batch) -> (loss,
    metrics)``: its value and gradient, then one AdamW update.  With
    ``microbatches`` > 1 the batch is cut into that many equal slices along
    its first axis, their gradients summed in float32 and averaged, and
    their losses averaged (the reference's ``lax.scan`` over microbatches).
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, b):
        if microbatches == 1:
            (l, _), grads = value_and_grad(loss, params, b)
        else:
            n = next(iter(b.values())).shape[0] // microbatches
            l = 0.0
            grads = tree.tree_map(
                lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device), params)
            for i in range(microbatches):
                part = {k: v[i * n:(i + 1) * n] for k, v in b.items()}
                (li, _), gi = value_and_grad(loss, params, part)
                grads = tree.tree_map(lambda a, x: a + x.float(), grads, gi)
                l = l + li
            l = l / microbatches
            grads = tree.tree_map(lambda x: x / microbatches, grads)
        params, opt_state, om = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": l, **om}

    return train_step


def _lm_cell(arch: Arch, shape_name: str, cfg: tf.LMConfig, shape, params,
             device, tuning: dict) -> Cell:
    kind, batch, seq = shape["kind"], shape["batch"], shape["seq"]
    meta = {
        "kind": kind,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "model_flops": lm_model_flops(cfg, shape),
        "tokens": batch * (seq if kind != "decode" else 1),
    }
    if kind == "train":
        mb = lm_microbatches(cfg, batch, seq, tuning)
        meta["microbatches"] = mb
        b = next(synthetic.lm_batches(cfg.vocab, batch, seq, SEED, device))
        return Cell(make_train_step(lambda p, bb: tf.loss_fn(cfg, p, bb), mb),
                    (params, adamw.init_state(params), b), meta)
    tokens = next(synthetic.lm_batches(
        cfg.vocab, batch, seq if kind == "prefill" else 1, SEED,
        device))["tokens"]
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
    step over this batch reuses it."""
    return {**b, "plan": edge_plan(b["senders"], b["receivers"],
                                   b["graph_id"], n_graphs)}


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
              device, tuning: dict) -> Cell:
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
             params, device, tuning: dict) -> Cell:
    kind = shape["kind"]
    meta = {
        "kind": kind,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.param_count(),
        "model_flops": fm_model_flops(cfg, shape),
        "tokens": shape.get("batch", 1),
    }
    if kind == "train":
        batch = next(synthetic.recsys_batches(
            cfg.n_fields, cfg.rows_per_field, shape["batch"], SEED, device))
        return Cell(make_train_step(lambda p, b: fm_lib.loss_fn(cfg, p, b)),
                    (params, adamw.init_state(params), batch), meta)
    if kind == "serve":
        ids = next(synthetic.recsys_batches(
            cfg.n_fields, cfg.rows_per_field, shape["batch"], SEED,
            device))["ids"]

        def serve_step(params, ids):
            return fm_lib.serve(cfg, params, ids)

        return Cell(serve_step, (params, ids), meta)

    # retrieval: one query against n_candidates items of the last field
    rng = np.random.default_rng(SEED)
    user_ids = rng.integers(0, cfg.rows_per_field, (1, cfg.n_fields - 1))
    cand_ids = rng.integers(0, cfg.rows_per_field, shape["n_candidates"])

    def retrieval_step(params, user_ids, cand_ids):
        return fm_lib.retrieval_scores(cfg, params, user_ids, cand_ids)

    return Cell(retrieval_step, (
        params, torch.from_numpy(user_ids.astype(np.int32)).to(device),
        torch.from_numpy(cand_ids.astype(np.int32)).to(device)), meta)


def build_cell(arch: Arch, shape_name: str, device=None, smoke: bool = False,
               params=None, tuning: dict | None = None) -> Cell:
    """The cell of ``arch`` at ``shape_name``: a train cell (args: params,
    optimizer state, batch) or an LM or FM serve cell.

    ``smoke`` takes the reduced config and shapes.  ``params`` defaults to
    the model's ``init_params`` from a generator seeded with ``SEED`` on
    ``device`` (default: the card); the example inputs come from ``SEED``.
    ``tuning`` is the reference's, for LMs: ``config`` (fields of the
    config to replace), ``microbatches``, ``mb_budget``; ``zero1`` is
    taken and does nothing on one card.
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
    return make(arch, shape_name, cfg, shape, params, device, tuning)
