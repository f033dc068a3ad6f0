"""Serve cells of the ported models (counterpart of the serve parts of
``repro.launch.steps``).

A cell is a plain callable with example inputs made from a seed, for one
(arch, shape) pair: ``cell.step_fn(*cell.args)`` runs the step.  The
reference's cells carry shardings over a device mesh; the port runs on one
card, so it has none.  Training cells wait for the port of the optimizer
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import Arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import fm as fm_lib


SEED = 0  # of the cells' parameters and example inputs


class Cell(NamedTuple):
    step_fn: Callable
    args: tuple           # example inputs, on the cell's device
    meta: dict            # model_flops, param_count, kind, tokens


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


def fm_model_flops(cfg, shape) -> float:
    if shape["kind"] == "retrieval":
        return 2.0 * shape["n_candidates"] * cfg.embed_dim
    mult = 6.0 if shape["kind"] == "train" else 2.0
    return mult * shape["batch"] * cfg.n_fields * cfg.embed_dim


def smoke_shapes(arch: Arch) -> dict:
    """Reduced shapes for CPU smoke tests (the reference's, LM and recsys)."""
    if arch.family == "lm":
        return {
            "train_4k": {"kind": "train", "seq": 64, "batch": 2},
            "prefill_32k": {"kind": "prefill", "seq": 64, "batch": 2},
            "decode_32k": {"kind": "decode", "seq": 64, "batch": 2},
            "long_500k": (None if arch.shapes.get("long_500k") is None else
                          {"kind": "decode", "seq": 128, "batch": 1}),
        }
    return {
        "train_batch": {"kind": "train", "batch": 64},
        "serve_p99": {"kind": "serve", "batch": 16},
        "serve_bulk": {"kind": "serve", "batch": 128},
        "retrieval_cand": {"kind": "retrieval", "batch": 1,
                           "n_candidates": 256},
    }


def _training_not_ported(arch: Arch, shape_name: str):
    return NotImplementedError(
        f"{arch.id} {shape_name}: training cells wait for the port of the "
        "optimizer and the training loop (ROADMAP.md, Queue 1)")


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch: Arch, shape_name: str, cfg: tf.LMConfig, shape, params,
             device) -> Cell:
    kind, batch, seq = shape["kind"], shape["batch"], shape["seq"]
    meta = {
        "kind": kind,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "model_flops": lm_model_flops(cfg, shape),
        "tokens": batch * (seq if kind != "decode" else 1),
    }
    if kind == "train":
        raise _training_not_ported(arch, shape_name)
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
# recsys cells
# ---------------------------------------------------------------------------

def _fm_cell(arch: Arch, shape_name: str, cfg: fm_lib.FMConfig, shape,
             params, device) -> Cell:
    kind = shape["kind"]
    meta = {
        "kind": kind,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.param_count(),
        "model_flops": fm_model_flops(cfg, shape),
        "tokens": shape.get("batch", 1),
    }
    if kind == "train":
        raise _training_not_ported(arch, shape_name)
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
               params=None) -> Cell:
    """The serve cell of ``arch`` at ``shape_name``.

    ``smoke`` takes the reduced config and shapes.  ``params`` defaults to
    the model's ``init_params`` from a generator seeded with ``SEED`` on
    ``device`` (default: the card); the example inputs come from ``SEED``.
    """
    device = resolve_device(device)
    if smoke:
        arch = dataclasses.replace(arch, shapes=smoke_shapes(arch))
    if shape_name not in arch.shapes:
        raise KeyError(f"{arch.id} has no shape {shape_name}")
    shape = arch.shapes[shape_name]
    if shape is None:
        raise ValueError(f"{arch.id} {shape_name}: "
                         f"{arch.skip_notes.get(shape_name, 'skipped')}")
    cfg = arch.smoke if smoke else arch.config
    module: Any = {"lm": tf, "recsys": fm_lib}.get(arch.family)
    if module is None:
        raise NotImplementedError(
            f"{arch.id}: the {arch.family} family is still to be ported "
            "(ROADMAP.md, Queue 1)")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = module.init_params(cfg, gen)
    make = _lm_cell if arch.family == "lm" else _fm_cell
    return make(arch, shape_name, cfg, shape, params, device)
