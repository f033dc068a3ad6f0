"""Arch descriptor schema shared by all config modules (a copy of
``repro.configs.base``).

ARCH = Arch(
    id         = "gemma3-1b",
    family     = "lm" | "gnn" | "recsys",
    config     = <model config dataclass, full published dims>,
    smoke      = <reduced config of the same family>,
    shapes     = {shape_name: <shape dict>},   # value None => skipped cell
    skip_notes = {shape_name: "why"},
)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Arch:
    id: str
    family: str
    config: Any
    smoke: Any
    shapes: dict
    skip_notes: dict = field(default_factory=dict)
    source: str = ""


LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def lm_shapes(long_ok: bool):
    shapes = {
        "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
        "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
        "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    }
    if long_ok:
        shapes["long_500k"] = {"kind": "decode", "seq": 524288, "batch": 1}
    else:
        shapes["long_500k"] = None
    return shapes
