"""Factorization Machine [Rendle ICDM'10]: 39 sparse fields, embed_dim=10,
pairwise interactions via the O(nk) sum-square trick (the fm_interaction
CUDA kernel).  A copy of ``repro.configs.fm_cfg``.
"""
from repro_torch.configs.base import Arch
from repro_torch.models.recsys.fm import FMConfig

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

ARCH = Arch(
    id="fm",
    family="recsys",
    source="Rendle ICDM'10",
    config=FMConfig(n_fields=39, embed_dim=10, rows_per_field=262144),
    smoke=FMConfig(n_fields=8, embed_dim=8, rows_per_field=64),
    shapes=dict(RECSYS_SHAPES),
)
