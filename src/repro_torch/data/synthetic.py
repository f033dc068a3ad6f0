"""Synthetic data streams of the ported models (counterpart of
``repro.data.synthetic``: ``lm_batches`` and ``recsys_batches``).

The same numpy draws as the reference, so the same seed gives the same
numbers; each batch is returned as int32/float32 tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               device="cpu"):
    """Infinite stream of (tokens, labels) — Zipf-ish synthetic LM data."""
    rng = np.random.default_rng(seed)
    while True:
        probs = 1.0 / np.arange(1, vocab + 1)
        probs /= probs.sum()
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        yield {
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device),
        }


def recsys_batches(n_fields: int, rows_per_field: int, batch: int,
                   seed: int = 0, device="cpu"):
    """Clickthrough-style batches with a planted preference rule."""
    rng = np.random.default_rng(seed)
    w_secret = rng.standard_normal(n_fields)
    while True:
        ids = rng.integers(0, rows_per_field, (batch, n_fields))
        signal = ((ids % 7) / 3.0 - 1.0) @ w_secret
        labels = (signal + 0.5 * rng.standard_normal(batch) > 0).astype(
            np.float32)
        yield {
            "ids": torch.from_numpy(ids.astype(np.int32)).to(device),
            "labels": torch.from_numpy(labels).to(device),
        }
