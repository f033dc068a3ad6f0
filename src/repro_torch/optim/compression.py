"""int8 error-feedback gradient compression (counterpart of
``repro.optim.compression``).

Each gradient leaf, plus the error carried from the last step, is scaled
by its max |value| / 127, rounded half to even to int8, and the rounding
error is carried to the next step: compress -> (all-reduce the int8
payloads) -> decompress.  Trees are walked in ``jax.tree`` order.
"""
from __future__ import annotations

import torch

from repro_torch import tree


def init_error(params):
    return tree.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)


def compress(grads, error):
    """Returns (payload int8 tree, scales tree, new_error tree)."""

    def one(g, e):
        g = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return q, scale, g - deq

    outs = [one(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(error))]
    q = tree.unflatten(grads, [o[0] for o in outs])
    s = tree.unflatten(grads, [o[1] for o in outs])
    ne = tree.unflatten(grads, [o[2] for o in outs])
    return q, s, ne


def decompress(payload, scales):
    return tree.tree_map(lambda q, s: q.float() * s, payload, scales)


def compressed_bytes(grads) -> int:
    """int8 payload + f32 scale per tensor."""
    return sum(x.numel() + 4 for x in tree.leaves(grads))


def raw_bytes(grads) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(grads))
