"""AdamW with decoupled weight decay, global-norm clipping, LR schedules
(counterpart of ``repro.optim.adamw``).

Raw-tree implementation: parameters are nested dicts and lists of tensors,
walked in ``jax.tree`` order (``repro_torch.tree``), so the global norm sums
its leaves in the reference's order.  Optimizer state is kept in float32
regardless of the parameters' dtype; the step count is an int32 tensor and
``b ** step`` is taken in float32, as the reference does.  Every scalar
stays a tensor on the parameters' device: an update reads nothing back to
the host.

Parameters, gradients and state may be DTensors (a sharded step): every
op is elementwise or a sum, the constants are Python numbers (no plain
tensor meets a DTensor), and the global norm is the whole tree's on every
rank (each leaf's sum of squares is a ``Partial`` over its shards, all
reduced before the square root).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"   # cosine | linear | const


def schedule_lr(cfg: AdamWConfig, step):
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        decay = 1.0
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - frac
    return cfg.lr * warm * decay


def init_state(params):
    """Zero moments laid out as the parameters (DTensors alike) and a
    step count of 0 (replicated on a DTensor's mesh)."""
    from repro_torch.dist import regions

    first = tree.leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if regions.is_dtensor(first):
        step = regions.replicated(step, first.device_mesh)
    return {"mu": tree.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "nu": tree.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "step": step}


def global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.leaves(grads)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule_lr(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / b1c
        nhat = nu / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + (
            cfg.weight_decay * p.float())
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        tree.leaves(params), tree.leaves(grads), tree.leaves(state["mu"]),
        tree.leaves(state["nu"]))]
    new_p = tree.unflatten(params, [o[0] for o in out])
    new_mu = tree.unflatten(params, [o[1] for o in out])
    new_nu = tree.unflatten(params, [o[2] for o in out])
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, {
        "grad_norm": gn, "lr": lr}
