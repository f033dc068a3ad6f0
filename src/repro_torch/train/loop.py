"""Fault-tolerant training loop (counterpart of ``repro.train.loop``).

Behaviours, as the reference's:
  * checkpoint/restart — periodic atomic checkpoints; ``run()`` resumes from
    the latest one (bitwise-identical optimizer state), so a killed process
    continues where it stopped;
  * failure injection — ``fail_at_step`` simulates a node crash in tests;
  * straggler watchdog — per-step wall time vs a moving average; steps
    slower than ``straggler_factor`` x EMA are counted and logged;
  * optional int8 error-feedback gradient compression (optim/compression).

The reference jits and donates its step; here :func:`build_train_step`
runs eagerly, and ``jax.block_until_ready`` becomes a device synchronize
before each step's time is read.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from repro_torch import tree
from repro_torch.device import synchronize
from repro_torch.optim import adamw, compression
from repro_torch.train import checkpoint as ckpt


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    resume: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    fail_at_step: int = -1          # failure injection (tests)
    compress_grads: bool = False


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


def value_and_grad(loss_fn: Callable, params, batch):
    """``loss_fn(params, batch) -> (loss, metrics)`` and the gradient of the
    loss with respect to every leaf of ``params`` (zeros where a leaf does
    not reach the loss, as ``jax.grad`` gives)."""
    live = tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree.leaves(live), allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree.unflatten(params, grads)


def build_train_step(loss_fn: Callable, opt_cfg: adamw.AdamWConfig,
                     compress: bool = False):
    """loss_fn(params, batch) -> (loss, metrics). Returns the step fn
    (params, opt_state, err, batch) -> (params, opt_state, err, metrics)."""

    def step(params, opt_state, err, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        if compress:
            payload, scales, err = compression.compress(grads, err)
            grads = compression.decompress(payload, scales)
        params, opt_state, opt_metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, err, {
            "loss": loss, **metrics, **opt_metrics}

    return step


def run(cfg: TrainLoopConfig, state: TrainState, train_step,
        data: Iterator, err=None, log=print) -> TrainState:
    """Run (or resume) the loop. Returns the final state."""
    start_step = state.step
    if cfg.resume:
        latest = ckpt.latest_step(cfg.ckpt_dir)
        if latest is not None and latest > state.step:
            t = ckpt.restore(cfg.ckpt_dir, latest,
                             {"params": state.params, "opt": state.opt_state})
            state = TrainState(t["params"], t["opt"], latest)
            start_step = latest
            log(f"[loop] resumed from step {latest}")
    device = tree.leaves(state.params)[0].device
    if err is None:
        err = compression.init_error(state.params) if cfg.compress_grads \
            else torch.zeros((), device=device)

    ema = None
    stragglers = 0
    history = []
    params, opt_state = state.params, state.opt_state
    for step_i in range(start_step, cfg.total_steps):
        if step_i == cfg.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step_i}")
        batch = next(data)
        t0 = time.perf_counter()
        params, opt_state, err, metrics = train_step(
            params, opt_state, err, batch)
        synchronize(device)
        dt = time.perf_counter() - t0
        if ema is None:
            ema = dt
        if dt > cfg.straggler_factor * ema and step_i > start_step + 2:
            stragglers += 1
            log(f"[watchdog] step {step_i} took {dt:.3f}s "
                f"({dt/ema:.1f}x EMA) — straggler #{stragglers}")
        ema = cfg.ema_decay * ema + (1 - cfg.ema_decay) * dt
        history.append(float(metrics["loss"]))
        if (step_i + 1) % cfg.log_every == 0:
            log(f"[loop] step {step_i+1} loss {float(metrics['loss']):.4f} "
                f"lr {float(metrics.get('lr', 0)):.2e} {dt*1e3:.0f}ms")
        if (step_i + 1) % cfg.ckpt_every == 0 or step_i + 1 == cfg.total_steps:
            ckpt.save(cfg.ckpt_dir, step_i + 1,
                      {"params": params, "opt": opt_state},
                      extra={"loss": history[-1], "stragglers": stragglers})
    return TrainState(params, opt_state, cfg.total_steps)
