"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 200 --ckpt-dir ck [--device cuda|cpu]

The reference's flags, plus ``--device`` (default ``cuda``, which needs a
card).  Like the reference it trains the arch's smoke config at its smoke
shape (``--smoke`` is on and cannot be turned off) through the
fault-tolerant loop (checkpoints, resume, straggler watchdog): an LM on a
stream of synthetic token batches, FM on a stream of click batches, a GNN
on one fixed synthetic batch.  Full width is ``steps.build_cell(...,
smoke=False)``.  Every arch of the registry trains.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_cell, materialize_cell
from repro_torch.train import loop as train_loop


def make_data(arch, cell, smoke: bool, seed: int = 0, device="cpu"):
    """Batch iterator matched to the cell's batch, made on ``device``: LM
    token batches, FM click batches, or one fixed GNN batch re-materialized
    from ``seed`` (full-batch training), its edge plan built once."""
    cfg = arch.smoke if smoke else arch.config
    batch = cell.args[2]
    if arch.family == "lm":
        b, s = batch["tokens"].shape
        return synthetic.lm_batches(cfg.vocab, b, s, seed, device)
    if arch.family == "recsys":
        return synthetic.recsys_batches(cfg.n_fields, cfg.rows_per_field,
                                        batch["ids"].shape[0], seed, device)
    fixed = materialize_cell(cell, seed=seed)[2]

    def gen():
        while True:
            yield fixed

    return gen()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, needs a card) or cpu")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    shape = args.shape
    if arch.family == "gnn" and shape == "train_4k":
        shape = "full_graph_sm"
    if arch.family == "recsys" and shape == "train_4k":
        shape = "train_batch"
    device = resolve_device(args.device)
    cell = build_cell(arch, shape, device, smoke=args.smoke)
    if cell.meta["kind"] != "train":
        raise ValueError(f"{args.arch} {shape} is a {cell.meta['kind']} "
                         "shape: use launch/serve.py for inference shapes")

    params, opt_state, _ = materialize_cell(cell, seed=args.seed)
    data = make_data(arch, cell, args.smoke, seed=args.seed, device=device)

    def step(params, opt_state, err, batch):
        p, o, m = cell.step_fn(params, opt_state, batch)
        return p, o, err, m

    lc = train_loop.TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, resume=True, log_every=10,
        compress_grads=args.compress_grads)
    st = train_loop.TrainState(params, opt_state, 0)
    final = train_loop.run(lc, st, step, data)
    print(f"[train] finished at step {final.step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
