"""Training launcher (counterpart of ``repro.launch.train``), for the GNNs.

    PYTHONPATH=src python -m repro_torch.launch.train --arch meshgraphnet \\
        --steps 200 --ckpt-dir ck [--device cuda|cpu]

The reference's flags, plus ``--device`` (default ``cuda``, which needs a
card).  Like the reference it trains the arch's smoke config at its smoke
shape (``--smoke`` is on and cannot be turned off) on one fixed synthetic
batch, through the fault-tolerant loop (checkpoints, resume, straggler
watchdog); full width is ``steps.build_cell(..., smoke=False)``.  LM and FM
training are not ported yet (ROADMAP.md, Queue 1): their ``--arch`` raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_cell, materialize_cell
from repro_torch.train import loop as train_loop


def make_data(cell, seed: int = 0):
    """GNN batches: one fixed synthetic batch, re-materialized from ``seed``
    (full-batch training), its edge plan built once."""
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
    if arch.family != "gnn":
        raise NotImplementedError(
            f"{args.arch}: LM and FM training are not ported yet; they wait "
            "for gradients through the serving-only attention and FM paths "
            "(ROADMAP.md, Queue 1)")
    shape = args.shape
    if shape == "train_4k":
        shape = "full_graph_sm"
    device = resolve_device(args.device)
    cell = build_cell(arch, shape, device, smoke=args.smoke)

    params, opt_state, _ = materialize_cell(cell, seed=args.seed)
    data = make_data(cell, seed=args.seed)

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
