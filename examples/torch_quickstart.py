"""Quickstart: partition a graph with the PyTorch/CUDA port of the Jet
partitioner.

    PYTHONPATH=src python examples/torch_quickstart.py [--k 8] [--graph grid] \
        [--device cuda|cpu]

``--device`` defaults to the card (``cuda``); ``cpu`` runs the kernels'
plain PyTorch versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.metrics import cutsize
from repro_torch.core.partition import PartitionConfig, partition
from repro_torch.data import graphs as gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="grid",
                    choices=["grid", "cube", "rmat", "geo"])
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--imbalance", type=float, default=0.03)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, needs a card) or cpu")
    args = ap.parse_args(argv)

    if args.graph == "grid":
        g = gen.grid2d(args.size, args.size)
    elif args.graph == "cube":
        g = gen.grid3d(args.size // 4, args.size // 4, args.size // 4)
    elif args.graph == "rmat":
        g = gen.rmat(scale=12)
    else:
        g = gen.random_geometric(args.size * args.size)

    print(f"graph: n={int(g.n)} m={int(g.m)//2} (undirected)")
    cfg = PartitionConfig(k=args.k, lam=args.imbalance)
    res = partition(g, cfg, device=args.device)

    print(f"k={args.k} lambda={args.imbalance} device={args.device}")
    print(f"  cutsize    : {res.cut}")
    print(f"  imbalance  : {res.imbalance:.4f} (balanced={res.balanced})")
    print(f"  levels     : {res.levels}")
    for name, t in res.times.items():
        print(f"  {name:<12}: {t:.3f}")
    # against a random assignment, for scale
    rng = np.random.default_rng(0)
    rand = torch.where(
        g.vertex_mask(),
        torch.from_numpy(rng.integers(0, args.k, g.n_max).astype(np.int32)),
        args.k)
    print(f"  random cut : {int(cutsize(g, rand))}  (for scale)")


if __name__ == "__main__":
    main()
