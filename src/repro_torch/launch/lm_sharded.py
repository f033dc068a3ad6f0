"""Registry cells (LM, FM, GNN) run as sharded programs across ranks of a
``torch.distributed`` group: one process a rank, each holding its blocks
of the parameters, optimizer state, batch and KV cache as DTensors on a
``DeviceMesh``.

    PYTHONPATH=src python -m repro_torch.launch.lm_sharded --arch gemma3-1b \\
        --shape train_4k --mesh 2 2 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.lm_sharded --arch fm \\
        --shape train_batch --mesh 2 2 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.lm_sharded \\
        --arch meshgraphnet --shape full_graph_sm --mesh 2 2 --smoke \\
        --device cpu

Each rank builds the cell with the mesh (``launch/steps.build_cell``: the
same seeded values on every rank, or the parameters it is given), lays its
inputs out by the cell's ``in_specs`` (``steps.sharded_args``) and runs
``steps.sharded_step`` once under ``CommDebugMode``; every rank returns
its collectives by kind, its regions (``dist/regions.py``), its kernels'
launches, the bytes of its argument shards, its step time and, on the
card, its peak memory.  :func:`predict` is the dry run's count of the same
step, and :func:`probe` checks which collectives a backend carries.
Backends are chosen as ``launch/gnn_partitioned.init_rank`` chooses them:
gloo on the CPU, NCCL on a card (one rank a card), gloo where named
(several ranks on one card).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import tree

def collective_counts(comm) -> dict:
    """A ``CommDebugMode``'s counts as {kind: count} under the reference's
    kind names (``op_cost.COLLECTIVES``; other ops under their own)."""
    from repro_torch.launch.op_cost import COLLECTIVES

    out: dict = {}
    for op, n in comm.get_comm_counts().items():
        name = getattr(op, "__name__", str(op)).split(".")[-1]
        kind = COLLECTIVES.get(name, name)
        out[kind] = out.get(kind, 0) + int(n)
    return out


def local_bytes(args) -> int:
    """Bytes of this rank's blocks of a tree of DTensors (plain tensors
    whole)."""
    from repro_torch.dist import regions

    return sum(regions.local(x).numel() * x.element_size()
               for x in tree.leaves(args) if isinstance(x, torch.Tensor))


def registry_cell(arch_id: str, shape_name: str, device, mesh,
                  smoke: bool = True, tuning: dict | None = None, params=None,
                  config: dict | None = None, shape: dict | None = None):
    """``steps.build_cell`` of a registry arch on ``mesh`` (None: one
    device); ``config`` replaces fields of the arch's config (its smoke
    config with ``smoke``), ``shape`` fields of the cell's shape, and
    ``params`` (numpy, the reference's layout) its parameters."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import convert

    arch = get_arch(arch_id)
    if smoke:
        arch = dataclasses.replace(arch, shapes=steps.smoke_shapes(arch),
                                   config=arch.smoke)
    if config:
        arch = dataclasses.replace(arch, config=dataclasses.replace(
            arch.config, **config))
    if shape:
        arch = dataclasses.replace(arch, shapes={
            **arch.shapes, shape_name: {**arch.shapes[shape_name], **shape}})
    if params is not None:
        params = {"lm": convert.lm_params, "recsys": convert.fm_params,
                  "gnn": convert.gnn_params}[arch.family](params, device)
    return steps.build_cell(arch, shape_name, device, params=params,
                            tuning=tuning, mesh=mesh)


def grads_of(cell, args):
    """The loss's gradient at the train cell's inputs ``args`` (DTensors
    on the cell's mesh, or plain tensors), laid out as the parameters."""
    from repro_torch.launch import steps
    from repro_torch.train.loop import value_and_grad

    (l, _), g = value_and_grad(cell.step_fn.loss, args[0], args[2])
    return l, steps._laid_out(g, args[0])


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


def against_one_device(job: dict, device, loss: float, grads) -> dict:
    """The loss and the gathered gradients of a sharded train step against
    the one-device cell of the same job on ``device``: the loss's
    relative difference and each leaf's relative L2."""
    from repro_torch.launch.sharding import _path_str

    cell = registry_cell(job["arch"], job["shape"], device, None,
                         job.get("smoke", True), job.get("tuning"),
                         job.get("params"), job.get("config"),
                         job.get("cell_shape"))
    l1, g1 = grads_of(cell, cell.args)
    rel = {_path_str(p): _rel_l2(g, w) for (p, w), g in zip(
        tree.flatten_with_path(g1), tree.leaves(grads))}
    return {"loss": loss, "one_device_loss": float(l1),
            "loss_rel": abs(loss - float(l1)) / max(abs(float(l1)), 1e-30),
            "grad_rel_l2": rel, "grad_rel_l2_max": max(rel.values())}


def predict(job: dict, world: int) -> dict:
    """The dry run's count of rank 0 of ``job``'s sharded step on a fake
    group of ``world`` ranks (``launch/dryrun.py``, on fake tensors on the
    host): its peak bytes and its collectives by kind."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import _analyze
    from repro_torch.launch.mesh import compat_make_mesh, fake_world

    with fake_world(world):
        mesh = compat_make_mesh(tuple(job["mesh"]), tuple(job["axes"]))
        with FakeTensorMode():
            cell = registry_cell(job["arch"], job["shape"], "cpu", mesh,
                                 job.get("smoke", True), job.get("tuning"),
                                 None, job.get("config"),
                                 job.get("cell_shape"))
            rec = _analyze(cell, mesh, True)
    return {"peak_bytes": rec["peak_bytes"],
            "collectives": {k: v["count"] for k, v in
                            rec["collectives"].items()
                            if isinstance(v, dict) and v["count"]},
            "collective_bytes": rec["collectives"]["total_bytes"]}


def rank_job(rank: int, world: int, device, job: dict) -> dict:
    """One rank of a sharded registry cell (for
    ``gnn_partitioned.spawn_ranks``): one step under ``CommDebugMode``.

    ``job``: ``arch``, ``shape``, ``mesh`` (its shape) and ``axes``;
    optional ``smoke`` (default True), ``tuning``, ``config``,
    ``cell_shape``, ``params`` (numpy, the reference's layout) and
    ``grads`` (a train cell's loss and gradient at its inputs, gathered;
    rank 0 holds them against the one-device cell's,
    :func:`against_one_device`)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import kernels
    from repro_torch.device import synchronize
    from repro_torch.dist import regions
    from repro_torch.dist.constrain import constraint_mesh
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import compat_make_mesh

    device = torch.device(device)
    mesh = compat_make_mesh(tuple(job["mesh"]), tuple(job["axes"]),
                            device.type)
    cell = registry_cell(job["arch"], job["shape"], device, mesh,
                         job.get("smoke", True), job.get("tuning"),
                         job.get("params"), job.get("config"),
                         job.get("cell_shape"))
    args = steps.sharded_args(cell, mesh)
    step = steps.sharded_step(cell, mesh)
    cell = cell._replace(args=())     # only this rank's blocks stay
    out = {"rank": rank, "arg_bytes": local_bytes(args)}
    if device.type == "cuda":
        synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        # bytes held besides the arguments' blocks (as chip_smoke (y))
        base = torch.cuda.memory_allocated(device) - out["arg_bytes"]
    kernels.reset_launch_counts()
    regions.region_calls.clear()
    with CommDebugMode() as comm:
        t0 = time.perf_counter()
        res = step(*args)
        synchronize(device)
        out["step_s"] = time.perf_counter() - t0
    del res
    out.update(collectives=collective_counts(comm),
               launches=dict(kernels.launch_counts),
               regions=dict(regions.region_calls))
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
    if job.get("grads") and cell.meta["kind"] == "train":
        with constraint_mesh(mesh), implicit_replication():
            l, g = grads_of(cell, args)
        del args
        g, l = sh.full(g), float(sh.full(l))
        if rank == 0:
            out["against_one_device"] = against_one_device(job, device, l, g)
    return out


# the redistribution of a (world, 8) tensor on a (world,) mesh that makes
# DTensor issue each collective of a sharded step
PROBES = {"all-gather": ("shard0", "replicate"),
          "reduce-scatter": ("partial", "shard0"),
          "all-to-all": ("shard0", "shard1"),
          "all-reduce": ("partial", "replicate")}


def probe_job(rank: int, world: int, device, kind: str) -> dict:
    """One rank of :func:`probe`: the redistribution of ``PROBES[kind]``
    on a one-axis mesh over every rank, its result checked."""
    from torch.distributed.tensor import (
        DTensor, Partial, Replicate, Shard, distribute_tensor)

    from repro_torch.launch.mesh import compat_make_mesh

    device = torch.device(device)
    mesh = compat_make_mesh((world,), ("data",), device.type)
    pl = {"partial": Partial(), "replicate": Replicate(),
          "shard0": Shard(0), "shard1": Shard(1)}
    src, dst = PROBES[kind]
    full = torch.arange(world * 8 * world, dtype=torch.float32,
                        device=device).reshape(world * 8, world)
    if src == "partial":
        x = DTensor.from_local(full / world, mesh, [pl[src]])
    else:
        x = distribute_tensor(full, mesh, [pl[src]], src_data_rank=None)
    y = x.redistribute(mesh, [pl[dst]]).full_tensor()
    return {"kind": kind, "equal": bool(torch.allclose(y, full))}


def probe(world: int, device="cuda", backend=None,
          timeout_s: float = 120.0, until_refused: bool = False) -> dict:
    """Whether the group carries each collective a sharded step issues
    (``PROBES``, in that order), each in a world of its own ranks (a
    collective that a backend refuses may end its processes): kind ->
    True, or the error; with ``until_refused`` the kinds after the first
    refusal are not tried."""
    from repro_torch.launch.gnn_partitioned import spawn_ranks

    out = {}
    for kind in PROBES:
        try:
            res = spawn_ranks(probe_job, world, (kind,), device=device,
                              backend=backend, timeout_s=timeout_s)
            out[kind] = all(r["equal"] for r in res) or "wrong result"
        except (RuntimeError, TimeoutError) as e:
            out[kind] = f"{type(e).__name__}: {str(e)[-600:]}"
        if until_refused and out[kind] is not True:
            break
    return out


def run(job: dict, world: int, device="cpu", backend=None,
        timeout_s: float = 600.0) -> list[dict]:
    """:func:`rank_job` on ``world`` spawned ranks; the results by rank."""
    from repro_torch.launch.gnn_partitioned import spawn_ranks

    return spawn_ranks(rank_job, world, (job,), device=device, backend=backend,
                       timeout_s=timeout_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", type=int, nargs="+", default=[2, 2],
                    help="the mesh's shape: (data, model) or (pod, data, "
                         "model)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config and shapes")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--probe", action="store_true",
                    help="only check which collectives the backend carries "
                         "(each in processes of its own)")
    args = ap.parse_args(argv)
    if args.probe:
        print(json.dumps(probe(int(np.prod(args.mesh)), args.device,
                               args.backend)), flush=True)
        return 0
    axes = ("data", "model") if len(args.mesh) == 2 else \
        ("pod", "data", "model")
    job = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           "axes": axes, "smoke": args.smoke,
           "tuning": {"zero1": True} if args.zero1 else None}
    world = int(np.prod(args.mesh))
    for r in run(job, world, args.device, args.backend):
        print(json.dumps(r, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
