"""Dry run of every (arch x shape x mesh) cell on fake tensors
(counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card \\
        --arch gemma3-1b --shape train_4k

The reference lowers and compiles each cell for 512 fake XLA devices.  The
port builds each cell (``launch/steps.build_cell``) under
``FakeTensorMode`` on the CPU, its mesh over a fake process group of 256
or 512 ranks (``launch/mesh.fake_world``), and runs its step once under
``launch/op_cost.OpCost``, which counts every op as it runs.  Nothing is
allocated and no device is needed.  One JSON record per cell goes to
``<out>/<mesh>/<arch>__<shape>.json``, under the reference's key names
where the quantity is the same:

* ``arch``, ``shape``, ``mesh``, ``status`` (ok, skipped, error),
  ``reason`` (of a skip), ``error``/``traceback``, ``meta`` (the cell's),
  ``total_s``;
* ``memory.argument_bytes``: per device, the bytes of the argument leaves
  that the reference has, by their specs (``launch/sharding.py``);
  ``memory.port_only_bytes``: per device, by path, the leaves it has not
  (a GNN batch's edge plan, ``steps.PORT_ONLY``);
* ``cost.flops``, ``cost.transcendentals``, ``cost.bytes``: the counts of
  ``op_cost``, with ``cost.by_kernel`` (each hand-written kernel's calls
  and cost, by its formula), ``cost.flops_16bit`` (flops of ops on 16-bit
  inputs), ``cost.model_flops_ratio`` (counted flops over
  ``meta.model_flops``, a device's times the devices where ``cost`` is a
  device's) and ``cost.devices``.  ``cost.scope`` says whose they are:
  ``"device"`` for the LM, FM and GNN cells on a production mesh, which
  run sharded (``steps.sharded_step`` on rank 0 of the fake group,
  counted with ``op_cost``'s ``per_device``: the ops on that rank's
  shards), ``"step"`` for the whole step on one device (the card, and a
  record that is not run sharded).  A cell on a mesh keeps the whole
  step's counts under ``cost_step``;
* cells on a mesh: ``memory.peak_bytes``, the most bytes one device
  holds at once in the sharded run (its argument shards included), and
  ``collectives``: ``{kind: {count, bytes}}`` for all-reduce, all-gather,
  reduce-scatter, all-to-all and collective-permute (the bytes of each
  collective's result on that device, as the reference counts them), with
  ``total_bytes`` and ``total_count``.  An LM train cell whose batch its
  data-parallel devices do not divide (the smoke shapes') is not run
  sharded; its record says why under ``sharded``.  An FM serve batch that
  they do not divide (the smoke ``serve_p99``: 16 over 32) runs sharded,
  fm_interaction's rule replicating its rows.

The mesh ``card`` is one H100: no mesh, the one-device microbatch rule.
Its record adds ``memory.peak_bytes`` (the most bytes live at once in the
fake run, inputs included), ``memory.fits_card`` (against 80 GB) and
``bound``: the larger of the flops over the H100 SXM data sheet's rates
(16-bit flops at the bf16 tensor cores' 989 TFLOP/s, the rest at float32's
67 TFLOP/s) and the bytes over its 3.35 TB/s.

A train step of more than ``EXTRAPOLATE_ABOVE`` microbatches (the card's
LM cells: up to 256) is counted from two runs of the same step at 2 and 3
microbatches of the same size: every microbatch dispatches the same ops,
so the count is linear in their number and the line through the two is
exact (``cost.microbatches_run``); its peak is the 2-microbatch run's plus
the larger token batch.

Skipped cells (a ``None`` shape) are recorded as ``skipped`` with the
reason, as the reference records them; the run exits 1 on any ``error``.
The reference's XLA-only keys (``compile_s``, ``temp_bytes``,
``alias_bytes``) have no counterpart and are not written.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from contextlib import nullcontext
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

MESHES = {"single": ["pod16x16"], "multi": ["pod2x16x16"],
          "both": ["pod16x16", "pod2x16x16"], "card": ["card"]}
# NVIDIA H100 SXM data sheet
CARD_BYTES = 80e9
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
EXTRAPOLATE_ABOVE = 5


def mesh_axis_sizes(mesh_name: str) -> dict:
    """Axis name -> size of a production mesh (``launch/mesh.py``); ``{}``
    for the card."""
    from repro_torch.launch.mesh import PRODUCTION_MESHES

    if mesh_name == "card":
        return {}
    shape, axes = PRODUCTION_MESHES[mesh_name]
    return dict(zip(axes, shape))


def devices(mesh_name: str) -> int:
    """The devices of a mesh (1 for the card)."""
    return math.prod(mesh_axis_sizes(mesh_name).values())


def _mesh(mesh_name: str):
    from repro_torch.launch.mesh import make_production_mesh

    return None if mesh_name == "card" else make_production_mesh(
        multi_pod=mesh_name == "pod2x16x16")


def _with_batch(arch, shape_name: str, batch: int):
    shape = dict(arch.shapes[shape_name], batch=batch)
    return dataclasses.replace(arch, shapes={**arch.shapes,
                                             shape_name: shape})


def _analyze(cell, mesh, track_memory: bool) -> dict:
    """op_cost's count of one step of ``cell``: the whole step, or with a
    ``mesh`` one device's share of the sharded step."""
    from repro_torch.launch import steps
    from repro_torch.launch.op_cost import analyze_step

    if mesh is None:
        return analyze_step(cell.step_fn, *cell.args,
                            track_memory=track_memory)
    return analyze_step(steps.sharded_step(cell, mesh),
                        *steps.sharded_args(cell, mesh),
                        track_memory=track_memory, per_device=True)


def _count(arch, shape_name: str, cell, fake, track_memory: bool,
           mesh=None) -> dict:
    """op_cost's count of one step of ``cell``, built in the FakeTensorMode
    ``fake`` (by extrapolation above ``EXTRAPOLATE_ABOVE`` microbatches,
    see the module); with a ``mesh`` (a cell built with it), one device's
    share of the sharded step."""
    from repro_torch.launch import steps

    mb = cell.meta.get("microbatches", 1)
    if mb <= EXTRAPOLATE_ABOVE:
        with fake:
            return _analyze(cell, mesh, track_memory)
    per_mb = cell.args[2]["tokens"].shape[0] // mb
    runs = []
    for k in (2, 3):
        with fake:
            small = steps.build_cell(
                _with_batch(arch, shape_name, per_mb * k), shape_name, "cpu",
                tuning={"microbatches": k}, mesh=mesh)
            runs.append((small, _analyze(small, mesh, track_memory)))
    (c2, r2), (_, r3) = runs

    def line(a, b):
        return a + (mb - 2) * (b - a)

    out = dict(r2)
    for key in ("flops", "transcendentals", "bytes", "ops", "flops_16bit"):
        out[key] = line(r2[key], r3[key])
    out["by_kernel"] = {
        name: {k: line(v, r3["by_kernel"][name][k]) for k, v in c.items()}
        for name, c in r2["by_kernel"].items()}
    if "collectives" in r2:
        out["collectives"] = {
            k: ({f: line(v[f], r3["collectives"][k][f]) for f in v}
                if isinstance(v, dict) else line(v, r3["collectives"][k]))
            for k, v in r2["collectives"].items()}
    out["microbatches_run"] = [2, 3]
    if track_memory:
        tokens = cell.args[2]["tokens"]
        devs = 1 if mesh is None else steps._dp_size(mesh)
        out["peak_bytes"] = r2["peak_bytes"] + 2 * (
            tokens.numel() - c2.args[2]["tokens"].numel()) * 4 // devs
    return out


def microbatches(arch, shape_name: str, mesh_name: str):
    """A cell's microbatch count on ``mesh_name`` (None but for LM train
    cells), by ``steps.lm_microbatches`` without building the cell."""
    from repro_torch.launch.mesh import dp_size
    from repro_torch.launch.steps import lm_microbatches

    shape = arch.shapes[shape_name]
    if arch.family != "lm" or shape is None or shape["kind"] != "train":
        return None
    return lm_microbatches(arch.config, shape["batch"], shape["seq"], {},
                           dp_size(mesh_axis_sizes(mesh_name)))


def records(arch, shape_name: str, mesh_names) -> list[dict]:
    """The records of ``arch`` (an Arch, its shapes possibly replaced) at
    ``shape_name`` on each of ``mesh_names``, built and counted on fake
    tensors.  A step's work depends on the mesh only through its
    microbatch count, so the step is counted once for each count (and once
    more with the live bytes tracked on the card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import fake_world

    out, counted = [], {}
    for mesh_name in mesh_names:
        rec = {"arch": arch.id, "shape": shape_name, "mesh": mesh_name,
               "status": "ok"}
        out.append(rec)
        t0 = time.perf_counter()
        if arch.shapes[shape_name] is None:
            rec["status"] = "skipped"
            rec["reason"] = arch.skip_notes.get(shape_name, "skipped")
            continue
        n_dev = devices(mesh_name)
        try:
            with (fake_world(n_dev) if n_dev > 1 else nullcontext()):
                mesh = _mesh(mesh_name)
                fake = FakeTensorMode()
                with fake:
                    cell = steps.build_cell(arch, shape_name, "cpu",
                                            mesh=mesh)
                    specs = (None if mesh is None else
                             steps.arg_specs(arch, cell, mesh))
                    leaves = steps.argument_leaves(cell, specs, mesh)
            card = mesh is None
            key = (cell.meta.get("microbatches"), card)
            if key not in counted:
                counted[key] = _count(arch, shape_name, cell, fake, card)
            cost = dict(counted[key])
            rec["memory"] = {
                "argument_bytes": sum(x["device_bytes"] for x in leaves
                                      if not x["port_only"]),
                "port_only_bytes": {x["path"]: x["device_bytes"]
                                    for x in leaves if x["port_only"]}}
            peak = cost.pop("peak_bytes", None)
            rec["cost"] = _cost(cost, n_dev, 1, cell.meta, "step")
            rec["meta"] = cell.meta
            if card:
                rec["memory"].update(peak_bytes=peak,
                                     fits_card=peak <= CARD_BYTES)
                rec["bound"] = card_bound(cost)
            elif cell.in_specs is not None and _uneven_train(cell, mesh):
                rec["sharded"] = _uneven_train(cell, mesh)
            elif cell.in_specs is not None:   # run it sharded
                with fake_world(n_dev):
                    mesh = _mesh(mesh_name)
                    with fake:
                        cell = steps.build_cell(arch, shape_name, "cpu",
                                                mesh=mesh)
                    dev = _count(arch, shape_name, cell, fake, True, mesh)
                rec["cost_step"] = rec["cost"]
                rec["memory"]["peak_bytes"] = dev.pop("peak_bytes")
                rec["collectives"] = dev.pop("collectives")
                rec["cost"] = _cost(dev, n_dev, n_dev, cell.meta, "device")
        except Exception as e:  # a failed cell is a bug — record it loudly
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
        rec["total_s"] = time.perf_counter() - t0
    return out


def _uneven_train(cell, mesh) -> str | None:
    """Why an LM train cell is not run sharded, or None: a batch that its
    data-parallel devices do not divide (the smoke shapes' 2 rows over 16
    or 32) is replicated by ``constrain``, and DTensor's backward then
    shards products over the idle data axes in strided shards that its
    propagation cannot follow on fake tensors.  Every full-size cell's
    batch divides."""
    from repro_torch.launch import steps

    if cell.meta["kind"] != "train" or "tokens" not in cell.args[2]:
        return None
    batch, n_dp = cell.args[2]["tokens"].shape[0], steps._dp_size(mesh)
    if batch % n_dp == 0:
        return None
    return (f"not run sharded: a batch of {batch} over {n_dp} "
            f"data-parallel devices")


def _cost(counts: dict, n_dev: int, share: int, meta: dict,
          scope: str) -> dict:
    """A record's ``cost``: ``counts`` (of one device's share of the step
    when ``share`` is the devices, else the whole step) with the devices,
    the scope and the counted flops over the model's."""
    mf = meta["model_flops"]
    return dict(counts, devices=n_dev, scope=scope, model_flops_ratio=(
        counts["flops"] * share / mf if mf else None))


def record(arch, shape_name: str, mesh_name: str) -> dict:
    """:func:`records` on one mesh."""
    return records(arch, shape_name, [mesh_name])[0]


def _arch(arch_id: str, smoke: bool):
    """A registry arch; with ``smoke``, its smoke config at the smoke
    shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    arch = get_arch(arch_id)
    if smoke:
        arch = dataclasses.replace(arch, shapes=steps.smoke_shapes(arch),
                                   config=arch.smoke)
    return arch


def run_cell(arch_id: str, shape_name: str, mesh_names, out_dir: str,
             smoke: bool = False) -> list[dict]:
    """:func:`records` of a registry cell, each written under
    ``out_dir``."""
    recs = records(_arch(arch_id, smoke), shape_name, mesh_names)
    for rec in recs:
        _write(out_dir, rec)
    return recs


def card_bound(cost: dict) -> dict:
    """The least time one H100 could take for ``cost``: the larger of its
    flops over the data sheet's rates (16-bit at 989 TFLOP/s, the rest at
    67) and its bytes over 3.35 TB/s."""
    flops_s = (cost["flops_16bit"] / BF16_FLOPS_PER_S
               + (cost["flops"] - cost["flops_16bit"]) / F32_FLOPS_PER_S)
    bytes_s = cost["bytes"] / HBM_BYTES_PER_S
    return {"s": max(flops_s, bytes_s), "flops_s": flops_s,
            "bytes_s": bytes_s,
            "by": "operations" if flops_s >= bytes_s else "bytes"}


def _write(out_dir, rec):
    d = os.path.join(out_dir, rec["mesh"])
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{rec['arch']}__{rec['shape']}.json"),
              "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _passes(arch, shape_name: str, mb) -> int:
    """A rough measure of the ops that counting a cell dispatches: the
    config's layers times the forward and backward passes over the
    microbatches actually run (see :func:`_count`)."""
    shape = arch.shapes[shape_name]
    if shape is None:
        return 0
    runs = 1 if mb is None else (mb if mb <= EXTRAPOLATE_ABOVE else 2 + 3)
    passes = 3 if shape["kind"] == "train" else 1
    return getattr(arch.config, "n_layers", 1) * runs * passes


def _tasks(archs, shape, meshes, smoke) -> list[tuple]:
    """(arch, shape, meshes) groups: a cell's meshes with one microbatch
    count, the most passes (:func:`_passes`) first, so that a pool of
    workers ends together."""
    out = []
    for arch_id in archs:
        arch = _arch(arch_id, smoke)
        for name in (list(arch.shapes) if shape == "all" else [shape]):
            groups: dict = {}
            for mesh_name in meshes:
                groups.setdefault(microbatches(arch, name, mesh_name),
                                  []).append(mesh_name)
            out += [(-_passes(arch, name, mb), arch_id, name, g)
                    for mb, g in groups.items()]
    return [t[1:] for t in sorted(out, key=lambda t: t[0])]


def _line(rec) -> str:
    extra = ""
    if rec["status"] == "ok":
        c = rec["cost"]
        extra = (f"arg/dev {rec['memory']['argument_bytes']} B "
                 f"flops {c['flops']:.4e} bytes {c['bytes']:.4e} "
                 f"x model {c['model_flops_ratio']}")
        if "bound" in rec:
            extra += (f" peak {rec['memory']['peak_bytes']} B "
                      f"bound {rec['bound']['s']:.4g} s")
    elif rec["status"] == "error":
        extra = rec["error"][:200]
    else:
        extra = rec.get("reason", "")
    return (f"[{rec['status']}] {rec['mesh']} {rec['arch']} {rec['shape']} "
            f"{extra}")


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=list(MESHES))
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs and shapes (a test's size)")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells counted at once, one process each")
    args = ap.parse_args(argv)
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    tasks = _tasks(archs, args.shape, MESHES[args.mesh], args.smoke)
    t0 = time.perf_counter()
    recs = []

    def show(group):
        for rec in group:
            print(_line(rec), flush=True)
        recs.extend(group)

    if args.workers > 1:
        with ProcessPoolExecutor(args.workers,
                                 mp_context=get_context("spawn")) as pool:
            for fut in [pool.submit(run_cell, *t, args.out, args.smoke)
                        for t in tasks]:
                show(fut.result())
    else:
        for t in tasks:
            show(run_cell(*t, args.out, args.smoke))
    failures = sum(r["status"] == "error" for r in recs)
    counts = {s: sum(r["status"] == s for r in recs)
              for s in ("ok", "skipped", "error")}
    print(f"done in {time.perf_counter() - t0:.1f} s: {counts}; "
          f"{failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
