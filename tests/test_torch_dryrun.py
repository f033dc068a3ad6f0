"""The port's production meshes, sharding rules, ``constrain`` and
cost-counting dry run (``repro_torch.launch.mesh``, ``launch/sharding.py``,
``dist/constrain.py``, ``launch/dryrun.py``) against the reference's.

Every one of the reference's 36 cells is built on both production meshes
from a ``jax.sharding.AbstractMesh`` (no device, no compile) and on the
port's fake process group of 256 or 512 ranks: each leaf's spec and
per-device shape, the per-device argument bytes and the cells' meta must
be equal.  The dry run's CLI runs at smoke size on both meshes and on one
card; a fake step's count equals a real step's on the CPU, and a step of
many microbatches counts the same by extrapolation."""
import dataclasses
import json
import math
import os

import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.dist import constrain as jconstrain  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.sharding import _path_str as jax_path_str  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.dist import constrain  # noqa: E402
from repro_torch.launch import dryrun, sharding, steps  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    fake_world, make_production_mesh)
from repro_torch.launch.op_cost import analyze_step  # noqa: E402

LM = {a for a in ARCH_IDS if get_arch(a).family == "lm"}
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# per-device argument bytes of the reference's cells, read from its
# AbstractMesh builds
REFERENCE_BYTES = {
    ("pod16x16", "command-r-35b", "train_4k"): 1_191_411_716,
    ("pod2x16x16", "command-r-35b", "train_4k"): 1_191_149_572,
    ("pod16x16", "command-r-35b", "decode_32k"): 2_923_593_764,
    ("pod2x16x16", "command-r-35b", "decode_32k"): 1_581_416_468,
    ("pod16x16", "gemma3-1b", "train_4k"): 40_309_764,
    ("pod2x16x16", "gemma3-1b", "train_4k"): 40_047_620,
    ("pod16x16", "meshgraphnet", "ogb_products"): 27_486_284,
    ("pod2x16x16", "meshgraphnet", "ogb_products"): 24_491_316,
    ("pod16x16", "fm", "train_batch"): 5_926_928,
    ("pod2x16x16", "fm", "train_batch"): 5_599_248,
}
# a GNN batch's leaves that the reference does not have (steps.PORT_ONLY)
PLAN_LEAVES = {f"2/plan/{idx}/{f}" for idx in ("senders", "receivers")
               for f in ("index", "order", "ids", "counts")} | {
    f"2/plan/graph/{f}" for f in ("index", "order", "ids", "counts")}


def _axes(entry) -> tuple:
    """A spec entry as a tuple of axis names (PartitionSpec writes the
    1-tuple ('data',) as 'data')."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _reference_leaves(cell) -> dict:
    """'<arg>/<path>' -> (spec as axis tuples, shard shape, bytes) of every
    argument leaf of a reference cell."""
    out = {}
    for i, (args, shardings) in enumerate(zip(cell.args, cell.in_shardings)):
        leaves = jax.tree_util.tree_flatten_with_path(args)[0]
        specs = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(
                x, jax.sharding.NamedSharding))
        for (path, leaf), sh in zip(leaves, specs, strict=True):
            spec = tuple(sh.spec) + (None,) * (len(leaf.shape)
                                               - len(sh.spec))
            local = sh.shard_shape(leaf.shape)
            name = "/".join(x for x in (str(i), jax_path_str(path)) if x)
            out[name] = (tuple(_axes(e) for e in spec), tuple(local),
                         math.prod(local) * leaf.dtype.itemsize)
    return out


def _port_leaves(leaves) -> dict:
    return {x["path"]: (tuple(_axes(e) for e in x["spec"]),
                        x["shard_shape"], x["device_bytes"])
            for x in leaves if not x["port_only"]}


def test_sharding_matches_reference_on_every_cell():
    """All 36 cells on both meshes (and zero1 on the LM train cells): the
    same leaves with the same specs, shard shapes and per-device bytes, the
    same microbatches, model flops and parameter counts."""
    checked = 0
    for mesh_name, (shape, axes) in MESHES.items():
        amesh = jax.sharding.AbstractMesh(shape, axes)
        with fake_world(int(torch.tensor(shape).prod())):
            mesh = make_production_mesh(multi_pod=len(shape) == 3)
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == axes
            for arch_id in ARCH_IDS:
                arch = get_arch(arch_id)
                for name, sh in arch.shapes.items():
                    if sh is None:
                        continue
                    tunings = ([{}, {"zero1": True}]
                               if sh["kind"] == "train" and arch.family == "lm"
                               else [{}])
                    for tuning in tunings:
                        ref = jsteps.build_cell(jax_get_arch(arch_id), name,
                                                amesh, tuning=tuning)
                        with FakeTensorMode():
                            cell = steps.build_cell(arch, name, "cpu",
                                                    mesh=mesh, tuning=tuning)
                            leaves = steps.argument_leaves(
                                cell, steps.arg_specs(arch, cell, mesh,
                                                      tuning), mesh)
                        want, got = _reference_leaves(ref), _port_leaves(
                            leaves)
                        assert got == want, (mesh_name, arch_id, name)
                        only = {x["path"] for x in leaves if x["port_only"]}
                        assert only == (PLAN_LEAVES if arch.family == "gnn"
                                        else set()), (arch_id, name, only)
                        for key in ("microbatches", "model_flops",
                                    "param_count", "active_param_count"):
                            assert cell.meta.get(key) == ref.meta.get(key), \
                                (mesh_name, arch_id, name, key)
                        total = sum(v[2] for v in got.values())
                        key = (mesh_name, arch_id, name)
                        if key in REFERENCE_BYTES and not tuning:
                            assert total == REFERENCE_BYTES[key], key
                        checked += 1
    assert checked == 2 * (36 + 5)
    assert not dist.is_initialized()


def test_resolve_matches_reference():
    forms = (None, "batch", "data", "model", "pod", "absent",
             ("pod", "data"), ("data", "model"), ["pod", "model"],
             ("absent",), ("pod", "data", "model"))
    for mesh_axes in ({"data", "model"}, {"pod", "data", "model"},
                      {"model"}, {"data"}, set()):
        for axis in forms:
            assert constrain._resolve(axis, mesh_axes) == \
                jconstrain._resolve(axis, mesh_axes), (axis, mesh_axes)


def test_constrain_redistributes_a_dtensor():
    """On a 4-rank fake mesh ``constrain`` lays a DTensor out by logical
    names and leaves everything else alone; ``fake_world`` always takes
    its group down."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import compat_make_mesh

    with pytest.raises(ValueError):
        with fake_world(4):
            raise ValueError("inside")
    assert not dist.is_initialized()
    with fake_world(4):
        with pytest.raises(RuntimeError):
            with fake_world(2):
                pass
        mesh = compat_make_mesh((2, 2), ("data", "model"))
        x = distribute_tensor(torch.arange(32.0).reshape(8, 4), mesh,
                              [Replicate(), Replicate()])
        plain = torch.ones(8, 4)
        assert constrain.constrain(x, "batch", "model") is x  # no mesh
        with constrain.constraint_mesh(mesh):
            assert constrain.current_mesh() is mesh
            y = constrain.constrain(x, "batch", "model")
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert y.to_local().shape == (4, 2)
            z = constrain.constrain(x, None, ("pod", "data"))
            assert tuple(z.placements) == (Shard(1), Replicate())
            assert constrain.constrain(x, "batch") is x    # rank mismatch
            assert constrain.constrain(plain, "batch", "model") is plain
            assert sharding.placements(mesh, (("data", "model"), None)) == \
                (Shard(0), Shard(0))
            with pytest.raises(ValueError):
                sharding.placements(mesh, (("model", "data"), None))
        assert constrain.current_mesh() is None
    with fake_world(1):                      # a mesh of one device
        one = compat_make_mesh((1, 1), ("data", "model"))
        x = distribute_tensor(torch.ones(8, 4), one,
                              [Replicate(), Replicate()])
        with constrain.constraint_mesh(one):
            assert constrain.constrain(x, "batch", "model") is x
    assert not dist.is_initialized()


def test_dryrun_cli_at_smoke_size(tmp_path):
    """Both production meshes and the card: 36 ok and 4 skipped records a
    mesh, each with the reference's keys and no XLA-only one, exit 0; a
    cell on a mesh runs sharded (a device's cost, peak and collectives,
    the whole step's cost under cost_step) unless it is an LM train cell
    whose smoke batch its data-parallel devices do not divide."""
    out = str(tmp_path)
    assert dryrun.main(["--smoke", "--mesh", "both", "--out", out]) == 0
    assert dryrun.main(["--smoke", "--mesh", "card", "--out", out]) == 0
    assert not dist.is_initialized()
    assert sorted(os.listdir(out)) == ["card", "pod16x16", "pod2x16x16"]
    for mesh_name in os.listdir(out):
        recs = [json.load(open(os.path.join(out, mesh_name, f)))
                for f in sorted(os.listdir(os.path.join(out, mesh_name)))]
        status = [r["status"] for r in recs]
        assert (status.count("ok"), status.count("skipped")) == (36, 4)
        for r in recs:
            assert not {"compile_s", "temp_bytes", "alias_bytes"} & (
                set(r) | set(r.get("memory", {})))
            if r["status"] == "skipped":
                assert r["reason"]
                continue
            sharded = mesh_name != "card" and "sharded" not in r
            assert ("collectives" in r) == sharded == ("cost_step" in r)
            assert r["cost"]["scope"] == ("device" if sharded else "step")
            if sharded:
                assert r["collectives"]["total_count"] > 0
                assert r["memory"]["peak_bytes"] > 0
            elif mesh_name != "card":
                assert r["arch"] in LM and r["meta"]["kind"] == "train"
            assert r["cost"]["flops"] > 0 and r["cost"]["bytes"] > 0
            assert r["cost"]["devices"] == dryrun.devices(mesh_name)
            if r["meta"]["kind"] == "train" and r["arch"] in (
                    "gemma3-1b", "command-r-35b"):
                assert r["cost"]["by_kernel"]["flash_attention_bwd"][
                    "calls"] > 0
            if mesh_name == "card":
                assert 0 < r["memory"]["peak_bytes"] and \
                    r["memory"]["fits_card"]
                assert r["bound"]["s"] == max(r["bound"]["flops_s"],
                                              r["bound"]["bytes_s"])


def test_fake_count_equals_real_and_extrapolation(monkeypatch):
    """A step counted on fake tensors equals the same step counted on real
    CPU tensors (what the card run checks at full width); a step of 4
    microbatches counted from runs of 2 and 3 equals its direct count."""
    for arch_id, name in (("gemma3-1b", "train_4k"),
                          ("meshgraphnet", "full_graph_sm"),
                          ("fm", "train_batch"),
                          ("deepseek-v2-lite-16b", "train_4k")):
        arch = get_arch(arch_id)
        with FakeTensorMode():
            cell = steps.build_cell(arch, name, "cpu", smoke=True)
            fake = analyze_step(cell.step_fn, *cell.args)
        real = steps.build_cell(arch, name, "cpu", smoke=True)
        got = analyze_step(real.step_fn, *real.args)
        for key in ("flops", "bytes", "transcendentals", "by_kernel"):
            assert got[key] == fake[key], (arch_id, key)

    arch = get_arch("gemma3-1b")
    arch = dataclasses.replace(arch, config=arch.smoke, shapes={
        "train_4k": {"kind": "train", "seq": 32, "batch": 4}})
    monkeypatch.setattr(dryrun, "EXTRAPOLATE_ABOVE", 1 << 30)
    fake = FakeTensorMode()
    with fake:
        cell = steps.build_cell(arch, "train_4k", "cpu",
                                tuning={"microbatches": 4})
    direct = dryrun._count(arch, "train_4k", cell, fake, True)
    monkeypatch.setattr(dryrun, "EXTRAPOLATE_ABOVE", 3)
    line = dryrun._count(arch, "train_4k", cell, fake, True)
    assert line["microbatches_run"] == [2, 3]
    for key in ("flops", "bytes", "transcendentals", "flops_16bit",
                "by_kernel", "peak_bytes"):
        assert line[key] == direct[key], key
