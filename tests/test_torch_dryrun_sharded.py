"""The dry run of the cells run sharded (``launch/dryrun.py``), on the
CPU in one process: rank 0 of a fake group of 256 or 512 ranks runs the
cell's ``steps.sharded_step`` on fake DTensors under ``op_cost``'s
per-device count.

Gemma-3 1B ``train_4k`` at full size on 16x16 and the DeepSeek-V2-Lite
smoke ``prefill_32k`` on both meshes: a device's cost, its peak bytes and
its collectives by kind under the reference's key names, and the whole
step's cost under ``cost_step``; FM ``train_batch``, MeshGraphNet
``ogb_products`` and NequIP ``molecule`` at full size on 16x16, whose
rows are divided (a device's flops at most twice the step's over the
data-parallel devices, FM, or over every device, the GNNs); the bytes of
the DTensors' local shards equal ``argument_leaves``' per-device bytes
(which equal the reference's, ``tests/test_torch_dryrun.py``); the
``card`` record keeps its one-device fields and counts.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.lm_sharded import local_bytes  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402
from repro_torch.launch.op_cost import KINDS, analyze_step  # noqa: E402


def _assert_sharded(rec: dict) -> None:
    assert rec["status"] == "ok", rec.get("error")
    c = rec["collectives"]
    assert set(KINDS) <= set(c)
    for kind in KINDS:
        assert set(c[kind]) == {"count", "bytes"}
    assert c["total_bytes"] == sum(c[k]["bytes"] for k in KINDS) > 0
    assert c["total_count"] == sum(c[k]["count"] for k in KINDS) > 0
    assert rec["cost"]["scope"] == "device"
    assert rec["cost_step"]["scope"] == "step"
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]
    # a device does a share of the step's work, more than 1 / devices of
    # it where a tensor is replicated (Gemma's 4 heads over 16 devices)
    assert rec["cost"]["flops"] * rec["cost"]["devices"] >= \
        rec["cost_step"]["flops"]
    assert rec["cost"]["flops"] < rec["cost_step"]["flops"]


def test_gemma_train_record_on_pod16x16():
    """Gemma-3 1B train_4k (batch 256 over 16 data devices, 4 heads over
    16 model devices: 12 empty head shards) sharded: 2 x 26 flash
    launches and 26 backward ones on a device, one segment_reduce for the
    embedding's gradient, every collective counted."""
    rec = dryrun.record(get_arch("gemma3-1b"), "train_4k", "pod16x16")
    _assert_sharded(rec)
    k = rec["cost"]["by_kernel"]
    assert k["flash_attention"]["calls"] == 52
    assert k["flash_attention_bwd"]["calls"] == 26
    assert k["segment_reduce"]["calls"] == 1
    c = rec["collectives"]
    assert c["all-gather"]["count"] > 0 and c["reduce-scatter"]["count"] > 0
    assert c["all-reduce"]["count"] > 0


@pytest.mark.parametrize("mesh_name", ["pod16x16", "pod2x16x16"])
def test_deepseek_smoke_prefill_records(mesh_name):
    """DeepSeek-V2-Lite's smoke prefill (MLA, MoE with 8 experts over 16
    model devices, a batch of 2 over 16 or 32 data devices) sharded on
    both meshes."""
    arch = dryrun._arch("deepseek-v2-lite-16b", smoke=True)
    rec = dryrun.record(arch, "prefill_32k", mesh_name)
    _assert_sharded(rec)
    assert rec["cost"]["by_kernel"]["flash_attention"]["calls"] == 2


def test_fm_train_record_divides_the_batch():
    """FM train_batch (65,536 rows over 16 data devices, both tables' rows
    over all 256) sharded: one fm_interaction launch and one backward a
    device, a segment_reduce for each table's gradient, reduce-scatters
    and all-gathers of the lookup's rows; a device's flops at most twice
    the step's over the data-parallel devices."""
    rec = dryrun.record(get_arch("fm"), "train_batch", "pod16x16")
    _assert_sharded(rec)
    k = rec["cost"]["by_kernel"]
    assert k["fm_interaction"]["calls"] == k["fm_interaction_bwd"][
        "calls"] == 1
    assert k["segment_reduce"]["calls"] == 2
    c = rec["collectives"]
    assert c["reduce-scatter"]["count"] > 0 and c["all-gather"]["count"] > 0
    assert rec["cost"]["flops"] <= 2 * rec["cost_step"]["flops"] / 16


def test_gnn_records_divide_the_rows():
    """MeshGraphNet ogb_products (2,449,029 nodes, 61,859,140 edges, 15
    blocks) and NequIP molecule sharded on 16x16, node and edge rows over
    all 256 devices: segment_reduce launched as on one device (60 and 45
    a step), a device's flops at most twice the step's over the
    devices."""
    for arch_id, shape_name, sums in (("meshgraphnet", "ogb_products", 60),
                                      ("nequip", "molecule", 45)):
        rec = dryrun.record(get_arch(arch_id), shape_name, "pod16x16")
        _assert_sharded(rec)
        assert rec["cost"]["by_kernel"]["segment_reduce"]["calls"] == \
            rec["cost_step"]["by_kernel"]["segment_reduce"]["calls"] == sums
        assert rec["collectives"]["reduce-scatter"]["count"] > 0
        assert rec["cost"]["flops"] <= 2 * rec["cost_step"]["flops"] / 256


@pytest.mark.parametrize("arch_id,shape_name", [
    ("gemma3-1b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
    ("gemma3-1b", "long_500k")])
def test_local_shard_bytes_equal_argument_leaves(arch_id, shape_name):
    """The bytes of rank 0's DTensor shards of a cell's arguments equal
    the per-device bytes ``argument_leaves`` computes from the specs (the
    reference's leaves: the cache's length is a Python int here and an
    int32 there)."""
    arch = get_arch(arch_id)
    with fake_world(256):
        mesh = dryrun._mesh("pod16x16")
        with FakeTensorMode():
            cell = steps.build_cell(arch, shape_name, "cpu", mesh=mesh)
            args = steps.sharded_args(cell, mesh)
            leaves = steps.argument_leaves(cell, cell.in_specs, mesh)
    want = sum(x["device_bytes"] for x in leaves if x["port_only"] is False)
    ints = sum(4 for x in leaves if x["path"].endswith("len"))
    assert local_bytes(args) + ints == want


def test_card_record_unchanged():
    """The card record counts the whole step on one device as PR 18 did:
    no collectives, no cost_step, its cost the step's op_cost count."""
    arch = dryrun._arch("gemma3-1b", smoke=True)
    rec = dryrun.record(arch, "train_4k", "card")
    assert rec["status"] == "ok"
    assert "collectives" not in rec and "cost_step" not in rec
    assert rec["cost"]["scope"] == "step" and rec["cost"]["devices"] == 1
    arch = dataclasses.replace(arch)
    with FakeTensorMode():
        cell = steps.build_cell(arch, "train_4k", "cpu")
        want = analyze_step(cell.step_fn, *cell.args, track_memory=True)
    for key in ("flops", "bytes", "transcendentals", "flops_16bit",
                "by_kernel"):
        assert rec["cost"][key] == want[key], key
    assert rec["memory"]["peak_bytes"] == want["peak_bytes"]
    assert set(rec["bound"]) == {"s", "flops_s", "bytes_s", "by"}
