"""Several ranks on one card: the ``gloo_host`` process group
(``repro_torch/dist/host_group.py``), which stages every collective through
host memory, on the CPU; ``init_rank``'s choice of backend; and the dry
run's count of a shard-to-shard redistribution as the all-to-all a card's
mesh issues.

Four spawned ranks on ``gloo_host`` (CPU tensors, where the staging is a
plain copy; ``tests/sharded_cases.host_group_world``): every collective
form the group carries gives the values it must (uneven all-to-all splits
included), send raises, and the four redistributions of
``lm_sharded.PROBES`` come back equal; one step of the FM ``train_batch``
smoke cell on a (2, 2) mesh gives the loss, grad_norm and parameters of
the same step on plain gloo bit for bit.  No JAX here.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import sharded_cases as cases  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.dist import host_group  # noqa: E402
from repro_torch.launch import gnn_partitioned as gp  # noqa: E402
from repro_torch.launch import lm_sharded  # noqa: E402


@pytest.fixture(scope="module")
def staged():
    return gp.spawn_ranks(cases.host_group_world, 4, (
        {"forms": True},), device="cpu", backend=host_group.BACKEND,
        timeout_s=240)


def test_carries_every_form_and_probe(staged):
    for r in staged:
        assert r["backend"] == host_group.BACKEND
        assert all(r["forms"].values()), r["forms"]
        assert r["probes"] == {k: True for k in lm_sharded.PROBES}


def test_fm_step_bitwise_equal_to_gloo(staged):
    plain = gp.spawn_ranks(cases.host_group_world, 4, ({},), device="cpu",
                           timeout_s=240)
    assert plain[0]["backend"] == "gloo"
    got, want = staged[0]["fm"], plain[0]["fm"]
    assert got["loss"] == want["loss"]
    assert got["grad_norm"] == want["grad_norm"]
    for a, b in zip(tree.leaves(got["params"]), tree.leaves(want["params"])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("device,backend,want", [
    ("cpu", None, "gloo"),
    ("cpu", host_group.BACKEND, host_group.BACKEND),
    ("cuda:0", None, ValueError)])
def test_init_rank_takes_gloo_host_only_when_named(device, backend, want):
    """One rank: the CPU's default is gloo, gloo_host only when named; on a
    CUDA device the default is NCCL, which refuses more ranks than cards
    (none here) and names gloo_host without falling back to it."""
    logs = []
    if want is ValueError:
        with pytest.raises(ValueError, match=host_group.BACKEND):
            gp.init_rank(0, 2, gp.free_port(), device, backend,
                         log=lambda *a, **k: logs.append(a))
        assert not dist.is_initialized()
        return
    try:
        got = gp.init_rank(0, 1, gp.free_port(), device, backend,
                           timeout_s=30, log=lambda *a, **k: logs.append(a))
        assert got == want == dist.get_backend()
        assert f"backend {want}" in logs[0][0]
        x = torch.arange(4.)
        dist.all_reduce(x)
        assert torch.equal(x, torch.arange(4.))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_dry_run_counts_shard_to_shard_as_all_to_all():
    """Shard(0) -> Shard(1) of a (32, 8) float32 tensor on a fake world of
    4 ranks (a host mesh, where DTensor itself would all-gather and
    chunk): one all-to-all of the (8, 2) result, no all-gather."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import compat_make_mesh, fake_world
    from repro_torch.launch.op_cost import analyze_step

    with fake_world(4):
        mesh = compat_make_mesh((4,), ("data",))
        with FakeTensorMode():
            x = distribute_tensor(torch.zeros(32, 8), mesh, [Shard(0)],
                                  src_data_rank=None)
            c = analyze_step(lambda t: t.redistribute(mesh, [Shard(1)]), x,
                             per_device=True)["collectives"]
    assert c["all-to-all"] == {"count": 1, "bytes": 32 * 2 * 4}
    assert c["all-gather"]["count"] == 0 and c["total_count"] == 1
