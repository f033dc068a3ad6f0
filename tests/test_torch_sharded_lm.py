"""The port's LM cells run as sharded programs (``launch/steps.py``
``sharded_step``) against the reference and the one-device port, on the
CPU.

Four gloo ranks (``launch/gnn_partitioned.spawn_ranks``) hold the smoke
configs of gemma3-1b (GQA, 5:1 local:global) and deepseek-v2-lite-16b (MLA
and MoE, every routed expert drawn on its own) on a (2, 2) ("data",
"model") mesh: a train step with and without ZeRO-1, a prefill and a
decode step on the prefill's cache (``tests/sharded_cases.py``; the ranks
import no JAX).  The parameters are the reference's, carried across with
``models/convert.py``.  Tolerances (float32): the train step's loss and
grad_norm within 1e-5 relative of the reference's cell, the parameters
after one AdamW step rtol = 2e-5, atol = 1e-6 (``test_torch_lm_train``);
prefill logits, the decode step's logits and the caches within 1e-5
relative L2 of the one-device port.  On a one-rank mesh every output is
bit for bit the one-device cell's, and a checkpoint saved from the (2, 2)
mesh restores onto one device (and onto the mesh) leaf for leaf.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sharded_cases as cases  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.launch import lm_sharded, steps  # noqa: E402
from repro_torch.launch.gnn_partitioned import spawn_ranks  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ARCHS = ("gemma3-1b", "deepseek-v2-lite-16b")
TOL = dict(rtol=2e-5, atol=1e-6)
RTOL = 1e-5
J_INIT = jax.jit(jtf.init_params, static_argnums=0)
_RUNS: dict = {}


def _np_params(arch_id: str, seed: int = 7) -> dict:
    """The reference's smoke parameters as numpy, every routed expert and
    the router drawn anew (its moe_init makes a layer's experts equal)."""
    p = jax.tree.map(np.asarray, J_INIT(jax_get_arch(arch_id).smoke,
                                        jax.random.key(seed)))
    m = p["layers"].get("moe")
    if m is not None:
        rng = np.random.default_rng(seed)
        for name in ("w_gate", "w_up", "w_down"):
            s = 1 / np.sqrt(m[name].shape[-2])
            m[name] = rng.uniform(-s, s, m[name].shape).astype(np.float32)
        m["router"] = rng.standard_normal(m["router"].shape).astype(
            np.float32)
    return p


def _runs(arch_id: str, tmp_path_factory) -> dict:
    """The (2, 2) mesh's outputs of ``arch_id`` (once a process)."""
    if arch_id not in _RUNS:
        params = _np_params(arch_id)
        job = {"arch": arch_id, "params": params,
               "ckpt": str(tmp_path_factory.mktemp(f"ck_{arch_id}"))}
        res = spawn_ranks(cases.lm_world, 4, (job,), device="cpu",
                          timeout_s=240)
        _RUNS[arch_id] = dict(res[0], params=params, ckpt=job["ckpt"],
                              on_mesh=[r["restored_on_mesh"] for r in res])
    return _RUNS[arch_id]


def _one_device(arch_id: str, params, mesh=None) -> dict:
    """The one-device cells' outputs (or, with a mesh, the sharded ones) in
    the order of the sharded run: train, train_zero1, prefill, decode."""
    out, cache = {}, None
    for name, shape, tuning in cases.LM_CELLS + (("decode", "decode_32k",
                                                  None),):
        cell = lm_sharded.registry_cell(arch_id, shape, "cpu", mesh,
                                        tuning=tuning, params=params)
        if mesh is None:
            args, step = cell.args, cell.step_fn
        else:
            args, step = (steps.sharded_args(cell, mesh),
                          steps.sharded_step(cell, mesh))
        if name == "decode":
            args = (args[0], cache, args[2])
        res = step(*args)
        if name == "prefill":
            cache = res[1]
        full = res if mesh is None else tree.tree_map(
            lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x,
            res)
        out[name] = tree.tree_map(
            lambda x: x.detach().clone() if isinstance(x, torch.Tensor)
            else x, full)
    return out


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_sharded_cells_match_reference_and_one_device(arch_id,
                                                      tmp_path_factory):
    """On the (2, 2) mesh (one spawn of 4 ranks a process and arch): one
    train step, plain and ZeRO-1, against the reference's train cell on
    the same parameters and batch (loss, grad_norm, the parameters after
    one AdamW step); the prefill's last-token logits and cache, and a
    decode step on that cache (sequence sharded over "model"), against
    the one-device port; the regions and collectives that ran.  Gemma's
    train step's parameters, saved from the mesh (rank 0 writes the
    gathered leaves), restore onto one device equal to the gathered
    parameters, and onto the mesh with their placements."""
    runs = _runs(arch_id, tmp_path_factory)
    jparams = jax.tree.map(jnp.asarray, runs["params"])
    cell = lm_sharded.registry_cell(arch_id, "train_4k", "cpu", None,
                                    params=runs["params"])
    batch = {k: jnp.asarray(v.numpy()) for k, v in cell.args[2].items()}
    jcell = jsteps.build_cell(jax_get_arch(arch_id), "train_4k",
                              make_host_mesh(), smoke=True)
    want = jax.jit(jcell.step_fn)(jparams, jadamw.init_state(jparams), batch)
    for name in ("train", "train_zero1"):
        got = runs[name]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[2][key]),
                                       float(want[2][key]), rtol=RTOL,
                                       err_msg=f"{name} {key}")
        for g, w in zip(tree.leaves(got[0]), jax.tree.leaves(want[0])):
            np.testing.assert_allclose(g, np.asarray(w), **TOL,
                                       err_msg=name)
    one = _one_device(arch_id, runs["params"])
    for name in ("prefill", "decode"):
        got = runs[name]
        w_logits, w_cache = one[name]
        assert _rel_l2(got[0], w_logits.numpy()) <= RTOL, name
        for key, w in w_cache.items():
            if isinstance(w, torch.Tensor):
                assert _rel_l2(got[1][key], w.float().numpy()) <= RTOL, \
                    (name, key)
            else:
                assert got[1][key] == w
    regions = set(runs["regions"])
    assert {"embedding", "flash_attention", "vocab_parallel_ce",
            "sorted_index", "rows", "segment_reduce",
            "cache_write"} <= regions
    moe = {"moe_dispatch", "moe_experts", "moe_combine"}
    assert (moe <= regions) == (arch_id != "gemma3-1b")
    assert runs["collectives"].get("all-gather", 0) > 0
    assert all(runs["on_mesh"])
    step = ckpt.latest_step(runs["ckpt"])
    assert step == 1
    back = ckpt.restore(runs["ckpt"], step, {"params": cell.args[0]})
    for g, w in zip(tree.leaves(back["params"]),
                    tree.leaves(runs["train"][0])):
        np.testing.assert_array_equal(g.numpy(), w)
    assert ckpt.read_manifest(runs["ckpt"], step)["process_count"] == 1


@pytest.mark.parametrize("arch_id", ARCHS)
def test_one_rank_mesh_is_bitwise_the_one_device_cell(arch_id):
    """On a (1, 1) mesh (one gloo rank, this process) the sharded train
    steps, prefill and decode give the one-device cells' outputs bit for
    bit."""
    import torch.distributed as dist

    from repro_torch.launch.gnn_partitioned import free_port
    from repro_torch.launch.mesh import compat_make_mesh

    params = _np_params(arch_id)
    want = _one_device(arch_id, params)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        got = _one_device(arch_id, params,
                          compat_make_mesh((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()
    for name in want:
        for g, w in zip(tree.leaves(got[name]), tree.leaves(want[name])):
            if isinstance(w, torch.Tensor):
                assert torch.equal(g, w), name
            else:
                assert g == w, name


def test_sharded_cells_carry_the_reference_specs():
    """A cell built with a mesh carries in_specs (arg_specs) and out_specs
    (train: params and opt state as the inputs; prefill: the logits' and
    the cache's; decode: (dp or None, "model")); without one, none."""
    from repro_torch.launch.mesh import fake_world, make_host_mesh as mhm

    with fake_world(4):
        mesh = mhm(model_axis=2)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            cell = lm_sharded.registry_cell("gemma3-1b", shape, "cpu", mesh)
            assert cell.in_specs is not None and cell.out_specs is not None
            if shape == "train_4k":
                assert cell.out_specs[:2] == cell.in_specs[:2]
                assert cell.out_specs[2] is None
            else:   # the logits' spec; decode: a batch of 2 over 2 devices
                assert cell.out_specs[0] == (("data",), "model")
    assert lm_sharded.registry_cell("gemma3-1b", "train_4k", "cpu",
                                    None).in_specs is None
