"""The port's GNN training against the JAX package, on the CPU: AdamW
(clipping, each schedule), int8 compression, checkpoints written by either
package and restored by the other, the fault-tolerant loop (a run killed by
an injected failure and resumed equals an uninterrupted one), the GNN train
cells (a partitioned-mode cell is built under a process group and refused
without one), ``launch/train.main --device cpu``, and the count of
segment_reduce calls a training step makes (which ``chip_smoke.py`` holds
the card's launch counts to).

Inputs are made with numpy from a seed; the reference is called through
``jax.jit``.  Tolerances (float32):

* AdamW over 12 steps from the same inputs: rtol = 2e-6, atol = 1e-7 (the
  global norm sums in another order, so the clip scale moves by an ulp);
* compression: payloads exact; scales and dequantized values within one
  ulp (rtol 2.5e-7: XLA may multiply by 1/127 where PyTorch divides by
  127), the carried error within 5e-7, one rounding of |g| < 4 (XLA may
  fuse ``g - q * scale`` into one rounding);
* checkpoints and loop resume: exact, bit for bit;
* a train step (the cells, the loop's step): loss and parameters rtol =
  2e-5, atol = 1e-6 (``TOL``), the models' tolerance.  Over several
  steps AdamW runs with eps = 1e-3: at the default 1e-8 its per-element
  normalisation turns the float32 noise of a gradient element near zero
  (|g| ~ eps, noise ~1e-9) into parameter differences up to ~0.2 lr.
"""
import functools

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import torch_parity as tp  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models.gnn import meshgraphnet as jmgn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.gnn import meshgraphnet  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-6)
OPT_TOL = dict(rtol=2e-6, atol=1e-7)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def assert_trees_close(got, want, **tol):
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def _np_tree(seed):
    """A parameter tree of the GNN models' kind: a dict of lists of
    {"w", "b"} and a stacked (L, ...) leaf."""
    rng = np.random.default_rng(seed)
    return {"mlp": [{"w": rng.standard_normal((5, 4)).astype(np.float32),
                     "b": rng.standard_normal(4).astype(np.float32)}
                    for _ in range(2)],
            "blocks": {"w": rng.standard_normal((3, 4, 4)).astype(
                np.float32)}}


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_apply_updates_matches_reference(schedule):
    """12 steps over warmup (3), decay (to step 10) and past the end, with
    gradients large enough that global-norm clipping acts on every step."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10,
                            clip_norm=0.5, schedule=schedule)
    jcfg = jadamw.AdamWConfig(**vars(cfg))
    j_apply = jax.jit(functools.partial(jadamw.apply_updates, jcfg))
    np_p = _np_tree(0)
    jp, jst = jax.tree.map(jnp.asarray, np_p), jadamw.init_state(np_p)
    p = convert.tree_to_tensors(np_p)
    st = adamw.init_state(p)
    for i in range(12):
        g = _np_tree(100 + i)
        jp, jst, jm = j_apply(jp, jax.tree.map(jnp.asarray, g), jst)
        p, st, m = adamw.apply_updates(cfg, p, convert.tree_to_tensors(g),
                                       st)
        assert float(m["grad_norm"]) > cfg.clip_norm
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   **OPT_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **OPT_TOL)
        assert st["step"].dtype == torch.int32 and int(st["step"]) == i + 1
        assert_trees_close(p, jp, **OPT_TOL)
        assert_trees_close(st, jst, **OPT_TOL)


def test_compression_matches_reference():
    """compress/decompress with error feedback over 5 steps from the same
    gradients; byte counts."""
    np_g = _np_tree(1)
    jerr = jcompression.init_error(np_g)
    err = compression.init_error(convert.tree_to_tensors(np_g))
    j_compress = jax.jit(jcompression.compress)
    for i in range(5):
        g = _np_tree(10 + i)
        jq, js, jerr = j_compress(jax.tree.map(jnp.asarray, g), jerr)
        q, s, err = compression.compress(convert.tree_to_tensors(g), err)
        for a, b in zip(tree.leaves(q), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(_np(a), _np(b))
        assert_trees_close(s, js, rtol=2.5e-7, atol=0)
        assert_trees_close(err, jerr, rtol=0, atol=5e-7)
        assert_trees_close(compression.decompress(q, s),
                           jcompression.decompress(jq, js), rtol=2.5e-7,
                           atol=0)
    g = convert.tree_to_tensors(np_g)
    assert compression.compressed_bytes(g) == jcompression.compressed_bytes(
        np_g)
    assert compression.raw_bytes(g) == jcompression.raw_bytes(np_g)


def test_checkpoints_cross_between_packages(tmp_path):
    """A MeshGraphNet train state saved by the reference restores into the
    port's tree, and one the port saved restores into the reference's, bit
    for bit; both name the arrays by the same key paths."""
    cfg = jax_get_arch("meshgraphnet").smoke
    jp = jax.jit(jmgn.init_params, static_argnums=0)(cfg, jax.random.key(0))
    jstate = {"params": jp, "opt": jadamw.init_state(jp)}
    jstate["opt"]["step"] = jnp.asarray(7, jnp.int32)
    jckpt.save(str(tmp_path / "ref"), 7, jstate, extra={"loss": 1.5})
    params = meshgraphnet.init_params(get_arch("meshgraphnet").smoke,
                                      torch.Generator().manual_seed(5))
    target = {"params": params, "opt": adamw.init_state(params)}
    got = ckpt.restore(str(tmp_path / "ref"), 7, target)
    assert_trees_close(got, jstate, rtol=0, atol=0)
    assert got["opt"]["step"].dtype == torch.int32
    assert ckpt.latest_step(str(tmp_path / "ref")) == 7
    assert ckpt.read_manifest(str(tmp_path / "ref"), 7)["extra"]["loss"] \
        == 1.5

    ckpt.save(str(tmp_path / "port"), 3, target, extra={"loss": 2.0})
    back = jckpt.restore(str(tmp_path / "port"), 3,
                         jax.tree.map(jnp.zeros_like, jstate))
    assert_trees_close(target, back, rtol=0, atol=0)
    assert ckpt.read_manifest(str(tmp_path / "port"), 3)["arrays"].keys() \
        == jckpt.read_manifest(str(tmp_path / "ref"), 7)["arrays"].keys()


def _mgn_setup():
    cfg = get_arch("meshgraphnet").smoke
    np_params = jax.tree.map(np.asarray, jax.jit(
        jmgn.init_params, static_argnums=0)(cfg, jax.random.key(2)))
    opt_cfg = adamw.AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=2,
                                total_steps=8)
    return cfg, np_params, opt_cfg


def test_train_step_matches_reference():
    """Three steps of the loop's train step (value and grad, AdamW) on a
    mesh batch, against the reference's jitted step."""
    cfg, np_params, opt_cfg = _mgn_setup()
    jdata = jsynth.mesh_batch(5, 6, seed=1)
    data = synthetic.mesh_batch(5, 6, seed=1)
    jstep = jloop.build_train_step(
        lambda p, b: jmgn.loss_fn(cfg, p, b),
        jadamw.AdamWConfig(**vars(opt_cfg)))
    step = loop.build_train_step(
        lambda p, b: meshgraphnet.loss_fn(cfg, p, b), opt_cfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    jst, jerr = jadamw.init_state(jp), jnp.zeros(())
    p = convert.gnn_params(np_params)
    st, err = adamw.init_state(p), torch.zeros(())
    for _ in range(3):
        jp, jst, jerr, jm = jstep(jp, jst, jerr, jdata)
        p, st, err, m = step(p, st, err, data)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
    assert_trees_close(p, jp, **TOL)


@pytest.mark.parametrize("arch_id,shape", [
    ("meshgraphnet", "full_graph_sm"), ("schnet", "molecule")])
def test_loop_resume_equals_uninterrupted(tmp_path, arch_id, shape):
    """The reference's restart test on the port, through a smoke train cell
    as ``launch/train.main`` drives it: 6 steps straight against 3 + an
    injected failure + a resume from the checkpoint; the same final
    parameters and optimizer state, bit for bit."""
    cell = steps.build_cell(get_arch(arch_id), shape, "cpu", smoke=True)
    batch = steps.materialize_cell(cell, seed=1)[2]

    def stream():
        while True:
            yield batch

    def step(params, opt_state, err, b):
        p, o, m = cell.step_fn(params, opt_state, b)
        return p, o, err, m

    def fresh():
        p, o, _ = steps.materialize_cell(cell, seed=1)
        return loop.TrainState(p, o, 0)

    def config(d, **kw):
        return loop.TrainLoopConfig(total_steps=6, ckpt_every=3,
                                    ckpt_dir=str(tmp_path / d), **kw)

    quiet = lambda *a: None  # noqa: E731
    a = loop.run(config("a", resume=False), fresh(), step, stream(), log=quiet)
    with pytest.raises(loop.SimulatedFailure):
        loop.run(config("b", fail_at_step=3), fresh(), step, stream(),
                 log=quiet)
    assert ckpt.latest_step(str(tmp_path / "b")) == 3
    logs = []
    b = loop.run(config("b"), fresh(), step, stream(), log=logs.append)
    assert logs[0] == "[loop] resumed from step 3" and b.step == a.step == 6
    got = tree.leaves({"p": b.params, "o": b.opt_state})
    want = tree.leaves({"p": a.params, "o": a.opt_state})
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("arch_id,shape", [
    ("meshgraphnet", "full_graph_sm"), ("graphsage-reddit", "minibatch_lg"),
    ("schnet", "molecule"), ("nequip", "molecule")])
def test_gnn_cell_matches_reference(arch_id, shape):
    """The port's smoke train cell against the reference's on the same
    materialized inputs (every integer zero, so every edge is 0 -> 0):
    batch shapes, meta, one step's loss and parameters."""
    arch, jarch = get_arch(arch_id), jax_get_arch(arch_id)
    cell = steps.build_cell(arch, shape, "cpu", smoke=True)
    jcell = jsteps.build_cell(jarch, shape, make_host_mesh(), smoke=True)
    for key in ("param_count", "model_flops", "tokens", "kind"):
        assert cell.meta[key] == jcell.meta[key]
    params, opt_state, batch = steps.materialize_cell(cell, seed=3)
    assert {k: tuple(v.shape) for k, v in batch.items() if k != "plan"} == \
        {k: v.shape for k, v in jcell.args[2].items()}
    assert int(batch["senders"].abs().sum()) == 0
    want = jax.jit(jcell.step_fn)(
        jax.tree.map(lambda x: jnp.asarray(_np(x)), params),
        jadamw.init_state(jax.tree.map(lambda x: jnp.asarray(_np(x)),
                                       params)),
        {k: jnp.asarray(_np(v)) for k, v in batch.items() if k != "plan"})
    got = cell.step_fn(params, opt_state, batch)
    np.testing.assert_allclose(float(got[2]["loss"]), float(want[2]["loss"]),
                               **TOL)
    assert_trees_close(got[0], want[0], **TOL)


def test_train_main_on_cpu(tmp_path, capsys):
    """launch/train.main --device cpu trains a GNN's smoke config through
    the loop and its checkpoints, and an LM's and FM's as well."""
    d = str(tmp_path / "ck")
    assert train.main(["--arch", "schnet", "--shape", "molecule", "--steps",
                       "3", "--ckpt-every", "2", "--ckpt-dir", d,
                       "--device", "cpu"]) == 0
    assert "[train] finished at step 3" in capsys.readouterr().out
    assert ckpt.latest_step(d) == 3
    keys = ckpt.read_manifest(d, 2)["arrays"]
    assert "['opt']/['step']" in keys and "['params']/['embed']" in keys
    for arch_id in ("gemma3-1b", "fm"):
        d = str(tmp_path / arch_id)
        assert train.main(["--arch", arch_id, "--steps", "1", "--ckpt-dir",
                           d, "--device", "cpu"]) == 0
        assert ckpt.latest_step(d) == 1


def test_segment_sums_per_step(monkeypatch):
    """One train step of each GNN calls segment_sum_sorted as often as
    ``chip_smoke.gnn_segment_sums`` counts (the count the card's launches
    are held to): forward sums, the checkpoints' recomputed sums and the
    gathers' backward sums."""
    calls = []
    real = sr.segment_sum_sorted

    def counted(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(sr, "segment_sum_sorted", counted)
    for arch_id in tp.GNN_ARCHS:
        arch = get_arch(arch_id)
        shape = {"schnet": "molecule", "nequip": "molecule"}.get(
            arch_id, "full_graph_sm")
        cell = steps.build_cell(arch, shape, "cpu", smoke=True)
        calls.clear()
        cell.step_fn(*cell.args)
        assert len(calls) == chip_smoke.gnn_segment_sums(arch_id, arch.smoke)


def test_build_cell_refuses_partitioned_mode():
    """tuning={"mode": "partitioned"} refuses to run without a process
    group (RuntimeError, not one rank quietly) and for another GNN than
    MeshGraphNet; under a gloo group of one rank it builds the reference's
    partitioned cell (``launch/gnn_partitioned.py``), whose step runs;
    without the key the replicated cell is built as before."""
    from repro_torch.launch import gnn_partitioned as gp

    arch = get_arch("meshgraphnet")
    part = {"mode": "partitioned", "halo_frac": 0.5}
    with pytest.raises(RuntimeError, match="process group"):
        steps.build_cell(arch, "full_graph_sm", "cpu", smoke=True,
                         tuning=part)
    gp.init_rank(0, 1, gp.free_port(), torch.device("cpu"),
                 log=lambda *a, **k: None)
    try:
        with pytest.raises(ValueError, match="meshgraphnet only"):
            steps.build_cell(get_arch("schnet"), "molecule", "cpu",
                             smoke=True, tuning=part)
        cell = steps.build_cell(arch, "full_graph_sm", "cpu", smoke=True,
                                tuning=part)
        meta = cell.meta
        assert (meta["mode"], meta["halo_frac"], meta["world"]) == \
            ("partitioned", 0.5, 1)
        # full_graph_sm's 128 nodes and 512 edges pad to 512 each
        assert (meta["n_l"], meta["e_cap"], meta["h_cap"]) == (512, 512, 256)
        _, _, metrics = cell.step_fn(*cell.args)
        assert np.isfinite(float(metrics["loss"]))
    finally:
        torch.distributed.destroy_process_group()
    cell = steps.build_cell(arch, "full_graph_sm", "cpu", smoke=True,
                            tuning={"mode": "replicated"})
    assert cell.meta["kind"] == "train"
