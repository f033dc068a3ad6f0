"""The port's LM training against the JAX package, on the CPU: the
transformer's ``loss_fn`` and its gradients (gemma3, deepseek with MLA and
MoE dropping pairs, moonshot with GQA and MoE), the LM train cell with and
without microbatches, remat, ``launch/train.main --arch gemma3-1b`` and the
flash_attention launches a step makes (which ``chip_smoke.py`` holds the
card's counts to).

Inputs are made with numpy from a seed; the reference is called through
``jax.jit``; its parameters cross over through ``models/convert.py``, with
every routed expert drawn on its own (the reference's ``moe_init`` makes a
layer's experts equal).  The port's attention on the CPU is flash_attention's
plain version and its backward's plain version, where the reference
differentiates ``chunked_attention``.  Tolerances (float32): loss within
1e-5 relative, each gradient leaf within 1e-4 relative L2 (sums in another
order through the layers and the backward pass); parameters after one
AdamW step rtol = 2e-5, atol = 1e-6, the GNN train cells' tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-6)
LM_ARCHS = [a for a in ARCH_IDS if get_arch(a).family == "lm"]
J_INIT = jax.jit(jtf.init_params, static_argnums=0)
J_VG = jax.jit(jax.value_and_grad(jtf.loss_fn, argnums=1, has_aux=True),
               static_argnums=0)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def _distinct_experts(np_params, seed: int):
    """Every routed expert drawn anew and a router wide enough to spread
    the tokens (as tests/test_torch_mla.py)."""
    m = np_params["layers"].get("moe")
    if m is None:
        return np_params
    rng = np.random.default_rng(seed)
    for name in ("w_gate", "w_up", "w_down"):
        a = m[name]
        s = 1 / np.sqrt(a.shape[-2])
        m[name] = rng.uniform(-s, s, a.shape).astype(a.dtype)
    m["router"] = rng.standard_normal(m["router"].shape).astype(np.float32)
    return np_params


def _models(jcfg, seed=0):
    """(the reference's parameters, the port's copy of them)."""
    np_params = _distinct_experts(
        jax.tree.map(np.asarray, J_INIT(jcfg, jax.random.key(seed))), seed)
    return jax.tree.map(jnp.asarray, np_params), convert.lm_params(np_params)


def _batch(cfg, b=2, s=64, seed=1, ignore=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    if ignore:
        toks[0, -5:] = -1  # labels the loss ignores
    return {"tokens": np.maximum(toks[:, :-1], 0), "labels": toks[:, 1:]}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _assert_grads_close(got, want, tol=1e-4):
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = tree.leaves(got)
    assert len(got_leaves) == len(flat_want)
    for g, (path, w) in zip(got_leaves, flat_want):
        assert tuple(g.shape) == w.shape, path
        assert _rel_l2(_np(g), _np(w)) <= tol, (
            jax.tree_util.keystr(path), _rel_l2(_np(g), _np(w)))


@pytest.mark.parametrize("arch_id,cf", [("gemma3-1b", None),
                                        ("deepseek-v2-lite-16b", 0.5),
                                        ("moonshot-v1-16b-a3b", None)])
def test_loss_and_grads_match_reference(arch_id, cf):
    """value_and_grad of the smoke config's loss_fn (CE + aux) against
    jax.value_and_grad of the reference's; deepseek at capacity factor 0.5
    drops pairs (its wtbl gradient at the dummy slot)."""
    cfg, jcfg = get_arch(arch_id).smoke, jax_get_arch(arch_id).smoke
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    jparams, params = _models(jcfg, seed=2)
    b = _batch(cfg)
    (jl, jm), jg = J_VG(jcfg, jparams, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    (l, m), g = loop.value_and_grad(
        lambda p, bb: tf.loss_fn(cfg, p, bb), params,
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5,
                               atol=1e-7)
    if cfg.moe:
        assert float(m["aux"]) > 0
    _assert_grads_close(g, jg)


def test_microbatched_step_matches_reference():
    """The smoke train cell with microbatches=2 (float32-accumulated
    gradients) against the reference's cell with the same tuning: loss and
    parameters after one AdamW step; one microbatch gives the same loss
    (every label counts, so the mean of the halves' means is the mean)."""
    arch, jarch = get_arch("gemma3-1b"), jax_get_arch("gemma3-1b")
    tuning = {"microbatches": 2}
    jparams, params = _models(jarch.smoke, seed=3)
    cell = steps.build_cell(arch, "train_4k", "cpu", smoke=True,
                            params=params, tuning=tuning)
    jcell = jsteps.build_cell(jarch, "train_4k", make_host_mesh(),
                              smoke=True, tuning=tuning)
    assert cell.meta["microbatches"] == jcell.meta["microbatches"] == 2
    for key in ("param_count", "model_flops", "tokens", "kind"):
        assert cell.meta[key] == jcell.meta[key]
    b = _batch(arch.smoke, b=2, s=64, seed=4, ignore=False)
    want = jax.jit(jcell.step_fn)(jparams, jadamw.init_state(jparams),
                                  {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = cell.step_fn(params, adamw.init_state(params), tb)
    np.testing.assert_allclose(float(got[2]["loss"]), float(want[2]["loss"]),
                               rtol=1e-5)
    for g, w in zip(tree.leaves(got[0]), jax.tree.leaves(want[0])):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    whole = steps.make_train_step(
        lambda p, bb: tf.loss_fn(arch.smoke, p, bb))(
            params, adamw.init_state(params), tb)
    np.testing.assert_allclose(float(whole[2]["loss"]),
                               float(got[2]["loss"]), rtol=1e-6)


@pytest.mark.parametrize("arch_id", ["gemma3-1b", "deepseek-v2-lite-16b"])
def test_remat_on_and_off_agree(arch_id):
    """Checkpointed layers and CE chunks recompute the same values: loss
    and gradients with remat on equal those with it off."""
    cfg = get_arch(arch_id).smoke
    params = tf.init_params(cfg, torch.Generator().manual_seed(5))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=6).items()}
    out = [loop.value_and_grad(
        lambda p, bb, c=dataclasses.replace(cfg, remat=r):
        tf.loss_fn(c, p, bb, loss_chunk=16), params, b)
        for r in (False, True)]
    (l0, _), g0 = out[0]
    (l1, _), g1 = out[1]
    assert torch.equal(l0, l1)
    for a, c in zip(tree.leaves(g0), tree.leaves(g1)):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_launches_per_step(monkeypatch):
    """One remat train step calls flash_attention's forward twice a layer
    (the step and its recompute), its backward once a layer, and
    segment_sum_sorted once (the embedding's gradient):
    ``chip_smoke.lm_flash_launches`` and ``EMBED_SEGMENT_SUMS``, which the
    card's launch counts are held to; the forward alone (no gradient) calls
    flash_attention once a layer and nothing else."""
    calls = {"fwd": 0, "bwd": 0, "sum": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(fa_ops, "flash_attention_ref",
                        counted("fwd", fa_ops.flash_attention_ref))
    monkeypatch.setattr(fa_ops, "flash_attention_bwd_ref",
                        counted("bwd", fa_ops.flash_attention_bwd_ref))
    monkeypatch.setattr(sr, "segment_sum_sorted",
                        counted("sum", sr.segment_sum_sorted))
    cfg = dataclasses.replace(get_arch("gemma3-1b").smoke, remat=True)
    params = tf.init_params(cfg, torch.Generator().manual_seed(7))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=8).items()}
    loop.value_and_grad(lambda p, bb: tf.loss_fn(cfg, p, bb), params, b)
    assert (calls["fwd"], calls["bwd"]) == chip_smoke.lm_flash_launches(cfg)
    assert calls["sum"] == chip_smoke.EMBED_SEGMENT_SUMS["lm"]
    calls.update(fwd=0, bwd=0, sum=0)
    with torch.no_grad():
        tf.loss_fn(cfg, params, b)
    assert calls == {"fwd": cfg.n_layers, "bwd": 0, "sum": 0}


def test_train_cells_meta_match_reference():
    """Every LM's full-size train_4k cell: the reference's microbatch rule
    (and a tuned budget), model flops and token counts, from the configs
    alone (no parameters are made)."""
    mesh = make_host_mesh()
    for arch_id in LM_ARCHS:
        arch, jarch = get_arch(arch_id), jax_get_arch(arch_id)
        shape = arch.shapes["train_4k"]
        for tuning in ({}, {"mb_budget": 1e11}):
            jcell = jsteps.build_cell(jarch, "train_4k", mesh, tuning=tuning)
            assert steps.lm_microbatches(arch.config, shape["batch"],
                                         shape["seq"], tuning) == \
                jcell.meta["microbatches"], (arch_id, tuning)
        assert steps.lm_model_flops(arch.config, shape) == \
            jcell.meta["model_flops"]


def test_lm_train_decreases_loss():
    """Mirror of tests/test_models.py::test_lm_train_decreases_loss: ten
    plain gradient steps (lr 0.5) on one batch lower the loss, from the
    reference's initial parameters (key 0)."""
    kw = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
              d_ff=128, vocab=64, remat=False, dtype="float32", attn_chunk=32)
    cfg = tf.LMConfig(**kw)
    p = convert.lm_params(jax.tree.map(
        np.asarray, J_INIT(jtf.LMConfig(**kw), jax.random.key(0))))
    batch = next(synthetic.lm_batches(cfg.vocab, batch=8, seq=32))
    want = next(jsynth.lm_batches(cfg.vocab, batch=8, seq=32))
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    losses = []
    for _ in range(10):
        (loss, _), grads = loop.value_and_grad(
            lambda p_, b: tf.loss_fn(cfg, p_, b), p, batch)
        p = tree.tree_map(lambda a, g: a - 0.5 * g.to(a.dtype), p, grads)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_smoke_train(arch_id):
    """Mirror of tests/test_configs_smoke.py::test_lm_smoke_train: the
    smoke train cell from materialized inputs gives a finite scalar loss
    and finite parameters."""
    cell = steps.build_cell(get_arch(arch_id), "train_4k", "cpu", smoke=True)
    params, opt_state, metrics = cell.step_fn(
        *steps.materialize_cell(cell, seed=0))
    assert metrics["loss"].shape == ()
    assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(x).all()) for x in tree.leaves(params))


def test_train_main_gemma_on_cpu(tmp_path, capsys):
    """launch/train.main --arch gemma3-1b --device cpu trains the smoke
    config through the loop and writes its checkpoints."""
    d = str(tmp_path / "ck")
    assert train.main(["--arch", "gemma3-1b", "--steps", "3",
                       "--ckpt-every", "2", "--ckpt-dir", d,
                       "--device", "cpu"]) == 0
    assert "[train] finished at step 3" in capsys.readouterr().out
    assert ckpt.latest_step(d) == 3
    keys = ckpt.read_manifest(d, 2)["arrays"]
    assert "['params']/['embed']" in keys and "['opt']/['step']" in keys
