"""The port's FM training against the JAX package, on the CPU: ``loss_fn``
and its gradients (fm_interaction's backward and the embedding tables'
sorted sums), the FM train cell after one AdamW step, the segment_reduce
and fm_interaction calls a step makes (which ``chip_smoke.py`` holds the
card's launch counts to), the planted-rule mirror and ``launch/train.main
--arch fm``.

Inputs are made with numpy from a seed; the reference is called through
``jax.jit`` (its fm_interaction off the TPU is ``fm_interaction_ref``);
parameters cross over through ``models/convert.py``.  Tolerances (float32):
loss within 1e-5 relative, each gradient within 1e-4 relative L2 (sums over
fields, D and the batch in another order); parameters after one AdamW step
rtol = 2e-5, atol = 1e-6.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models.recsys import fm as jfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.recsys import fm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-6)
J_INIT = jax.jit(jfm.init_params, static_argnums=0)
J_VG = jax.jit(jax.value_and_grad(jfm.loss_fn, argnums=1, has_aux=True),
               static_argnums=0)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _models(cfg_kw, seed):
    jcfg, cfg = jfm.FMConfig(**cfg_kw), fm.FMConfig(**cfg_kw)
    jparams = J_INIT(jcfg, jax.random.key(seed))
    return jcfg, jparams, cfg, convert.fm_params(jax.tree.map(np.asarray,
                                                              jparams))


@pytest.mark.parametrize("config", ["smoke", "criteo_widths"])
def test_loss_and_grads_match_reference(config):
    """value_and_grad of loss_fn against jax.value_and_grad of the
    reference's, on ids with repeats (rows whose gradient sums several
    examples) and negatives (which wrap)."""
    cfg_kw = dict(n_fields=8, embed_dim=8, rows_per_field=64) \
        if config == "smoke" else dict(n_fields=39, embed_dim=10,
                                       rows_per_field=128)
    jcfg, jparams, cfg, params = _models(cfg_kw, seed=4)
    rng = np.random.default_rng(5)
    b = {"ids": rng.integers(-20, 2 * cfg.rows_per_field,
                             (96, cfg.n_fields)).astype(np.int32),
         "labels": (rng.random(96) > 0.5).astype(np.float32)}
    (jl, jm), jg = J_VG(jcfg, jparams, {k: jnp.asarray(v)
                                        for k, v in b.items()})
    (l, m), g = loop.value_and_grad(
        lambda p, bb: fm.loss_fn(cfg, p, bb), params,
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["auc_proxy"]), float(jm["auc_proxy"]),
                               rtol=1e-5)
    for key in ("table", "linear", "bias"):
        assert tuple(g[key].shape) == jg[key].shape
        assert _rel_l2(g[key], jg[key]) <= 1e-4, (key, _rel_l2(g[key],
                                                              jg[key]))


def test_train_cell_matches_reference():
    """The smoke train_batch cell (B = 64) against the reference's: meta,
    the batch, and loss and parameters after one AdamW step."""
    arch, jarch = get_arch("fm"), jax_get_arch("fm")
    jcfg, jparams, cfg, params = _models(vars(arch.smoke), seed=6)
    cell = steps.build_cell(arch, "train_batch", "cpu", smoke=True,
                            params=params)
    jcell = jsteps.build_cell(jarch, "train_batch", make_host_mesh(),
                              smoke=True)
    for key in ("param_count", "model_flops", "tokens", "kind"):
        assert cell.meta[key] == jcell.meta[key]
    batch = cell.args[2]
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: v.shape for k, v in jcell.args[2].items()}
    want = jax.jit(jcell.step_fn)(jparams, jadamw.init_state(jparams),
                                  {k: jnp.asarray(v.numpy())
                                   for k, v in batch.items()})
    got = cell.step_fn(*cell.args)
    np.testing.assert_allclose(float(got[2]["loss"]), float(want[2]["loss"]),
                               rtol=1e-5)
    for g, w in zip(tree.leaves(got[0]), jax.tree.leaves(want[0])):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_launches_per_step(monkeypatch):
    """One FM train step calls fm_interaction's forward and backward once
    each and segment_sum_sorted ``chip_smoke.EMBED_SEGMENT_SUMS["recsys"]``
    times (table and linear); a serve step calls neither backward nor a
    sum."""
    calls = {"fwd": 0, "bwd": 0, "sum": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(fm_ops, "fm_interaction_ref",
                        counted("fwd", fm_ops.fm_interaction_ref))
    monkeypatch.setattr(fm_ops, "fm_interaction_bwd_ref",
                        counted("bwd", fm_ops.fm_interaction_bwd_ref))
    monkeypatch.setattr(sr, "segment_sum_sorted",
                        counted("sum", sr.segment_sum_sorted))
    cell = steps.build_cell(get_arch("fm"), "train_batch", "cpu", smoke=True)
    cell.step_fn(*cell.args)
    assert calls == {"fwd": 1, "bwd": 1,
                     "sum": chip_smoke.EMBED_SEGMENT_SUMS["recsys"]}
    calls.update(fwd=0, bwd=0, sum=0)
    serve = steps.build_cell(get_arch("fm"), "serve_p99", "cpu", smoke=True)
    serve.step_fn(*serve.args)
    assert calls == {"fwd": 1, "bwd": 0, "sum": 0}


def test_fm_learns_planted_rule():
    """Mirror of tests/test_models.py::test_fm_learns_planted_rule: 60
    plain gradient steps (lr 1) on fresh batches cut the loss by 20%, from
    the reference's initial parameters (key 0)."""
    _, _, cfg, params = _models(dict(n_fields=8, embed_dim=8,
                                     rows_per_field=32), seed=0)
    data = synthetic.recsys_batches(8, 32, batch=512, seed=0)
    losses = []
    for _ in range(60):
        (loss, _), grads = loop.value_and_grad(
            lambda p, b: fm.loss_fn(cfg, p, b), params, next(data))
        params = tree.tree_map(lambda a, g: a - 1.0 * g.to(a.dtype), params,
                               grads)
        losses.append(float(loss))
    assert losses[-1] < 0.8 * losses[0], (losses[0], losses[-1])


def test_train_main_fm_on_cpu(tmp_path, capsys):
    """launch/train.main --arch fm --device cpu trains the smoke config on
    a stream of click batches through the loop and writes checkpoints."""
    d = str(tmp_path / "ck")
    assert train.main(["--arch", "fm", "--steps", "3", "--ckpt-every", "2",
                       "--ckpt-dir", d, "--device", "cpu"]) == 0
    assert "[train] finished at step 3" in capsys.readouterr().out
    assert ckpt.latest_step(d) == 3
    keys = ckpt.read_manifest(d, 3)["arrays"]
    assert "['params']/['table']" in keys and "['opt']/['step']" in keys
