"""The port's FM model and its fm_interaction plain version against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; model
parameters come from the reference's ``init_params`` and are carried
across by ``repro_torch.models.convert``.  Tolerances:

* fm_interaction on the sweep of ``tests/test_kernel_fm.py`` (against the
  Pallas kernel in interpret mode and against ``fm_interaction_ref``):
  rtol = atol = 1e-5 in float32, 5e-2 in bfloat16, that test's own, plus
  float32's epsilon times the row's sum of squares: the terms s^2 and sq
  cancel, and the port sums them in another order than XLA (one row of
  the (100, 26, 32) case differs by 2.7e-5 at a score of 1.46).  The
  bfloat16 inputs are the same values in both packages.
* the sum-square trick against the naive pairwise sum: rtol = atol = 1e-4
  (the reference test's).
* model scores, loss and retrieval scores: rtol = 1e-5, atol = 1e-6, since
  the sums over fields and over D run in another order.

The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.kernels.fm_interaction.ops import fm_interaction as jfm  # noqa: E402
from repro.kernels.fm_interaction.ref import fm_interaction_ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.recsys import fm as jfm_lib  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.fm_interaction import ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.recsys import fm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _naive(emb):
    b, f, d = emb.shape
    out = np.zeros(b)
    for i in range(f):
        for j in range(i + 1, f):
            out += np.sum(emb[:, i] * emb[:, j], axis=-1)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,f,d,block", [
    (64, 39, 10, 64),
    (128, 8, 16, 32),
    (100, 26, 32, 64),   # the JAX wrapper's padding path
    (256, 4, 128, 256),
])
def test_plain_matches_jax_sweep(b, f, d, block, dtype):
    rng = np.random.default_rng(b + f)
    emb = rng.standard_normal((b, f, d)).astype(np.float32)
    x = jnp.asarray(emb).astype(dtype)
    got = ops.fm_interaction(torch.from_numpy(emb).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (b,)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    e = np.asarray(x, np.float32)
    cancel = np.finfo(np.float32).eps * np.sum(e * e, axis=(1, 2))
    for want in (jfm(x, block_b=block), jref(x)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.numpy() - want)
        assert (err <= tol + tol * np.abs(want) + cancel).all(), err.max()


def test_sum_square_trick_equals_naive():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((16, 12, 8)).astype(np.float32)
    got = fm_interaction_ref(torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), _naive(emb), rtol=1e-4, atol=1e-4)


def test_wrapper_on_cpu_takes_plain_version_and_checks_inputs():
    emb = torch.from_numpy(
        np.random.default_rng(1).standard_normal((9, 5, 3)).astype(np.float32))
    before = dict(kernels.launch_counts)
    assert torch.equal(ops.fm_interaction(emb), fm_interaction_ref(emb))
    assert dict(kernels.launch_counts) == before  # no launch on the CPU
    with pytest.raises(ValueError):
        ops.fm_interaction(emb[0])
    with pytest.raises(TypeError):
        ops.fm_interaction(emb.double())


def _ids(cfg, b, seed):
    """Raw ids with negatives and ids past rows_per_field (both wrap)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-cfg.rows_per_field, 3 * cfg.rows_per_field,
                        (b, cfg.n_fields)).astype(np.int32)


@pytest.mark.parametrize("config", ["smoke", "criteo_widths"])
def test_model_matches_jax(config):
    if config == "smoke":
        cfg_kw = dict(n_fields=8, embed_dim=8, rows_per_field=64)
    else:  # the full config's F and D, with few rows per field
        cfg_kw = dict(n_fields=39, embed_dim=10, rows_per_field=128)
    jcfg, cfg = jfm_lib.FMConfig(**cfg_kw), fm.FMConfig(**cfg_kw)
    jparams = jfm_lib.init_params(jcfg, jax.random.key(3))
    params = convert.fm_params(jax.tree.map(np.asarray, jparams))
    assert params["table"].shape == (cfg.vocab_total, cfg.embed_dim)

    ids = _ids(cfg, 96, seed=cfg.n_fields)
    labels = (np.arange(96) % 3 == 0).astype(np.float32)
    want = np.asarray(jfm_lib.serve(jcfg, jparams, jnp.asarray(ids)))
    got = fm.serve(cfg, params, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        fm.forward(cfg, params, torch.from_numpy(ids)).numpy(), want, **TOL)

    jloss, jm = jfm_lib.loss_fn(jcfg, jparams, {
        "ids": jnp.asarray(ids), "labels": jnp.asarray(labels)})
    loss, m = fm.loss_fn(cfg, params, {"ids": torch.from_numpy(ids),
                                       "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    # the same count of agreeing signs; the means round differently
    np.testing.assert_allclose(float(m["auc_proxy"]), float(jm["auc_proxy"]),
                               **TOL)

    rng = np.random.default_rng(7)
    user = rng.integers(-50, 500, (1, cfg.n_fields - 1)).astype(np.int32)
    cand = rng.integers(-50, 500, 300).astype(np.int32)
    want = jfm_lib.retrieval_scores(jcfg, jparams, jnp.asarray(user),
                                    jnp.asarray(cand))
    got = fm.retrieval_scores(cfg, params, torch.from_numpy(user),
                              torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_cells_on_cpu():
    arch, jarch = get_arch("fm"), jax_get_arch("fm")
    gen = torch.Generator().manual_seed(0)
    params = fm.init_params(arch.smoke, gen)
    shapes = steps.smoke_shapes(arch)
    for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
        cell = steps.build_cell(arch, name, device="cpu", smoke=True,
                                params=params)
        out = cell.step_fn(*cell.args)
        n = shapes[name].get("n_candidates", shapes[name]["batch"])
        assert out.shape == (n,) and out.dtype == torch.float32
        assert bool(torch.isfinite(out).all())
        assert cell.meta["model_flops"] == jsteps.fm_model_flops(
            jarch.smoke, shapes[name])
        if name != "retrieval_cand":
            assert torch.equal(out, fm.forward(arch.smoke, params,
                                               cell.args[1]))
    cell = steps.build_cell(arch, "train_batch", device="cpu", smoke=True,
                            params=params)
    new_params, _, metrics = cell.step_fn(*cell.args)
    assert cell.meta["kind"] == "train" and np.isfinite(float(
        metrics["loss"]))
    assert new_params["table"].shape == params["table"].shape


def test_config_and_data_match_reference():
    arch, jarch = get_arch("fm"), jax_get_arch("fm")
    for got, want in ((arch.config, jarch.config), (arch.smoke, jarch.smoke)):
        assert vars(got) == vars(want)
        assert got.param_count() == want.param_count()
    assert arch.shapes == jarch.shapes and arch.source == jarch.source
    assert arch.config.vocab_total * arch.config.embed_dim * 4 == 408_944_640
    assert ARCH_IDS == JAX_ARCH_IDS  # every arch of the reference's registry
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("schnet-xl")
    got = synthetic.recsys_batches(39, 1000, 16, seed=5)
    want = jsynth.recsys_batches(39, 1000, 16, seed=5)
    for _ in range(2):
        g, w = next(got), next(want)
        for key in ("ids", "labels"):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
