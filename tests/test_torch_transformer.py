"""The port's LM transformer against the JAX package, on the CPU.

Inputs are made with numpy from a seed; model parameters come from the
reference's ``init_params`` and are carried across by
``repro_torch.models.convert``.  The port's prefill attention on the CPU is
the flash_attention kernel's plain version, where the reference runs
``chunked_attention``.  Tolerances (float32 throughout):

* layers (rmsnorm, apply_rope, swiglu, cross entropy): rtol = atol = 1e-6,
  a few float32 roundings; ``rope_freqs`` is the same numpy code, exact.
* prefill logits and KV cache and 8 decode steps at the gemma3 smoke
  config (6 layers, window 16, local_ratio 5): rtol = atol = 1e-4, since
  products, softmax and norms sum in another order through 6 layers.
* decode against a full forward of the port itself (the reference's
  ``test_decode_matches_prefill``): rtol = atol = 2e-4, that test's own.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(layers.rmsnorm(tx, torch.from_numpy(w))),
                               _np(jlayers.rmsnorm(jx, jnp.asarray(w))),
                               **close)
    np.testing.assert_array_equal(layers.rope_freqs(16, 1e6),
                                  jlayers.rope_freqs(16, 1e6))
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            _np(layers.apply_rope(tx, torch.from_numpy(pos), theta)),
            _np(jlayers.apply_rope(jx, jnp.asarray(pos), theta)), **close)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) / 4
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) / 5
    np.testing.assert_allclose(
        _np(layers.swiglu(tx, *map(torch.from_numpy, (wg, wu, wd)))),
        _np(jlayers.swiglu(jx, *map(jnp.asarray, (wg, wu, wd)))), **close)
    logits = rng.standard_normal((3, 4, 11)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, (3, 4)).astype(np.int32)
    np.testing.assert_allclose(
        float(layers.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(labels))),
        float(jlayers.cross_entropy_loss(jnp.asarray(logits),
                                         jnp.asarray(labels))), **close)


def _smoke_models(seed=0):
    jcfg = jax_get_arch("gemma3-1b").smoke
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    params = convert.lm_params(jax.tree.map(np.asarray, jparams))
    return jcfg, get_arch("gemma3-1b").smoke, jparams, params


@pytest.mark.parametrize("prompt_len", [32, 64])
def test_prefill_and_decode_match_reference(prompt_len):
    jcfg, cfg, jparams, params = _smoke_models()
    rng = np.random.default_rng(prompt_len)
    toks = rng.integers(0, cfg.vocab, (2, prompt_len)).astype(np.int32)
    steps_in = rng.integers(0, cfg.vocab, (8, 2)).astype(np.int32)
    max_len = prompt_len + 8
    jlogits, jcache = jtf.prefill(jcfg, jparams, jnp.asarray(toks), max_len)
    logits, cache = tf.prefill(cfg, params, torch.from_numpy(toks), max_len)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **TOL)
    assert cache["len"] == int(jcache["len"]) == prompt_len
    for t in steps_in:
        jlogits, jcache = jtf.decode_step(jcfg, jparams, jcache,
                                          jnp.asarray(t))
        logits, cache = tf.decode_step(cfg, params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    assert cache["len"] == int(jcache["len"]) == max_len
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **TOL)


@pytest.mark.parametrize("kind", ["gqa", "gqa_local"])
def test_decode_matches_prefill(kind):
    cfg = tf.LMConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab=53, attn_chunk=8, remat=False, dtype="float32",
        window=4 if kind == "gqa_local" else 0,
        local_ratio=1 if kind == "gqa_local" else 0)
    p = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 53, (1, 8)).astype(np.int32))
    full, _ = tf.forward(cfg, p, toks)
    cache = tf.init_cache(cfg, 1, 8)
    outs = []
    for i in range(8):
        lg, cache = tf.decode_step(cfg, p, cache, toks[:, i])
        outs.append(lg)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               rtol=2e-4, atol=2e-4)
    last, _ = tf.prefill(cfg, p, toks)
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), rtol=2e-4,
                               atol=2e-4)
    with pytest.raises(ValueError, match="full"):
        tf.decode_step(cfg, p, cache, toks[:, 0])


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "16", "--gen", "5"],
        capture_output=True, text=True, timeout=300, check=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}).stdout
    lines = out.splitlines()
    assert lines[0] == "[serve] arch=gemma3-1b (smoke config) batch=2"
    assert lines[1].startswith("  prefill 16 tokens: ")
    assert lines[2].startswith("  decode 4 steps: ") and "ms/token" in lines[2]
    assert lines[3].startswith("  generated ids[0]: [")


def test_config_and_data_match_reference():
    arch, jarch = get_arch("gemma3-1b"), jax_get_arch("gemma3-1b")
    for got, want in ((arch.config, jarch.config), (arch.smoke, jarch.smoke)):
        assert vars(got) == vars(want)
        assert got.param_count() == want.param_count()
        np.testing.assert_array_equal(got.window_pattern().numpy(),
                                      np.asarray(want.window_pattern()))
    assert arch.config.param_count() == 999_812_736
    pattern = arch.config.window_pattern().tolist()
    assert [i for i, w in enumerate(pattern) if w == 0] == [5, 11, 17, 23]
    assert pattern.count(512) == 22
    assert arch.shapes == jarch.shapes and arch.source == jarch.source
    got = synthetic.lm_batches(97, 3, 10, seed=4)
    want = jsynth.lm_batches(97, 3, 10, seed=4)
    for _ in range(2):
        g, w = next(got), next(want)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))


def test_init_params_have_reference_shapes():
    jcfg, cfg, jparams, _ = _smoke_models()
    ours = tf.init_params(cfg, torch.Generator().manual_seed(1))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    got = {"embed": ours["embed"], "final_ln": ours["final_ln"],
           **{f"layers/{k}": v for k, v in ours["layers"].items()}}
    flat = {"embed": want["embed"], "final_ln": want["final_ln"],
            **{f"layers/{k}": v for k, v in want["layers"].items()}}
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == flat
    bf = tf.init_params(tf.LMConfig(n_layers=1, d_model=16, n_heads=2,
                                    n_kv_heads=1, head_dim=8, d_ff=32,
                                    vocab=40), torch.Generator())
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["layers"]["ln1"].dtype == torch.float32


def test_serve_cells_on_cpu():
    arch, jarch = get_arch("gemma3-1b"), jax_get_arch("gemma3-1b")
    shapes = steps.smoke_shapes(arch)
    params = tf.init_params(arch.smoke, torch.Generator().manual_seed(0))
    for name in ("prefill_32k", "decode_32k", "long_500k"):
        cell = steps.build_cell(arch, name, device="cpu", smoke=True,
                                params=params)
        logits, cache = cell.step_fn(*cell.args)
        shape = shapes[name]
        assert logits.shape == (shape["batch"], arch.smoke.vocab)
        assert bool(torch.isfinite(logits).all())
        assert cache["len"] == shape["seq"]
        assert cell.meta["model_flops"] == jsteps.lm_model_flops(
            jarch.smoke, shape)
    cell = steps.build_cell(arch, "train_4k", device="cpu", smoke=True,
                            params=params)
    _, _, metrics = cell.step_fn(*cell.args)
    assert cell.meta["kind"] == "train" and cell.meta["microbatches"] == 1
    assert bool(torch.isfinite(metrics["loss"]))

