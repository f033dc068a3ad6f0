"""The port's MLA attention and MoE transformer against the JAX package, on
the CPU: DeepSeek-V2-Lite (MLA + MoE) and Moonlight (GQA + MoE), and the two
dense LM configs that complete the port's registry.

Inputs are made with numpy from a seed.  Model parameters come from the
reference's ``init_params``; their routed experts are then redrawn with
numpy, one draw per expert (the reference's ``moe_init`` makes every
expert of a layer equal, which would hide a routing fault), and the same
arrays go to both packages (``models/convert.py`` on the port's side).
The port's prefill attention on the CPU is the flash_attention kernel's
plain version, with MLA's 192-wide q, k and 128-wide v at full size, where
the reference runs ``chunked_attention``.  Tolerances (float32):

* one MLA layer (prefill and decode): rtol = atol = 2e-5, float32 sums in
  another order; a bfloat16 decode layer 1e-2, one bfloat16 step;
* prefill logits and caches and 8 decode steps of the smoke configs:
  rtol = atol = 1e-4 (``TOL``), products, softmax, norms and the MoE
  scatter-add sum in another order through the layers;
* the port against its own forward (the reference's decode == prefill and
  prefill-then-decode tests): rtol = atol = 2e-4, those tests' own.
"""
import functools

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
NEW_ARCHS = ("deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "command-r-35b",
             "internlm2-20b")
MLA = tf.LMConfig(n_layers=2, d_model=32, n_heads=2, attn_kind="mla",
                  kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8,
                  vocab=53, attn_chunk=4, remat=False, dtype="float32")
# the reference jitted: one program per shape, where op-by-op dispatch would
# keep hundreds of MB of compiled kernels alive in the test process
J_INIT = jax.jit(jtf.init_params, static_argnums=0)
J_PREFILL = jax.jit(jtf.prefill, static_argnums=(0, 3))
J_DECODE = jax.jit(jtf.decode_step, static_argnums=0)
J_FORWARD = jax.jit(jtf.forward, static_argnums=0)
J_MLA = jax.jit(jtf._mla_attention, static_argnums=(0, 3),
                static_argnames="return_kv")
J_MLA_DECODE = jax.jit(jtf._mla_decode_layer, static_argnums=(0, 5))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def _distinct_experts(np_params, seed: int):
    """The reference's parameters with every routed expert drawn anew
    (U(-1/sqrt(d_in), 1/sqrt(d_in)), as ``dense_init``) and a router wide
    enough to spread the tokens."""
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
    np_params = _distinct_experts(
        jax.tree.map(np.asarray, J_INIT(jcfg, jax.random.key(seed))),
        seed + 1)
    return jax.tree.map(jnp.asarray, np_params), convert.lm_params(np_params)


def _layer_inputs(cfg, seed):
    """Layer 0's weights of both packages and a hidden state (2, 12, D)."""
    jparams, params = _models(cfg, seed)
    x = np.random.default_rng(seed).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    return (jax.tree.map(lambda a: a[0], jparams["layers"]),
            tf._layer(params, 0), x)


@pytest.mark.parametrize("window", [0, 5])
def test_mla_attention_matches_reference(window):
    jlp, lp, x = _layer_inputs(MLA, seed=window)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want, (jckv, jkr) = J_MLA(MLA, jlp, jnp.asarray(x), window,
                              jnp.asarray(pos), return_kv=True)
    got, (ckv, kr) = tf._mla_attention(MLA, lp, torch.from_numpy(x), window,
                                       torch.from_numpy(pos.copy()).long())
    for g, w in ((got, want), (ckv, jckv), (kr, jkr)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **LAYER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_layer_matches_reference(dtype):
    """The absorbed projection over a cache of 12 positions, the new token
    at position 9 (entries past it are masked)."""
    cfg = tf.LMConfig(**{**vars(MLA), "dtype": dtype})
    jlp, lp, x = _layer_inputs(cfg, seed=3)
    rng = np.random.default_rng(4)
    h = x[:, 0]
    ckv = rng.standard_normal((2, 12, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, 12, cfg.qk_rope_dim)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jlp = jax.tree.map(lambda a: a.astype(jdt) if a.ndim == 2 else a, jlp)
    lp = {k: (w.to(getattr(torch, dtype)) if w.dim() == 2 else w)
          for k, w in lp.items()}
    want, jckv, jkr = J_MLA_DECODE(
        cfg, jlp, jnp.asarray(h).astype(jdt), jnp.asarray(ckv).astype(jdt),
        jnp.asarray(kr).astype(jdt), 9)
    tckv, tkr = (convert.to_tensor(np.asarray(jnp.asarray(a).astype(jdt)))
                 for a in (ckv, kr))
    got = tf._mla_decode_layer(
        cfg, lp, convert.to_tensor(np.asarray(jnp.asarray(h).astype(jdt))),
        tckv, tkr, 9)
    tol = LAYER_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(tckv), _np(jckv), **tol)
    np.testing.assert_allclose(_np(tkr), _np(jkr), **tol)


@pytest.mark.parametrize("arch_id", ["deepseek-v2-lite-16b",
                                     "moonshot-v1-16b-a3b"])
def test_prefill_and_decode_match_reference(arch_id):
    jcfg, cfg = jax_get_arch(arch_id).smoke, get_arch(arch_id).smoke
    jparams, params = _models(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    fed = rng.integers(0, cfg.vocab, (8, 2)).astype(np.int32)
    jlogits, jcache = J_PREFILL(jcfg, jparams, jnp.asarray(toks), 40)
    logits, cache = tf.prefill(cfg, params, torch.from_numpy(toks), 40)
    names = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    assert set(cache) == set(jcache) == {*names, "len"}
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    for key in names:
        assert cache[key].shape == jcache[key].shape
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **TOL)
    for t in fed:
        jlogits, jcache = J_DECODE(jcfg, jparams, jcache, jnp.asarray(t))
        logits, cache = tf.decode_step(cfg, params, cache, torch.from_numpy(t))
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    assert cache["len"] == int(jcache["len"]) == 40
    for key in names:
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **TOL)
    # forward's logits over the prompt, and the summed MoE aux loss
    jfull, jaux = J_FORWARD(jcfg, jparams, jnp.asarray(toks))
    full, aux = tf.forward(cfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(full), _np(jfull), **TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-5


def test_mla_decode_matches_prefill():
    """The reference's ``test_decode_matches_prefill`` for MLA: eight decode
    steps from an empty cache against one forward pass."""
    p = tf.init_params(MLA, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 53, (1, 8)).astype(np.int32))
    full, aux = tf.forward(MLA, p, toks)
    assert aux == 0.0
    cache = tf.init_cache(MLA, 1, 8)
    outs = []
    for i in range(8):
        lg, cache = tf.decode_step(MLA, p, cache, toks[:, i])
        outs.append(lg)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="full"):
        tf.decode_step(MLA, p, cache, toks[:, 0])


@pytest.mark.parametrize("kind", ["mla_moe", "gqa_moe"])
def test_prefill_then_decode_matches_forward(kind):
    """The reference's serve-path integration test, with MoE: prefill 8
    tokens, decode 4, each logit against the full forward pass.  Capacity
    4.0 keeps every pair, so the 2-token decode and the 24-token forward
    route alike."""
    moe = dict(moe=True, n_experts=4, n_shared=1, top_k=2, d_expert=16,
               capacity_factor=4.0)
    if kind == "mla_moe":
        cfg = tf.LMConfig(**{**vars(MLA), **moe})
    else:
        cfg = tf.LMConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                          head_dim=8, vocab=53, remat=False, dtype="float32",
                          **moe)
    p = tf.init_params(cfg, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(5)
    for name in ("w_gate", "w_up", "w_down"):     # distinct experts
        w = p["layers"]["moe"][name]
        w.copy_(torch.rand(w.shape, generator=gen) * 0.4 - 0.2)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, 53, (2, 12)).astype(np.int32))
    full, aux = tf.forward(cfg, p, toks)
    assert float(aux) > 0
    logits, cache = tf.prefill(cfg, p, toks[:, :8], max_len=12)
    np.testing.assert_allclose(_np(logits), _np(full[:, 7]), rtol=2e-4,
                               atol=2e-4)
    for i in range(8, 12):
        logits, cache = tf.decode_step(cfg, p, cache, toks[:, i])
        np.testing.assert_allclose(_np(logits), _np(full[:, i]), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("arch_id", NEW_ARCHS)
def test_init_params_shapes_and_param_count(arch_id):
    """The port's ``init_params`` has the reference's tree, shapes and
    types, and as many parameters as ``param_count()`` says (MoE: equal
    experts within a layer, as the reference draws them)."""
    jcfg, cfg = jax_get_arch(arch_id).smoke, get_arch(arch_id).smoke
    ours = tf.init_params(cfg, torch.Generator().manual_seed(1))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(
        functools.partial(jtf.init_params, jcfg), jax.random.key(0)))
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), ours)
    assert got == want
    n = sum(t.numel() for t in jax.tree.leaves(ours))
    assert n == cfg.param_count() == jcfg.param_count()
    if cfg.moe:
        w = ours["layers"]["moe"]["w_gate"]
        assert torch.equal(w[:, 0], w[:, -1])


def test_configs_and_cells_match_reference():
    """Each copied config equals the reference's field for field; the
    registry offers the four to ``serve --arch``; the serve cells of the
    MoE archs run at the smoke shapes with the reference's model flops."""
    for arch_id in NEW_ARCHS:
        arch, jarch = get_arch(arch_id), jax_get_arch(arch_id)
        for got, want in ((arch.config, jarch.config),
                          (arch.smoke, jarch.smoke)):
            assert vars(got) == vars(want)
            assert got.param_count() == want.param_count()
            assert got.active_param_count() == want.active_param_count()
        assert (arch.id, arch.family, arch.source, arch.shapes,
                arch.skip_notes) == (jarch.id, jarch.family, jarch.source,
                                     jarch.shapes, jarch.skip_notes)
    assert get_arch("deepseek-v2-lite-16b").config.param_count() == \
        16_000_595_968
    for arch_id in ("deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"):
        arch = get_arch(arch_id)
        params = tf.init_params(arch.smoke, torch.Generator().manual_seed(0))
        for name in ("prefill_32k", "decode_32k"):
            cell = steps.build_cell(arch, name, device="cpu", smoke=True,
                                    params=params)
            logits, cache = cell.step_fn(*cell.args)
            shape = steps.smoke_shapes(arch)[name]
            assert logits.shape == (shape["batch"], arch.smoke.vocab)
            assert bool(torch.isfinite(logits).all())
            assert cache["len"] == shape["seq"]
            assert cell.meta["model_flops"] == jsteps.lm_model_flops(
                jax_get_arch(arch_id).smoke, shape)
        with pytest.raises(ValueError, match="skip"):
            steps.build_cell(arch, "long_500k", device="cpu", smoke=True,
                             params=params)


def test_serve_main_deepseek_on_cpu(capsys):
    assert serve.main(["--arch", "deepseek-v2-lite-16b", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen",
                       "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("[serve] arch=deepseek-v2-lite-16b (smoke config) "
                        "batch=2")
    assert lines[1].startswith("  prefill 16 tokens: ")
    assert lines[2].startswith("  decode 4 steps: ") and "ms/token" in lines[2]
    assert lines[3].startswith("  generated ids[0]: [")
