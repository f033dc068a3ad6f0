"""The port's op counter (``repro_torch.launch.op_cost``) against the
reference's HLO cost model (``repro.launch.hlo_cost``), mirroring
``tests/test_hlo_cost.py`` by role: exact matmul flops, a loop counted at
every iteration, bytes that scale with the loop, and LM gradient flops that
scale with the layer count; and the hand-written kernels counted by their
cost formulas, never by their plain versions' insides."""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask, flash_attention_ref)
from repro_torch.kernels.fm_interaction import ops as fm  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import (  # noqa: E402
    fm_interaction_ref)
from repro_torch.kernels.jet_gain import ops as jg  # noqa: E402
from repro_torch.kernels.jet_gain.ref import jet_gain_ref  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import (  # noqa: E402
    segment_sum_sorted_ref)
from repro_torch.launch.op_cost import analyze_step  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import loop  # noqa: E402

# op_cost's flops over analyze_hlo's on the small LM below, measured at
# 0.905 (L = 2) and 0.893 (L = 4): the two count different graphs.  The
# reference's chunked jnp attention computes whole 32 x 32 score tiles,
# masked entries included, where the port counts flash_attention's visible
# (query, key) pairs; and XLA's graph of the loss has elementwise steps of
# its own (the masked CE, the scan's counters).
LM_FLOPS_RATIO = (0.85, 1.15)


def _hlo(fn, *args) -> dict:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def test_matmul_flops_exact():
    got = analyze_step(lambda x, y: x @ y, torch.randn(128, 256),
                       torch.randn(256, 512))
    assert got["flops"] == 2 * 128 * 256 * 512
    ref = _hlo(lambda x, y: x @ y,
               jax.ShapeDtypeStruct((128, 256), jnp.float32),
               jax.ShapeDtypeStruct((256, 512), jnp.float32))
    assert got["flops"] == ref["flops"]
    assert got["bytes"] == (128 * 256 + 256 * 512 + 128 * 512) * 4


def test_loop_counts_every_iteration():
    """A Python loop is counted as it runs: 16 iterations are twice 8,
    exactly; against the reference's scan with its trip count read."""
    w, x = torch.randn(64, 64), torch.randn(8, 64)

    def run(n):
        def body(w, c):
            for _ in range(n):
                c = torch.tanh(c @ w)
            return c
        return analyze_step(body, w, x)

    f8, f16 = run(8), run(16)
    assert f16["flops"] == 2 * f8["flops"]
    assert f8["flops"] == 8 * (2 * 8 * 64 * 64 + 8 * 64)
    assert f8["transcendentals"] == 8 * 8 * 64

    def scan(w, c):
        return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), c, None,
                            length=8)[0]

    ref = _hlo(scan, jax.ShapeDtypeStruct((64, 64), jnp.float32),
               jax.ShapeDtypeStruct((8, 64), jnp.float32))
    assert f8["transcendentals"] == ref["transcendentals"]
    assert f8["flops"] == pytest.approx(ref["flops"], rel=1e-3)


def test_bytes_scale_with_loop():
    x = torch.randn(1024, 1024)

    def run(n):
        def body(c):
            for _ in range(n):
                c = c * 2.0 + 1.0
            return c
        return analyze_step(body, x)["bytes"]

    b4, b8 = run(4), run(8)
    assert b8 == 2 * b4
    # two ops an iteration, each reading and writing 4 MiB (XLA fuses them
    # into one and counts half)
    assert b4 == 4 * 2 * 2 * x.numel() * 4


def test_layers_scale_in_model_flops():
    """The LM's value and gradient flops scale with its layers, and stay
    near the reference's HLO count of the same config (``LM_FLOPS_RATIO``)."""
    base = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                head_dim=32, d_ff=128, vocab=128, remat=True,
                dtype="float32", attn_chunk=32)
    flops = {}
    for n_layers in (2, 4):
        cfg = tf.LMConfig(**dict(base, n_layers=n_layers))
        with FakeTensorMode():
            params = tf.init_params(cfg, torch.Generator().manual_seed(0))
            batch = {k: torch.zeros((2, 64), dtype=torch.int32)
                     for k in ("tokens", "labels")}
            got = analyze_step(lambda p, b, cfg=cfg: loop.value_and_grad(
                lambda q, c: tf.loss_fn(cfg, q, c), p, b), params, batch)
        flops[n_layers] = got["flops"]
        assert got["by_kernel"]["flash_attention"]["calls"] == 2 * n_layers
        assert got["by_kernel"]["flash_attention_bwd"]["calls"] == n_layers

        jcfg = jtf.LMConfig(**dict(base, n_layers=n_layers))
        p = jax.eval_shape(lambda jcfg=jcfg: jtf.init_params(
            jcfg, jax.random.key(0)))
        b = {k: jax.ShapeDtypeStruct((2, 64), jnp.int32)
             for k in ("tokens", "labels")}

        def grad(pp, bb, jcfg=jcfg):
            g = jax.grad(lambda q: jtf.loss_fn(jcfg, q, bb)[0])(pp)
            return jax.tree.map(lambda t: jnp.sum(t.astype(jnp.float32)), g)

        ratio = got["flops"] / _hlo(grad, p, b)["flops"]
        assert LM_FLOPS_RATIO[0] < ratio < LM_FLOPS_RATIO[1], ratio
    assert 1.3 < flops[4] / flops[2] < 2.2, flops


def _brute_pairs(sq, skv, causal, window, q_offset) -> int:
    return int((~attention_mask(sq, skv, causal, window, q_offset,
                                "cpu")).sum())


def test_kernels_counted_by_formula():
    """Each kernel's call counts its formula, on real or fake tensors, and
    the same call to its plain version under op_cost counts otherwise; the
    visible-pair count is the mask's."""
    for args in ((64, 64, True, 0, 0), (48, 80, True, 16, 32),
                 (33, 17, False, 5, 3), (16, 40, False, 0, 0),
                 (8, 8, True, 3, -4)):
        assert fa.attention_pairs(*args) == _brute_pairs(*args), args
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    q, k, v = (t(rng.standard_normal(s, dtype=np.float32)) for s in
               ((2, 4, 40, 16), (2, 2, 40, 16), (2, 2, 40, 8)))
    emb = t(rng.standard_normal((6, 5, 4), dtype=np.float32))
    data = t(rng.standard_normal((50, 3), dtype=np.float32))
    ids = t(np.sort(rng.integers(0, 12, 50)).astype(np.int32))
    nbr_parts = t(rng.integers(0, 5, (2, 30, 4)).astype(np.int32))
    wgt = t(rng.integers(1, 9, (30, 4)).astype(np.int32))
    parts = t(rng.integers(0, 4, (2, 30)).astype(np.int32))
    cases = (
        ("flash_attention", lambda: fa.flash_attention(q, k, v, True, 8),
         fa.flash_attention_cost(q, k, v, True, 8),
         lambda: flash_attention_ref(q, k, v, True, 8)),
        ("fm_interaction", lambda: fm.fm_interaction(emb),
         fm.fm_interaction_cost(emb), lambda: fm_interaction_ref(emb)),
        ("segment_reduce", lambda: sr.segment_sum_sorted(data, ids, 12),
         sr.segment_reduce_cost(data, ids, 12),
         lambda: segment_sum_sorted_ref(data, ids, 12)),
        ("jet_gain", lambda: jg.jet_gain_from_parts(nbr_parts, wgt, parts, 4),
         jg.jet_gain_cost(nbr_parts, wgt, parts, 4),
         lambda: jet_gain_ref(nbr_parts, wgt, parts, 4)))
    for name, call, want, plain in cases:
        got = analyze_step(call)
        assert got["by_kernel"] == {name: dict(want, calls=1)}, name
        assert {key: got[key] for key in want} == want, name
        mine = analyze_step(plain)
        assert {key: mine[key] for key in want} != want, name
        with FakeTensorMode(allow_non_fake_inputs=True):
            assert analyze_step(call)["by_kernel"] == got["by_kernel"], name

    # the backward kernels, through the autograd Functions
    qg, eg = q.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    got = analyze_step(lambda: fa.flash_attention(qg, k, v, True, 8).sum()
                       .backward())
    o, lse = flash_attention_ref(q, k, v, True, 8, return_lse=True)
    want = fa.flash_attention_bwd_cost(q, k, v, o, lse, o, True, 8)
    assert got["by_kernel"]["flash_attention_bwd"] == dict(want, calls=1)
    got = analyze_step(lambda: fm.fm_interaction(eg).sum().backward())
    want = fm.fm_interaction_bwd_cost(emb, torch.ones(6))
    assert got["by_kernel"]["fm_interaction_bwd"] == dict(want, calls=1)
