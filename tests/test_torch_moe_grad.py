"""The MoE FFN's gradients and a MoE train step, on the CPU.

``models/moe.py`` gathers the dispatched tokens and sums the experts'
outputs back through ``models/gather.py`` on one sorted index, so the
combine's sum and the gather's gradient are segment_reduce sums in a fixed
order and a MoE step repeats bit for bit on the card.  Here the forward
and the gradients (with respect to the tokens, the router and every
expert matrix, through dropped pairs) are held against ``jax.grad`` of the
JAX package's ``moe_apply`` under ``jax.jit``, two runs of the MoE smoke
train step are held to each other bit for bit, and the segment_reduce
calls of a step are held to ``chip_smoke.lm_segment_sums``, which the
card's launch counts are held to.

Inputs come from numpy with a seed; every routed expert is drawn on its
own.  Tolerances (float32): the output rtol = atol = 2e-5, as
``tests/test_torch_moe.py`` (a float32 sum of at most top_k + 1 terms a
row in another order than XLA's scatter-add); each gradient within 1e-5
relative L2 (the same sums, and products summed in another order).
"""
import dataclasses

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import convert, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

D, F = 16, 24
GRAD_TOL = 1e-5


def _params(e: int, n_shared: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def u(*shape):
        s = 1 / np.sqrt(shape[-2])
        return rng.uniform(-s, s, shape).astype(np.float32)

    p = {"router": rng.standard_normal((D, e)).astype(np.float32),
         "w_gate": u(e, D, F), "w_up": u(e, D, F), "w_down": u(e, F, D)}
    if n_shared:
        p["shared"] = {"w_gate": u(D, n_shared * F),
                       "w_up": u(D, n_shared * F),
                       "w_down": u(n_shared * F, D)}
    return p


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# (T, E, top_k, n_shared, capacity_factor, groups)
CASES = {
    "drops_cf05": (37, 8, 2, 2, 0.5, 0),        # cap 4 of ~9 pairs a expert
    "k6_drops_cf05": (64, 8, 6, 2, 0.5, 0),
    "groups2_drops": (64, 8, 2, 0, 0.5, 2),
    "decode_cap1": (4, 64, 6, 2, 1.25, 0),      # cap 1: most pairs drop
}


@pytest.mark.parametrize("name", list(CASES))
def test_moe_gradients_match_reference(name):
    """sum(out * ct) + 0.1 aux, differentiated with respect to x and every
    parameter, against jax.grad of the reference under jax.jit."""
    t, e, k, shared, cf, groups = CASES[name]
    params = _params(e, shared, seed=t * e + k)
    rng = np.random.default_rng(t + e)
    x = rng.standard_normal((t, D)).astype(np.float32)
    ct = rng.standard_normal((t, D)).astype(np.float32)
    kw = dict(top_k=k, capacity_factor=cf, groups=groups)

    def jloss(p, xx):
        out, aux = jmoe.moe_apply(p, xx, **kw)
        return jnp.sum(out * ct) + 0.1 * aux, out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    p = tree.tree_map(lambda a: a.requires_grad_(True),
                      convert.tree_to_tensors(params))
    xt = convert.to_tensor(x).requires_grad_(True)
    out, aux = moe.moe_apply(p, xt, **kw)
    (torch.sum(out * torch.from_numpy(ct)) + 0.1 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    assert _rel_l2(xt.grad.numpy(), np.asarray(jgx)) <= GRAD_TOL
    want = jax.tree_util.tree_flatten_with_path(jgp)[0]
    got = tree.leaves(p)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        rel = _rel_l2(g.grad.numpy(), np.asarray(w))
        assert rel <= GRAD_TOL, (jax.tree_util.keystr(path), rel)


def _moe_smoke(remat: bool):
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").smoke,
                              capacity_factor=0.5, remat=remat)
    params = tf.init_params(cfg, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    for w in params["layers"]["moe"].values():
        if isinstance(w, torch.Tensor) and w.dim() == 4:   # routed experts
            w.copy_(torch.rand(w.shape, generator=gen) * 0.3 - 0.15)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33)))
    batch = {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int()}
    return cfg, params, batch


def test_moe_train_step_repeats_bitwise():
    """Two runs of one MoE train step (gradient and AdamW update, pairs
    dropped at capacity factor 0.5) are bitwise equal."""
    cfg, params, batch = _moe_smoke(remat=False)
    step = steps.make_train_step(lambda p, bb: tf.loss_fn(cfg, p, bb))
    one, two = (step(params, adamw.init_state(params), batch)
                for _ in range(2))
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(one[:2]), tree.leaves(two[:2])))
    assert torch.equal(one[2]["loss"], two[2]["loss"])


@pytest.mark.parametrize("remat", [False, True])
def test_moe_segment_sums_per_step(monkeypatch, remat):
    """A MoE train step sums on segment_reduce as often as
    ``chip_smoke.lm_segment_sums`` says (the card's count is held to it),
    and adds with no scatter_add_."""
    calls = {"sum": 0}
    real = sr.segment_sum_sorted

    def counted(*a, **kw):
        calls["sum"] += 1
        return real(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("scatter_add_ in a MoE step")

    monkeypatch.setattr(sr, "segment_sum_sorted", counted)
    monkeypatch.setattr(torch.Tensor, "scatter_add_", refused)
    cfg, params, batch = _moe_smoke(remat=remat)
    step = steps.make_train_step(lambda p, bb: tf.loss_fn(cfg, p, bb))
    step(params, adamw.init_state(params), batch)
    assert calls["sum"] == chip_smoke.lm_segment_sums(cfg) > \
        chip_smoke.EMBED_SEGMENT_SUMS["lm"]
