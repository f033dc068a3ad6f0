"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe``, on the CPU.

Parameters and tokens are made with numpy from a seed and handed to both
packages; every routed expert gets weights of its own (``moe_init`` repeats
one draw over the experts, and with equal experts a routing fault would not
show, since the normalised gates sum to 1).  Tolerances:

* float32: rtol = atol = 2e-5 on the output; the float32 scatter-add runs
  in another order than XLA's, with at most top_k + 1 terms a row, and the
  products sum in another order.  The aux loss within 1e-6.
* bfloat16: rtol = atol = 1e-2, one bfloat16 step of the expert
  activations, which both packages round in bfloat16.
"""
import functools

import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import convert, moe  # noqa: E402

D, F = 16, 24
TOL = dict(rtol=2e-5, atol=2e-5)


def _params(e: int, n_shared: int, seed: int, router_scale: float = 1.0,
            dtype=np.float32) -> dict:
    """Distinct per-expert weights, U(-1/sqrt(d_in), 1/sqrt(d_in)) as the
    reference draws them, in ``dtype``, and a float32 normal router."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        s = 1 / np.sqrt(shape[-2])
        w = rng.uniform(-s, s, shape).astype(np.float32)
        return np.asarray(jnp.asarray(w).astype(dtype))

    p = {"router": (rng.standard_normal((D, e)) * router_scale)
         .astype(np.float32),
         "w_gate": u(e, D, F), "w_up": u(e, D, F), "w_down": u(e, F, D)}
    if n_shared:
        p["shared"] = {"w_gate": u(D, n_shared * F), "w_up": u(D, n_shared * F),
                       "w_down": u(n_shared * F, D)}
    return p


def _run_both(params, x, **kw):
    # jitted: one program per case, where op-by-op dispatch would keep ~1 GB
    # of compiled kernels alive in the test process
    want, jaux = jax.jit(functools.partial(jmoe.moe_apply, **kw))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got, aux = moe.moe_apply(convert.tree_to_tensors(params),
                             convert.to_tensor(x), **kw)
    return got, aux, np.asarray(want.astype(jnp.float32)), float(jaux)


# (T, E, top_k, n_shared, capacity_factor, groups, router scale)
CASES = {
    "t1_e4_k1": (1, 4, 1, 0, 1.25, 0, 1.0),
    "decode_cap1": (4, 64, 6, 2, 1.25, 0, 1.0),   # cap = 1: most pairs drop
    "t37_drops": (37, 8, 2, 2, 0.5, 0, 1.0),      # cap = 4 of ~9 a expert
    "t37_e4_k2": (37, 4, 2, 2, 1.25, 0, 1.0),
    "t256_roomy": (256, 8, 2, 0, 4.0, 0, 1.0),    # nothing drops
    "t256_e64_k6": (256, 64, 6, 2, 1.25, 0, 1.0),
    "t256_k6_drops": (256, 8, 6, 2, 0.5, 0, 3.0),  # a peaked router
    "groups2": (256, 8, 2, 2, 1.25, 2, 1.0),
    "groups2_drops": (4, 64, 6, 0, 0.5, 2, 1.0),
    "ties": (37, 8, 6, 2, 1.25, 0, 0.0),          # uniform probs: ties
}


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_reference(name):
    t, e, k, shared, cf, groups, scale = CASES[name]
    params = _params(e, shared, seed=t * e + k, router_scale=scale)
    x = np.random.default_rng(t).standard_normal((t, D)).astype(np.float32)
    got, aux, want, jaux = _run_both(params, x, top_k=k, capacity_factor=cf,
                                     groups=groups)
    assert got.dtype == torch.float32 and got.shape == (t, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert abs(float(aux) - jaux) <= 1e-6
    if name == "ties":
        # every probability ties: lax.top_k takes experts 0..k-1, and so
        # must the port; the aux loss is then exactly e * (1/e) * 1
        _, gates, idx = moe.route(convert.tree_to_tensors(params),
                                  torch.from_numpy(x), k)
        assert (idx == torch.arange(k)).all()
        assert torch.allclose(gates, torch.full_like(gates, 1 / k))


def test_moe_apply_bfloat16_matches_reference():
    params = _params(8, 2, seed=5, dtype=jnp.bfloat16)
    x = np.asarray(jnp.asarray(np.random.default_rng(6).standard_normal(
        (64, D)).astype(np.float32)).astype(jnp.bfloat16))
    got, aux, want, jaux = _run_both(params, x, top_k=2,
                                     capacity_factor=1.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)
    assert abs(float(aux) - jaux) <= 1e-6


def test_moe_init_has_reference_structure():
    """Shapes, types and equal experts, as the reference's ``moe_init``;
    ``lead`` stacks layers."""
    want = jax.eval_shape(functools.partial(
        jmoe.moe_init, d_model=D, d_expert=F, n_experts=4, n_shared=2,
        dtype=jnp.bfloat16), jax.random.key(0))
    got = moe.moe_init(torch.Generator().manual_seed(0), D, F, 4, 2,
                       torch.bfloat16)

    def sig(tree):
        return jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
            tree)
    assert sig(got) == sig(want)
    for name in ("w_gate", "w_up", "w_down"):
        assert all(torch.equal(got[name][i], got[name][0]) for i in range(4))
    stacked = moe.moe_init(torch.Generator(), D, F, 4, 0, torch.float32,
                           lead=(3,))
    assert stacked["w_down"].shape == (3, 4, F, D) and "shared" not in stacked
    assert not torch.equal(stacked["w_up"][0], stacked["w_up"][1])


def test_groups_must_divide_tokens():
    params = convert.tree_to_tensors(_params(4, 0, seed=0))
    with pytest.raises(ValueError, match="groups"):
        moe.moe_apply(params, torch.zeros((5, D)), top_k=1, groups=2)
