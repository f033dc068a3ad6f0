"""The plain versions of the port's two backward kernels and the sorted
gather of embedding tables, on the CPU.

* ``flash_attention_bwd_ref`` (FlashAttention-2's formulas on whole
  matrices, from the forward's o and log-sum-exp) against torch.autograd
  through ``flash_attention_ref`` and against ``jax.vjp`` of the
  reference's ``chunked_attention`` (the function the reference trains
  through): the shape set of ``chip_smoke.py`` (t) at small sizes, with
  GQA, causal and not, a window, query offsets, Sq != Skv, values 128
  wide beside 192-wide keys, and rows that see no key (their dq is 0).
* ``fm_interaction_bwd_ref`` against autograd and ``jax.vjp`` of the
  reference's ``fm_interaction_ref``.
* ``models/gather.embedding``: its gradient (a segment_reduce sum in the
  ids' sorted order) against a dense ``index_add_``.

Inputs are made with numpy from a seed.  Tolerances (float32): rtol = atol
= 1e-5, sums in another order; the log-sum-exp within 2e-6.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fm_interaction.ref import fm_interaction_ref as jfm_ref  # noqa: E402,E501
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.fm_interaction import ops as fm_ops  # noqa: E402
from repro_torch.kernels.fm_interaction.ref import (  # noqa: E402
    fm_interaction_bwd_ref, fm_interaction_ref)
from repro_torch.models import gather  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
J_FM_VJP = jax.jit(lambda e, g: jax.vjp(jfm_ref, e)[1](g)[0])

# (H, Hkv, Sq, Skv, causal, window, q_offset, D, Dv)
FLASH_CASES = (
    (4, 4, 40, 40, True, 0, 0, 16, 16),
    (4, 1, 24, 56, True, 16, 32, 64, 64),
    (4, 4, 33, 33, False, 0, 0, 192, 128),
    (4, 1, 20, 40, True, 0, -8, 256, 256),     # rows 0-7 see no key
    (4, 1, 30, 45, False, 8, 10, 64, 64),
    (2, 2, 50, 50, True, 512, 0, 128, 128),
)


def _jax_vjp(q, k, v, do, causal, window, q_offset):
    """The reference's gradient, one jitted program (forward and vjp)."""
    def f(q_, k_, v_):
        return jattn.chunked_attention(q_, k_, v_, causal=causal,
                                       window=window, q_offset=q_offset,
                                       chunk=k.shape[2])

    @jax.jit
    def grads(q_, k_, v_, do_):
        return jax.vjp(f, q_, k_, v_)[1](do_)
    return [np.asarray(g) for g in grads(*(jnp.asarray(x)
                                           for x in (q, k, v, do)))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_bwd_ref_matches_autograd_and_reference(case):
    h, hkv, sq, skv, causal, window, off, d, dv = case
    rng = np.random.default_rng(sq * skv + d)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, h, sq, d), (2, hkv, skv, d), (2, hkv, skv, dv), (2, h, sq, dv)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal, window, off,
                                 return_lse=True)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal, window,
                                  off)
    # torch.autograd through the plain forward
    lq, lk, lv = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    flash_attention_ref(lq, lk, lv, causal, window, off).backward(tdo)
    for g, w in zip(got, (lq.grad, lk.grad, lv.grad)):
        torch.testing.assert_close(g, w, **TOL)
    # jax.vjp of the reference's chunked_attention
    for g, w in zip(got, _jax_vjp(q, k, v, do, causal, window, off)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # the log-sum-exp: -inf exactly where a row sees no key, and those
    # rows' dq is 0
    s = (tq / d ** 0.5) @ \
        tk.repeat_interleave(h // hkv, 1).transpose(-1, -2)
    qpos = torch.arange(sq)[:, None] + off
    kpos = torch.arange(skv)[None, :]
    seen = ~((causal & (kpos > qpos))
             | ((window > 0) & (kpos <= qpos - window)))
    want_lse = torch.logsumexp(s.masked_fill(~seen, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=2e-6, atol=2e-6)
    dead = ~seen.any(dim=-1)
    assert bool((got[0][:, :, dead] == 0).all())
    # the wrapper's autograd Function takes the plain versions on the CPU
    before = dict(launch_counts)
    fq, fk, fv = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    out = fa_ops.flash_attention(fq, fk, fv, causal, window, off)
    assert torch.equal(out, o)
    out.backward(tdo)
    for g, w in zip((fq.grad, fk.grad, fv.grad), got):
        assert torch.equal(g, w)
    assert dict(launch_counts) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_bwd_ref_matches_autograd_and_reference(dtype):
    """F = 0 (no interaction), 1, 39 at D = 10; bfloat16 rounds the float32
    gradient once (within one bfloat16 step, 1e-2, of the float32 one)."""
    for b, f, d in ((5, 0, 10), (7, 1, 10), (64, 39, 10), (3, 4, 128)):
        rng = np.random.default_rng(b + f + d)
        e = rng.standard_normal((b, f, d)).astype(np.float32)
        g = rng.standard_normal(b).astype(np.float32)
        te = torch.from_numpy(e).to(dtype)
        got = fm_interaction_bwd_ref(te, torch.from_numpy(g))
        assert got.dtype == dtype and got.shape == (b, f, d)
        le = te.float().clone().requires_grad_(True)
        fm_interaction_ref(le).backward(torch.from_numpy(g))
        tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(got.float(), le.grad, **tol)
        want = np.asarray(J_FM_VJP(jnp.asarray(te.float().numpy()),
                                   jnp.asarray(g)))
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
        # the wrapper's autograd Function
        fe = te.clone().requires_grad_(True)
        fm_ops.fm_interaction(fe).backward(torch.from_numpy(g))
        assert torch.equal(fe.grad, got)


def test_embedding_gradient_is_a_sorted_sum():
    """gather.embedding: rows equal plain indexing; the table's gradient
    (a segment_reduce sum in the ids' sorted order) equals a dense
    index_add_, also for a 1-D table and a shared sorted index; without a
    gradient it is plain indexing."""
    rng = np.random.default_rng(0)
    v, dim = 50, 6
    ids = torch.from_numpy(rng.integers(0, v, (7, 9)))
    ids[0, :4] = 3  # repeats
    table = torch.from_numpy(rng.standard_normal((v, dim)).astype(np.float32))
    lin = torch.from_numpy(rng.standard_normal(v).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((7, 9, dim)).astype(np.float32))
    cot1 = torch.from_numpy(rng.standard_normal((7, 9)).astype(np.float32))
    t = table.clone().requires_grad_(True)
    l1 = lin.clone().requires_grad_(True)
    index = gather.sorted_index(ids.reshape(-1), v, counts=False)
    assert index.counts is None
    out, out1 = gather.embedding(t, ids, index), gather.embedding(l1, ids,
                                                                  index)
    assert torch.equal(out, table[ids]) and torch.equal(out1, lin[ids])
    (torch.sum(out * cot) + torch.sum(out1 * cot1)).backward()
    want = torch.zeros(v, dim).index_add_(0, ids.reshape(-1),
                                          cot.reshape(-1, dim))
    want1 = torch.zeros(v).index_add_(0, ids.reshape(-1), cot1.reshape(-1))
    torch.testing.assert_close(t.grad, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l1.grad, want1, rtol=1e-6, atol=1e-6)
    unused = ~torch.isin(torch.arange(v), ids)
    assert bool(unused.any()) and bool((t.grad[unused] == 0).all())
    with torch.no_grad():
        assert torch.equal(gather.embedding(t, ids), table[ids])
