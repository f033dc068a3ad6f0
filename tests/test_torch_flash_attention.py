"""The port's attention against the JAX package, on the CPU: the plain
version of the flash_attention kernel, ``chunked_attention`` and
``decode_attention``.

Inputs are made with numpy from a seed and handed to both packages.  The
cases are those of ``tests/test_kernel_flash_attention.py`` (MHA, MQA, GQA
4:1, Sq != Skv with ``q_offset``, windows 16/64/100, bfloat16, Sq = 1);
each is held against the reference's Pallas kernel in interpret mode and
against its oracle ``mha_ref``.  Values with a width of their own (MLA's
D = 192, Dv = 128) are held against the reference's ``chunked_attention``,
which takes them.  Tolerances: rtol = atol = 2e-5 in float32
(the reference test's; the softmax runs in another order), and 1e-2 in
bfloat16, one bfloat16 step at |o| <= 2 (both packages compute in float32
and round the output once).  Rows whose every key is masked are compared
with the Pallas kernel only: ``mha_ref`` gives NaN there, the kernel and
the port 0.

The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas  # noqa: E402,E501
from repro.kernels.flash_attention.ref import mha_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402,E501
from repro_torch.models import attention as attn  # noqa: E402


def _qkv(b, h, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


# (b, h, hkv, sq, skv, d, bq, bk, causal, window, q_offset, dtype, seed)
CASES = {
    "mha": (1, 2, 2, 128, 128, 32, 64, 64, True, 0, 0, "float32", 160),
    "mqa": (2, 4, 1, 128, 128, 16, 64, 64, True, 0, 0, "float32", 144),
    "gqa4": (1, 8, 2, 256, 256, 64, 128, 128, True, 0, 0, "float32", 320),
    "cross_offset": (1, 2, 2, 64, 256, 32, 64, 64, True, 0, 192, "float32",
                     96),
    "asym_blocks": (2, 2, 1, 128, 128, 8, 32, 128, True, 0, 0, "float32",
                    136),
    "noncausal": (1, 2, 2, 128, 128, 32, 64, 64, False, 0, 0, "float32", 1),
    "window16": (1, 2, 1, 128, 128, 32, 32, 32, True, 16, 0, "float32", 16),
    "window64": (1, 2, 1, 128, 128, 32, 32, 32, True, 64, 0, "float32", 64),
    "window100": (1, 2, 1, 128, 128, 32, 32, 32, True, 100, 0, "float32",
                  100),
    "bf16": (1, 4, 2, 128, 128, 64, 64, 64, True, 0, 0, "bfloat16", 9),
    "decode": (2, 4, 2, 1, 256, 32, 1, 64, True, 0, 255, "float32", 3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_and_oracle(name):
    b, h, hkv, sq, skv, d, bq, bk, causal, window, off, dtype, seed = \
        CASES[name]
    q, k, v = _qkv(b, h, hkv, sq, skv, d, seed)
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              q_offset=off)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 1e-2 if dtype == "bfloat16" else 2e-5
    for want in (flash_attention_pallas(jq, jk, jv, causal=causal,
                                        window=window, q_offset=off,
                                        bq=bq, bk=bk),
                 mha_ref(jq, jk, jv, causal=causal, window=window,
                         q_offset=off)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_fully_masked_rows_give_zero():
    # causal with a negative offset: the first 16 queries see no key;
    # non-causal with a window past the keys: queries from 39 on see none
    for sq, skv, causal, window, off, dead in ((64, 64, True, 0, -16, 16),
                                               (64, 32, False, 8, 32, 7)):
        q, k, v = _qkv(1, 4, 2, sq, skv, 16, seed=sq + skv)
        want = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, q_offset=off, bq=32, bk=32))
        got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window,
                                  q_offset=off).numpy()
        masked = slice(0, dead) if causal else slice(dead, sq)
        live = slice(dead, sq) if causal else slice(0, dead)
        assert (got[:, :, masked] == 0).all() and (want[:, :, masked] == 0).all()
        assert np.abs(got[:, :, live]).min(axis=-1).max() > 0
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_attention_paths_match_reference():
    """``chunked_attention`` (windows 0 and 16) and ``decode_attention``
    (global and windowed, float32 and a bfloat16 cache) against the JAX
    package's."""
    q, k, v = _qkv(2, 4, 2, 64, 64, 16, seed=0)
    for window in (0, 16):
        want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                       causal=True, window=window, chunk=16)
        got = attn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=True, window=window, chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
        plain = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                    window=window)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                                   atol=2e-5)
    q1, kc, vc = _qkv(2, 4, 2, 1, 48, 16, seed=5)
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 1e-2)):
        for window, cache_len in ((0, 40), (8, 33)):
            want = jattn.decode_attention(
                *(jnp.asarray(x).astype(dtype) for x in (q1, kc, vc)),
                cache_len, window=window)
            got = attn.decode_attention(
                *(torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q1, kc, vc)), cache_len, window=window)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)
    rep = attn.repeat_kv(torch.from_numpy(k), 4)
    np.testing.assert_array_equal(rep.numpy(),
                                  np.asarray(jattn.repeat_kv(jnp.asarray(k), 4)))


def test_wrapper_on_cpu_takes_plain_version_and_checks_inputs():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 20, 37, 8, seed=2))
    before = dict(kernels.launch_counts)
    got = ops.flash_attention(q, k, v, causal=True, window=5, q_offset=17)
    assert torch.equal(got, flash_attention_ref(q, k, v, True, 5, 17))
    assert dict(kernels.launch_counts) == before  # no launch on the CPU
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :1].expand(1, 3, 37, 8), v)  # 4 % 3
    with pytest.raises(ValueError):
        ops.flash_attention(q[0], k, v)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k, v)


@pytest.mark.parametrize("case", [
    # (h, hkv, sq, skv, d, dv, causal, window, q_offset)
    (4, 4, 64, 64, 192, 128, True, 0, 0),      # MLA's widths
    (4, 2, 32, 96, 24, 16, True, 16, 64),      # GQA, a window, an offset
])
def test_plain_with_value_width_matches_chunked(case):
    h, hkv, sq, skv, d, dv, causal, window, off = case
    q, k, _ = _qkv(2, h, hkv, sq, skv, d, seed=d + dv)
    v = np.random.default_rng(dv).standard_normal(
        (2, hkv, skv, dv)).astype(np.float32)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, window=window,
                                   q_offset=off, chunk=32)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window, q_offset=off)
    assert got.shape == (2, h, sq, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    mine = attn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window, q_offset=off,
                                  chunk=32)
    np.testing.assert_allclose(got.numpy(), mine.numpy(), rtol=2e-5,
                               atol=2e-5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="Dv"):
        ops.flash_attention(tq, tk, torch.zeros((2, hkv, skv, 257)))
    with pytest.raises(ValueError, match="Dv"):
        ops.flash_attention(tq, tk, tv[:, :, :-1])
