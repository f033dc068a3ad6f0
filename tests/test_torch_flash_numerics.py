"""The rounding of the tensor-core flash_attention kernel, emulated on the CPU.

For bfloat16 and float16 inputs the CUDA kernel (``flash_attention.cu``,
``flash_kernel_tc``) forms S = q k^T from the input-type q and k with
float32 sums, scales S by 1/sqrt(D) in float32, runs the online softmax in
float32 over kv tiles of 64 keys (32 at D > 128), and multiplies P with V on
the tensor cores, whose operands are in the input type.  It splits P into
P_hi = round(P) and P_lo = round(P - P_hi) and adds both products.

``emulate`` repeats those steps in plain PyTorch.  The tests show that they
stay within ``torch_parity.flash_error_ratio`` <= 1 of the plain version
(``flash_attention_ref``, float32 throughout) on every ``FLASH_SHAPES`` case
at D in {8, 36, 64, 256}, and that rounding P once instead would not: that
tolerance is one step of the output's rounding.  The kernel itself is held
against the plain version on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro_torch.kernels.flash_attention import ablation  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask, flash_attention_ref)

DTYPES = (torch.bfloat16, torch.float16)


def emulate(q, k, v, causal=True, window=0, q_offset=0, split=True):
    """The kernel's arithmetic for 16-bit q, k, v; ``split=False`` rounds P
    once to the input type before the P V product."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bk = 32 if d > 128 else 64
    group = h // k.shape[1]
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = (q.float() @ kk.transpose(-1, -2)) * (1.0 / d ** 0.5)
    s = s.masked_fill(attention_mask(sq, skv, causal, window, q_offset,
                                     q.device), float("-inf"))
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, bk):
        st, vt = s[..., k0:k0 + bk], vv[:, :, k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(st - m_safe)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = corr * l + p.sum(dim=-1, keepdim=True)
        hi = p.to(q.dtype).float()
        acc = acc * corr + hi @ vt
        if split:
            acc = acc + (p - hi).to(q.dtype).float() @ vt
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def worst_ratio(d, dtype, split=True):
    """The largest ``flash_error_ratio`` of the emulation over the
    ``FLASH_SHAPES`` cases, with the inputs of ``test_torch_gpu.py``."""
    worst = 0.0
    for h, hkv, sq, skv, causal, window, off in tp.FLASH_SHAPES:
        q, k, v = tp.qkv(2, h, hkv, sq, skv, d, dtype, seed=sq + skv + d,
                         device="cpu")
        want = flash_attention_ref(q, k, v, causal, window, off)
        got = emulate(q, k, v, causal, window, off, split)
        assert got.dtype == dtype and got.shape == want.shape
        # rows that see no key are exactly 0, as in the Pallas kernel
        dead = want.float().abs().amax(dim=-1) == 0
        assert bool((got[dead] == 0).all())
        worst = max(worst, tp.flash_error_ratio(got, want))
    return worst


@pytest.mark.parametrize("d", [8, 36, 64, 256])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
def test_split_p_is_within_the_tolerance(dtype, d):
    assert worst_ratio(d, dtype) <= 1


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16"])
def test_one_rounding_of_p_is_outside_the_tolerance(dtype):
    # the reason for the split: P rounded once to the input type is more
    # than one step of the output's rounding away from the plain version
    assert max(worst_ratio(d, dtype, split=False) for d in (8, 64)) > 1


def test_emulation_in_float32_is_the_plain_version():
    # with no rounding of P the tiled online softmax is the plain version's
    # softmax up to float32 sums in another order
    for h, hkv, sq, skv, causal, window, off in tp.FLASH_SHAPES[:3]:
        q, k, v = tp.qkv(1, h, hkv, sq, skv, 64, torch.float32, seed=sq,
                         device="cpu")
        got = emulate(q, k, v, causal, window, off)
        want = flash_attention_ref(q, k, v, causal, window, off)
        assert tp.flash_error_ratio(got, want) <= 1


def test_ablation_variants_edit_the_kernel():
    # each variant of the card-side ablation changes text that the kernel
    # has, once, so it measures what it names
    text = ablation.SOURCE.read_text()
    for name, (_, edits) in ablation.VARIANTS.items():
        for old, _new in edits:
            assert text.count(old) == 1, (name, old)
