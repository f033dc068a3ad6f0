"""The rounding of the tensor-core flash_attention backward, emulated on the
CPU, before the kernel runs on the card.

For bfloat16 and float16 inputs the backward kernels
(``flash_attention_bwd_tc.cu``) form S = q k^T and dP = do v^T from the
input-type operands with float32 sums, scale S by 1/sqrt(D) after the
product, take P = exp(S - lse) (0 where masked or where lse is -inf) and
dS = P (dP - Dl) in float32, and round P and dS once to the input type,
because they enter the products dV = P^T do, dK = dS^T q and dQ = dS k on
the tensor cores; those sums are float32, and dq, dk, dv are rounded once
to the input type.  Dl = rowsum(do * o) comes from the forward's output o
in the input type.

``emulate`` repeats those steps in plain PyTorch on whole matrices (the
kernels' tiles change only the order of float32 sums).  Each case holds it
against ``jax.vjp`` of the reference's ``chunked_attention`` (under
``jax.jit``, in float32 on the 16-bit values) and against the plain
version ``flash_attention_bwd_ref`` (the yardstick of ``chip_smoke.py``
(t)), and asserts that the largest relative L2 distance of dq, dk and dv
stays within half the 2e-2 gate of (t); it prints the distances, with
the plain version's own distance to the reference beside them.  One
rounding of P and dS (as FlashAttention-2 and PyTorch's SDPA have it)
adds about half of the plain version's distance, so the kernels need no
hi/lo split of P as the forward has.
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask, flash_attention_bwd_ref, flash_attention_ref)

GATE = 2e-2  # chip_smoke.py (t): 16-bit relative L2 to plain
# (D, Dv) of chip_smoke.FLASH_BWD_WIDTHS, one for each case
WIDTHS = ((16, 16), (64, 64), (128, 128), (192, 128), (256, 256))


def emulate(q, k, v, o, lse, do, causal, window, q_offset):
    """The backward kernels' arithmetic for 16-bit q, k, v, o, do: (dq, dk,
    dv) in the input type."""
    dtype = q.dtype
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    scale = 1.0 / d ** 0.5
    s = (q.float() @ kk.transpose(-1, -2)) * scale
    masked = attention_mask(sq, skv, causal, window, q_offset, q.device) | \
        torch.isneginf(lse)[..., None]
    p = torch.where(masked, 0.0, torch.exp(s - torch.where(
        torch.isneginf(lse), 0.0, lse)[..., None]))
    dp = do.float() @ vv.transpose(-1, -2)
    dl = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - dl)
    p16, ds16 = p.to(dtype).float(), ds.to(dtype).float()
    dq = (ds16 @ kk) * scale
    dkk = (ds16.transpose(-1, -2) @ q.float()) * scale
    dvv = p16.transpose(-1, -2) @ do.float()
    dk = dkk.reshape(b, hkv, group, skv, d).sum(dim=2)
    dv = dvv.reshape(b, hkv, group, skv, v.shape[3]).sum(dim=2)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _jax_grads(q, k, v, do, causal, window, q_offset):
    def f(q_, k_, v_):
        return jattn.chunked_attention(q_, k_, v_, causal=causal,
                                       window=window, q_offset=q_offset,
                                       chunk=k.shape[2])

    @jax.jit
    def grads(q_, k_, v_, do_):
        return jax.vjp(f, q_, k_, v_)[1](do_)
    return [torch.from_numpy(np.asarray(g)) for g in grads(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v, do)))]


def _worst(got, want) -> float:
    return max(float((g.float() - w.float()).norm()
                     / w.float().norm().clamp(min=1e-30))
               for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", range(len(tp.FLASH_SHAPES)))
def test_one_rounding_of_p_and_ds_stays_within_gate(case, dtype):
    h, hkv, sq, skv, causal, window, off = tp.FLASH_SHAPES[case]
    d, dv = WIDTHS[case % len(WIDTHS)]
    rng = np.random.default_rng(case)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype) for s in ((1, h, sq, d), (1, hkv, skv, d),
                                         (1, hkv, skv, dv), (1, h, sq, dv)))
    o, lse = flash_attention_ref(q, k, v, causal, window, off,
                                 return_lse=True)
    got = emulate(q, k, v, o, lse, do, causal, window, off)
    want = _jax_grads(q, k, v, do, causal, window, off)
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window, off)
    to_ref, to_plain = _worst(got, want), _worst(got, plain)
    # the plain version itself, rounded to the input type at its outputs
    plain_to_ref = _worst(plain, want)
    print(f"{tp.FLASH_SHAPES[case]} D={d} Dv={dv} {dtype}: emulated kernel "
          f"to the reference {to_ref:.3g}, to plain {to_plain:.3g}; plain "
          f"to the reference {plain_to_ref:.3g}")
    assert to_plain <= GATE / 2, to_plain
    assert to_ref <= GATE / 2, to_ref
    dead = torch.isneginf(lse)
    assert bool((got[0][dead] == 0).all())
