"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].  A copy of
``repro.configs.moonshot_v1_16b``.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
(+2 shared, DeepSeek-V3-style arch).  Pure full attention -> long_500k
skipped.
"""
from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LMConfig

ARCH = Arch(
    id="moonshot-v1-16b-a3b",
    family="lm",
    source="hf:moonshotai/Moonlight-16B-A3B",
    config=LMConfig(
        name="moonshot-v1-16b-a3b",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        vocab=163840,
        moe=True,
        n_experts=64,
        n_shared=2,
        top_k=6,
        d_expert=1408,
        d_ff=1408,
        rope_theta=50_000.0,
        dtype="bfloat16",
    ),
    smoke=LMConfig(
        name="moonshot-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        moe=True,
        n_experts=8,
        n_shared=2,
        top_k=2,
        d_expert=48,
        d_ff=48,
        vocab=512,
        dtype="float32",
        remat=False,
        attn_chunk=32,
    ),
    shapes=lm_shapes(long_ok=False),
    skip_notes={"long_500k": "pure full-attention stack (assignment: skip)"},
)
