"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf].  A copy of
``repro.configs.deepseek_v2_lite``.

27L d_model=2048 16H d_ff=1408(expert) vocab=102400, MLA kv_lora=512,
MoE 64 routed experts top-6 + 2 shared.  Pure full attention (MLA) ->
long_500k skipped.  (The assignment text lists both "64e top-6" and
"160 routed"; we follow the headline 64e top-6 + 2 shared, which matches
the released V2-Lite checkpoint.)
"""
from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LMConfig

ARCH = Arch(
    id="deepseek-v2-lite-16b",
    family="lm",
    source="arXiv:2405.04434",
    config=LMConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        vocab=102400,
        attn_kind="mla",
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        moe=True,
        n_experts=64,
        n_shared=2,
        top_k=6,
        d_expert=1408,
        d_ff=1408,
        rope_theta=10_000.0,
        dtype="bfloat16",
    ),
    smoke=LMConfig(
        name="deepseek-v2-lite-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        attn_kind="mla",
        kv_lora_rank=32,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
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
