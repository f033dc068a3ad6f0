"""InternLM2 20B [arXiv:2403.17297; hf].  A copy of
``repro.configs.internlm2_20b``.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
Pure full attention -> long_500k skipped (DESIGN.md §5).
"""
from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LMConfig

ARCH = Arch(
    id="internlm2-20b",
    family="lm",
    source="arXiv:2403.17297",
    config=LMConfig(
        name="internlm2-20b",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=92544,
        rope_theta=1_000_000.0,
        dtype="bfloat16",
    ),
    smoke=LMConfig(
        name="internlm2-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=1,
        head_dim=16,
        d_ff=256,
        vocab=512,
        dtype="float32",
        remat=False,
        attn_chunk=64,
    ),
    shapes=lm_shapes(long_ok=False),
    skip_notes={"long_500k": "pure full-attention stack (assignment: skip)"},
)
