"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified].  A copy of
``repro.configs.command_r_35b``.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no-bias.
Pure full attention -> long_500k skipped (DESIGN.md §5).
"""
from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LMConfig

ARCH = Arch(
    id="command-r-35b",
    family="lm",
    source="hf:CohereForAI/c4ai-command-r-v01",
    config=LMConfig(
        name="command-r-35b",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab=256000,
        rope_theta=8_000_000.0,
        dtype="bfloat16",
    ),
    smoke=LMConfig(
        name="command-r-smoke",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=1,
        head_dim=16,
        d_ff=352,
        vocab=512,
        dtype="float32",
        remat=False,
        attn_chunk=64,
    ),
    shapes=lm_shapes(long_ok=False),
    skip_notes={"long_500k": "pure full-attention stack (assignment: skip)"},
)
