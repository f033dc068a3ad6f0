"""Gemma-3 1B [hf:google/gemma-3-1b-pt; unverified].  A copy of
``repro.configs.gemma3_1b``.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 — 5:1 local:global
sliding-window attention (window 512), 128k+ context.  Hybrid attention ->
long_500k RUNS for this arch (only 1-in-6 layers pay O(S) at decode).
"""
from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LMConfig

ARCH = Arch(
    id="gemma3-1b",
    family="lm",
    source="hf:google/gemma-3-1b-pt",
    config=LMConfig(
        name="gemma3-1b",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab=262144,
        window=512,
        local_ratio=5,
        rope_theta=1_000_000.0,
        dtype="bfloat16",
    ),
    smoke=LMConfig(
        name="gemma3-smoke",
        n_layers=6,
        d_model=96,
        n_heads=4,
        n_kv_heads=1,
        head_dim=24,
        d_ff=192,
        vocab=512,
        window=16,
        local_ratio=5,
        dtype="float32",
        remat=False,
        attn_chunk=32,
    ),
    shapes=lm_shapes(long_ok=True),
)
