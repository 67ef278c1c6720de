"""gemma3-1b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt]

26L d_model=1152 4H (GQA kv=1) head_dim=256 d_ff=6912 vocab=262144.
Pattern: 5 sliding-window (512) layers then 1 global layer; 26 = 4*6 + 2.
Tied embeddings. The sliding window makes this arch sub-quadratic, so it
runs the ``long_500k`` cell (DESIGN.md §5).
"""
from .base import Block, ModelConfig, register

_LOCAL = Block("swa", "dense", window=512)
_GLOBAL = Block("gqa", "dense")

register(
    ModelConfig(
        name="gemma3-1b",
        family="dense",
        d_model=1152,
        vocab=262144,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
        n_pattern_repeats=4,
        suffix=(_LOCAL, _LOCAL),
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )
)

register(
    ModelConfig(
        name="gemma3-1b-smoke",
        family="dense",
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        pattern=(Block("swa", "dense", window=8), Block("gqa", "dense")),
        n_pattern_repeats=2,
        tie_embeddings=True,
    )
)
