"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284]

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048. The EnCodec/T5 frontend
is a stub per the assignment: conditioning frames arrive as precomputed
embeddings prepended to the token sequence (MusicGen supports prefix
conditioning); ungated FFN as in the original transformer decoder.
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="musicgen-medium",
        family="audio",
        d_model=1536,
        vocab=2048,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        mlp_gated=False,
        pattern=(Block("gqa", "dense"),),
        n_pattern_repeats=48,
        frontend="audio",
        frontend_tokens=64,
    )
)

register(
    ModelConfig(
        name="musicgen-medium-smoke",
        family="audio",
        d_model=64,
        vocab=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        mlp_gated=False,
        pattern=(Block("gqa", "dense"),),
        n_pattern_repeats=2,
        frontend="audio",
        frontend_tokens=8,
    )
)
