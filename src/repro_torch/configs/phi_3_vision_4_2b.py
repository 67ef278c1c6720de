"""phi-3-vision-4.2b [vlm] — phi3-mini text backbone + CLIP frontend (stub).

32L d_model=3072 32H (MHA, kv=32) d_ff=8192 vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct]

The vision frontend (CLIP ViT-L/14 + projector) is a stub per the
assignment: ``input_specs()`` supplies precomputed patch embeddings
(``frontend_tokens`` positions prepended to the text sequence).
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        d_model=3072,
        vocab=32064,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        pattern=(Block("gqa", "dense"),),
        n_pattern_repeats=32,
        rope_theta=10_000.0,
        frontend="vision",
        frontend_tokens=256,
    )
)

register(
    ModelConfig(
        name="phi-3-vision-4.2b-smoke",
        family="vlm",
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        pattern=(Block("gqa", "dense"),),
        n_pattern_repeats=2,
        frontend="vision",
        frontend_tokens=8,
    )
)
