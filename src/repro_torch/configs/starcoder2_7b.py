"""starcoder2-7b [dense] — GQA + RoPE, classic (ungated) FFN.
[arXiv:2402.19173]

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="starcoder2-7b",
        family="dense",
        d_model=4608,
        vocab=49152,
        n_heads=36,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        mlp_gated=False,  # StarCoder2 uses a standard 2-matrix FFN
        pattern=(Block("gqa", "dense"),),
        n_pattern_repeats=32,
        rope_theta=100_000.0,
    )
)

register(
    ModelConfig(
        name="starcoder2-7b-smoke",
        family="dense",
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        mlp_gated=False,
        pattern=(Block("gqa", "dense"),),
        n_pattern_repeats=2,
    )
)
