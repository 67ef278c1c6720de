"""internlm2-1.8b [dense] — GQA. [arXiv:2403.17297]

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        d_model=2048,
        vocab=92544,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        pattern=(Block("gqa", "dense"),),
        n_pattern_repeats=24,
        rope_theta=1_000_000.0,
    )
)

register(
    ModelConfig(
        name="internlm2-1.8b-smoke",
        family="dense",
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        pattern=(Block("gqa", "dense"),),
        n_pattern_repeats=2,
    )
)
