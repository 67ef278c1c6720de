"""zamba2-7b [hybrid] — Mamba2 backbone with shared attention blocks.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242]

Stack: repeating groups of 5 Mamba2 blocks followed by one *shared*
attention+MLP block (Zamba's single attention parameter set reused at every
attention position); 13 groups of 6 = 78 layers + 3 trailing Mamba2 blocks.
Mamba2 geometry: d_inner = 2*d = 7168, head P=64 -> 112 SSD heads, state 64.
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        d_model=3584,
        vocab=32000,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        ssm_state=64,
        ssm_heads=112,
        ssm_head_dim=64,
        pattern=(
            Block("mamba2", "none"),
            Block("mamba2", "none"),
            Block("mamba2", "none"),
            Block("mamba2", "none"),
            Block("mamba2", "none"),
            Block("gqa", "dense", shared_attn=True),
        ),
        n_pattern_repeats=13,
        suffix=(Block("mamba2", "none"),) * 3,
    )
)

register(
    ModelConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        ssm_state=16,
        ssm_heads=8,
        ssm_head_dim=16,
        pattern=(
            Block("mamba2", "none"),
            Block("gqa", "dense", shared_attn=True),
        ),
        n_pattern_repeats=2,
        suffix=(Block("mamba2", "none"),),
    )
)
