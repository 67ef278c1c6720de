"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892]

32L d_model=2560 d_ff=8960 vocab=65536. RWKV's channel-mixer is a 2-matrix
FFN (squared-ReLU keyed), so ``mlp_gated=False``. Attention-free => runs the
``long_500k`` cell.
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        d_model=2560,
        vocab=65536,
        d_ff=8960,
        mlp_gated=False,
        pattern=(Block("rwkv6", "dense"),),
        n_pattern_repeats=32,
    )
)

register(
    ModelConfig(
        name="rwkv6-3b-smoke",
        family="ssm",
        d_model=64,
        vocab=512,
        d_ff=128,
        mlp_gated=False,
        pattern=(Block("rwkv6", "dense"),),
        n_pattern_repeats=2,
    )
)
