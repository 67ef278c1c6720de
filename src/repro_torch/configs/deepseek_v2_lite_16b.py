"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 2 shared + 64 routed
experts, top-6, first layer dense. [arXiv:2405.04434]

27L d_model=2048 16H vocab=102400, routed expert d_ff=1408, dense layer
d_ff=10944. V2-Lite projects q directly (no q LoRA).
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        d_model=2048,
        vocab=102400,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,  # qk_nope
        v_head_dim=128,
        q_lora_rank=0,  # direct q projection
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        d_ff=10944,  # dense first layer
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        prefix=(Block("mla", "dense"),),
        pattern=(Block("mla", "moe"),),
        n_pattern_repeats=26,
    )
)

register(
    ModelConfig(
        name="deepseek-v2-lite-16b-smoke",
        family="moe",
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        v_head_dim=16,
        kv_lora_rank=32,
        qk_rope_head_dim=8,
        d_ff=128,
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        moe_d_ff=32,
        prefix=(Block("mla", "dense"),),
        pattern=(Block("mla", "moe"),),
        n_pattern_repeats=2,
    )
)
