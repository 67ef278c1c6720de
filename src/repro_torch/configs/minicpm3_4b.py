"""minicpm3-4b [dense] — MLA attention. [hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448.
MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v=64.
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="minicpm3-4b",
        family="dense",
        d_model=2560,
        vocab=73448,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,  # qk_nope
        v_head_dim=64,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_rope_head_dim=32,
        d_ff=6400,
        pattern=(Block("mla", "dense"),),
        n_pattern_repeats=62,
    )
)

register(
    ModelConfig(
        name="minicpm3-4b-smoke",
        family="dense",
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        v_head_dim=16,
        q_lora_rank=32,
        kv_lora_rank=32,
        qk_rope_head_dim=8,
        d_ff=128,
        pattern=(Block("mla", "dense"),),
        n_pattern_repeats=2,
    )
)
