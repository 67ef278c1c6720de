"""deepseek-v3-671b [moe] — MLA + fine-grained MoE (1 shared + 256 routed,
top-8), dense first-3 layers. [arXiv:2412.19437]

61L d_model=7168 128H (MLA) vocab=129280; routed experts d_ff=2048, dense
layers d_ff=18432. MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
v=128. MTP (multi-token prediction) is exposed as an optional extra head in
the train step (``train/losses.py``), not part of the backbone stack.

Optimizer moments are kept in bf16 for this config (DESIGN.md §6) so the
512-chip dry-run fits v5e HBM; DeepSeek-V3 itself trained with low-precision
states (fp8 weights / bf16 moments).
"""
from .base import Block, ModelConfig, register

register(
    ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        d_model=7168,
        vocab=129280,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,  # qk_nope
        v_head_dim=128,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        d_ff=18432,  # dense prefix layers
        n_experts=256,
        n_shared_experts=1,
        top_k=8,
        moe_d_ff=2048,
        prefix=(Block("mla", "dense"),) * 3,
        pattern=(Block("mla", "moe"),),
        n_pattern_repeats=58,
        rope_theta=10_000.0,
        optimizer_state_dtype="bfloat16",
        optimizer_factored=True,  # full AdamW state alone would fill a pod
        fsdp_over_pods=True,  # multi-pod: ZeRO spans DCN (params > pod HBM)
    )
)

register(
    ModelConfig(
        name="deepseek-v3-671b-smoke",
        family="moe",
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
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        moe_d_ff=32,
        prefix=(Block("mla", "dense"),),
        pattern=(Block("mla", "moe"),),
        n_pattern_repeats=2,
    )
)
