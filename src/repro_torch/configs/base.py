"""Model configuration system.

A model is a sequence of *blocks*; each block has a sequence **mixer**
(attention variant or SSM) and a **channel mixer** (dense MLP or MoE). The
stack is expressed as ``prefix`` blocks + a repeated ``pattern`` (+ an
automatically computed remainder), which is what lets heterogeneous
architectures (gemma3 5:1 local:global, zamba2 mamba+shared-attention,
deepseek dense-prefix+MoE) share one stack layout: the JAX package scans the
repeated pattern, the port's ``models/transformer.py`` loops over it.

All 10 assigned architectures are instances of this one config class; see
``src/repro_torch/configs/<arch>.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

MixerKind = Literal["gqa", "mla", "swa", "mamba2", "rwkv6"]
MlpKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class Block:
    mixer: MixerKind
    mlp: MlpKind = "dense"
    window: int = 0  # >0: sliding-window ("swa" local) attention span
    shared_attn: bool = False  # zamba2: one attention param set reused


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab: int
    # attention geometry (ignored by pure-SSM blocks)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    v_head_dim: int = 0  # defaults to head_dim
    # MLA geometry
    q_lora_rank: int = 0  # 0 = direct q projection
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0  # decoupled RoPE dims (MLA)
    # channel mixer
    d_ff: int = 0
    mlp_gated: bool = True  # SwiGLU (3 mats) vs classic 2-mat FFN
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_heads: int = 0  # mamba2 heads (d_inner // head P)
    ssm_head_dim: int = 64
    d_conv: int = 4
    # stack structure
    prefix: tuple[Block, ...] = ()
    pattern: tuple[Block, ...] = ()
    n_pattern_repeats: int = 0
    suffix: tuple[Block, ...] = ()
    # embeddings / misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = ""  # "vision" | "audio" | "" — stubbed modality frontend
    frontend_tokens: int = 0  # patches / conditioning frames prepended
    # numerics
    dtype: str = "bfloat16"
    # training
    remat: bool = True
    optimizer_state_dtype: str = "float32"  # bf16 for the largest models
    optimizer_factored: bool = False  # Adafactor-style v (671B config)
    fsdp_over_pods: bool = False  # ZeRO spans DCN when state > pod HBM

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.v_head_dim == 0 and self.head_dim:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        if not self.pattern and not self.prefix and not self.suffix:
            raise ValueError("empty stack")

    @property
    def blocks(self) -> tuple[Block, ...]:
        return self.prefix + self.pattern * self.n_pattern_repeats + self.suffix

    @property
    def n_layers(self) -> int:
        return len(self.blocks)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return 2 * self.d_model

    @property
    def uses_attention(self) -> bool:
        return any(b.mixer in ("gqa", "mla", "swa") for b in self.blocks)

    @property
    def pure_full_attention(self) -> bool:
        """True when every sequence mixer is unwindowed softmax attention —
        these archs skip the ``long_500k`` cell (DESIGN.md §5)."""
        return all(b.mixer in ("gqa", "mla") for b in self.blocks)

    # -- analytic parameter counts (exact for our parameterization) -------
    def mixer_params(self, b: Block) -> int:
        d = self.d_model
        n = 0
        if b.mixer in ("gqa", "swa"):
            n += d * self.n_heads * self.head_dim  # wq
            n += 2 * d * self.n_kv_heads * self.head_dim  # wk, wv
            n += self.n_heads * self.v_head_dim * d  # wo
        elif b.mixer == "mla":
            qk_nope = self.head_dim
            if self.q_lora_rank:
                n += d * self.q_lora_rank + self.q_lora_rank  # q_down + q_norm
                n += self.q_lora_rank * self.n_heads * (qk_nope + self.qk_rope_head_dim)
            else:
                n += d * self.n_heads * (qk_nope + self.qk_rope_head_dim)
            n += d * (self.kv_lora_rank + self.qk_rope_head_dim)  # down + k_rope
            n += self.kv_lora_rank  # kv_norm
            n += self.kv_lora_rank * self.n_heads * (qk_nope + self.v_head_dim)  # up
            n += self.n_heads * self.v_head_dim * d  # wo
        elif b.mixer == "mamba2":
            din, hs = self.d_inner, self.ssm_state
            nh = self.ssm_heads
            conv_dim = din + 2 * hs
            n += d * (2 * din + 2 * hs + nh)  # in_proj -> z, x, B, C, dt
            n += conv_dim * self.d_conv  # depthwise conv
            n += 3 * nh  # A_log, D, dt_bias
            n += din  # gated RMSNorm
            n += din * d  # out_proj
        elif b.mixer == "rwkv6":
            # r,k,v,g,w projections + token-shift loras + output
            n += 4 * d * d  # r, k, v, g
            n += d * 64 + 64 * d  # w lora (decay)
            n += 5 * d  # per-channel mu for token shift
            n += 2 * d  # u bonus, w bias
            n += 2 * d  # per-head groupnorm affine
            n += d * d  # output proj
        return n

    def mlp_params(self, b: Block) -> int:
        d = self.d_model
        mats = 3 if self.mlp_gated else 2
        if b.mlp == "dense":
            return mats * d * self.d_ff
        if b.mlp == "moe":
            return (
                (self.n_experts + self.n_shared_experts) * mats * d * self.moe_d_ff
                + d * self.n_experts  # router
            )
        return 0

    def block_params(self, b: Block) -> int:
        norms = self.d_model * (2 if b.mlp != "none" else 1)
        return self.mixer_params(b) + self.mlp_params(b) + norms

    def param_count(self) -> int:
        n = self.vocab * self.d_model  # embedding
        if not self.tie_embeddings:
            n += self.vocab * self.d_model
        n += self.d_model  # final norm
        seen_shared = False
        for b in self.blocks:
            if b.shared_attn:
                # zamba-style: one shared attention parameter set
                n += self.block_params(b) - (self.mixer_params(b) if seen_shared else 0)
                seen_shared = True
            else:
                n += self.block_params(b)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only) —
        the N in MODEL_FLOPS = 6·N_active·D for the roofline."""
        if self.n_experts == 0:
            return self.param_count()
        n = self.param_count()
        for b in self.blocks:
            if b.mlp == "moe":
                inactive = (self.n_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff
                n -= inactive
        return n


# Registry populated by the per-arch config modules
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        from . import _load_all  # noqa: F401  (populates the registry)

        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
