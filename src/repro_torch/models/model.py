"""Top-level model API.

``init_params`` / ``forward`` / ``prefill`` / ``init_cache`` +
``decode_step``, with the JAX package's signatures plus ``device=`` where a
tensor is made. Modality frontends are stubs, as there: ``frontend_embeds``
(precomputed patch/conditioning embeddings) are prepended to the token
embeddings and logits cover the text positions only, so ``seq_len`` always
means the *total* sequence the backbone processes. ``forward_hidden``,
``forward`` and ``prefill`` return the aux the JAX package's return: the MoE
blocks' ``moe_balance_loss``, ``moe_dropped_frac`` and ``moe_router_zloss``,
each summed over the layers in f32 (``{}`` for a model without MoE).
``forward_hidden`` and ``forward`` are differentiable (``train/train_step.py``
takes their gradients; they build no graph unless a parameter requires one);
``init_params``, ``init_cache``, ``decode_step`` and ``prefill`` run under
``torch.no_grad``.
"""
from __future__ import annotations

import torch

from .hints import constrain_activation
from .layers import embed_apply, embed_init, rmsnorm, rmsnorm_init, unembed_apply
from .transformer import pick_chunk, stack_apply, stack_decode, stack_init, stack_init_cache

Tensor = torch.Tensor


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _generator(seed_or_gen, device) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_or_gen))
    return gen


@torch.no_grad()
def init_params(cfg, generator: torch.Generator | int = 0, *, device="cuda") -> dict:
    """Random weights from a seed or a ``torch.Generator`` on ``device``."""
    device = torch.device(device)
    dtype = param_dtype(cfg)
    gen = _generator(generator, device)
    p = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
        "stack": stack_init(gen, cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
    return p


def _table(p: dict, cfg) -> Tensor:
    return p["embed"] if cfg.tie_embeddings else p["unembed"]


def _embed_inputs(p: dict, cfg, tokens: Tensor, frontend_embeds: Tensor | None) -> Tensor:
    x = embed_apply(p["embed"], tokens)
    if cfg.tie_embeddings:  # gemma-style embed scaling
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    if cfg.frontend:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name} needs frontend_embeds")
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    # pin the embedding-gather output's layout before the stack, as the JAX
    # package does (a no-op unless the dry run installed one)
    return constrain_activation(x)


def forward_hidden(
    p: dict, cfg, tokens: Tensor, frontend_embeds: Tensor | None = None
) -> tuple[Tensor, dict]:
    """Backbone only: normalized final hidden states for the text positions."""
    x = _embed_inputs(p, cfg, tokens, frontend_embeds)
    x, aux = stack_apply(p["stack"], cfg, x, chunk=pick_chunk(x.shape[1]))
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    if cfg.frontend:
        x = x[:, cfg.frontend_tokens :]
    return x, aux


def forward(
    p: dict,
    cfg,
    tokens: Tensor,  # (B, S_text)
    frontend_embeds: Tensor | None = None,  # (B, frontend_tokens, d)
    *,
    return_hidden: bool = False,
) -> tuple[Tensor, dict]:
    """Full-sequence causal forward. Returns (logits (B, S_text, V) f32, aux);
    with ``return_hidden`` the normalized final hidden state rides along in
    ``aux['hidden']``."""
    x, aux = forward_hidden(p, cfg, tokens, frontend_embeds)
    if return_hidden:
        aux = dict(aux, hidden=x)
    return unembed_apply(_table(p, cfg), x), aux


@torch.no_grad()
def init_cache(cfg, batch: int, max_len: int, *, device="cuda") -> dict:
    dtype = param_dtype(cfg)
    return {
        "blocks": stack_init_cache(cfg, batch, max_len, dtype, torch.device(device)),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),  # per sequence
    }


@torch.no_grad()
def decode_step(p: dict, cfg, cache: dict, tokens: Tensor) -> tuple[Tensor, dict]:
    """One new token per sequence. tokens: (B, 1) -> logits (B, 1, V) f32.
    ``cache['length']`` is per-sequence, so ragged continuous batching works
    (serving/engine.py admits new requests into arbitrary slots). The k/v
    caches are updated in place; the returned cache holds them and a new
    length tensor (the input's ``length`` is left as it was)."""
    x = embed_apply(p["embed"], tokens)
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    length = cache["length"]
    x, new_blocks = stack_decode(p["stack"], cfg, x, cache["blocks"], length)
    x = rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = unembed_apply(_table(p, cfg), x)
    return logits, {"blocks": new_blocks, "length": length + 1}


@torch.no_grad()
def prefill(
    p: dict, cfg, tokens: Tensor, frontend_embeds: Tensor | None = None
) -> tuple[Tensor, dict]:
    """Inference prefill: forward pass, returns last-position logits + aux.
    The hidden state is sliced *before* unembedding so the (B, S, V) logits
    tensor never materializes — at 32k x 262k vocab that matters."""
    x, aux = forward_hidden(p, cfg, tokens, frontend_embeds)
    return unembed_apply(_table(p, cfg), x[:, -1:]), aux
