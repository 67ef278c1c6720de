"""Attention mixers: GQA (full / sliding-window), with flash attention for
prefill and cache-based decode.

Prefill attention goes through ``kernels.ops.flash_attention``: the CUDA
kernel on the card, its plain version :func:`blockwise_attention` (the
online-softmax twin the JAX model runs) on the CPU. Decode attention is plain
PyTorch, as the JAX package leaves it to jnp outside any kernel. MLA is not
ported yet (ROADMAP A7).
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import NEG_INF, blockwise_attention
from ..kernels.ops import flash_attention
from .layers import apply_rope, dense_init

__all__ = [
    "blockwise_attention",
    "decode_attention",
    "gqa_apply",
    "gqa_decode",
    "gqa_init",
    "gqa_init_cache",
]

Tensor = torch.Tensor


def _lengths(length, batch: int, device) -> Tensor:
    """Normalize scalar or (B,) lengths to (B,) int32 — per-sequence lengths
    are what continuous batching needs (serving/engine.py)."""
    return torch.as_tensor(length, dtype=torch.int32, device=device).expand(batch)


def _cache_write(cache: Tensor, new: Tensor, slots: Tensor) -> Tensor:
    """Per-sequence write of ``new`` (B, 1, ...) at row ``slots`` (B,) of
    ``cache`` (B, Smax, ...), in place; returns ``cache``. A row past the end
    is clamped to the last, as ``lax.dynamic_update_slice`` clamps it."""
    rows = slots.long().clamp(max=cache.shape[1] - 1)
    cache[torch.arange(cache.shape[0], device=cache.device), rows] = new[:, 0]
    return cache


def decode_attention(
    q: Tensor,  # (B, 1, H, Dk)
    k_cache: Tensor,  # (B, Smax, KH, Dk)
    v_cache: Tensor,  # (B, Smax, KH, Dv)
    length,  # () or (B,) int — valid entries (current token written)
    *,
    window: int = 0,
    scale: float | None = None,
) -> Tensor:
    B, _, H, Dk = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    scale = scale if scale is not None else Dk**-0.5
    lengths = _lengths(length, B, q.device)
    qf = q.reshape(B, KH, G, Dk).float() * scale
    s = torch.einsum("bkgd,bjkd->bkgj", qf, k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None, :] < lengths[:, None]  # (B, Smax)
    if window > 0:
        valid &= pos[None, :] >= (lengths[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA mixer (also sliding-window "swa")
# ---------------------------------------------------------------------------
def gqa_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, H, KH, Dh, Dv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    return {
        "wq": dense_init(gen, d, H * Dh, dtype, device),
        "wk": dense_init(gen, d, KH * Dh, dtype, device),
        "wv": dense_init(gen, d, KH * Dv, dtype, device),
        "wo": dense_init(gen, H * Dv, d, dtype, device),
    }


def gqa_apply(p: dict, cfg, x: Tensor, *, window: int = 0, chunk: int = 1024) -> Tensor:
    B, S, d = x.shape
    H, KH, Dh, Dv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    pos = torch.arange(S, device=x.device)
    q = apply_rope((x @ p["wq"]).reshape(B, S, H, Dh), pos, cfg.rope_theta)
    k = apply_rope((x @ p["wk"]).reshape(B, S, KH, Dh), pos, cfg.rope_theta)
    v = (x @ p["wv"]).reshape(B, S, KH, Dv)
    o = flash_attention(q, k, v, window=window, chunk=chunk)
    return o.reshape(B, S, H * Dv) @ p["wo"]


def gqa_init_cache(cfg, batch: int, max_len: int, window: int, dtype, device) -> dict:
    size = max_len if window == 0 else min(window, max_len)
    KH, Dh, Dv = cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    return {
        "k": torch.zeros((batch, size, KH, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, KH, Dv), dtype=dtype, device=device),
    }


def gqa_decode(
    p: dict, cfg, x: Tensor, cache: dict, length, *, window: int = 0
) -> tuple[Tensor, dict]:
    """One-token decode. ``length`` = tokens already in the cache, scalar or
    per-sequence (B,) for continuous batching. Sliding windows use a ring
    buffer of ``window`` slots. The new k/v are written into the cache in
    place (the JAX package returns fresh arrays); the returned dict holds the
    same tensors."""
    B, _, d = x.shape
    H, KH, Dh, Dv = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.v_head_dim
    lengths = _lengths(length, B, x.device)
    pos = lengths[:, None]  # (B, 1) rope positions
    q = apply_rope((x @ p["wq"]).reshape(B, 1, H, Dh), pos, cfg.rope_theta)
    k = apply_rope((x @ p["wk"]).reshape(B, 1, KH, Dh), pos, cfg.rope_theta)
    v = (x @ p["wv"]).reshape(B, 1, KH, Dv)
    size = cache["k"].shape[1]
    slots = lengths % size if window > 0 else lengths
    k_cache = _cache_write(cache["k"], k, slots)
    v_cache = _cache_write(cache["v"], v, slots)
    if window > 0:
        # ring buffer: everything currently stored is valid once warm
        eff_len = torch.clamp(lengths + 1, max=size)
        o = decode_attention(q, k_cache, v_cache, eff_len, window=0)
    else:
        o = decode_attention(q, k_cache, v_cache, lengths + 1, window=0)
    out = o.reshape(B, 1, H * Dv) @ p["wo"]
    return out, {"k": k_cache, "v": v_cache}
