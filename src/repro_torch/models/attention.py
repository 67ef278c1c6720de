"""Attention mixers: GQA (full / sliding-window) and MLA, with flash
attention for prefill and cache-based decode.

Prefill attention goes through ``kernels.ops.flash_attention``: the CUDA
kernel on the card, its plain version :func:`blockwise_attention` (the
online-softmax twin the JAX model runs) on the CPU. MLA's prefill passes the
kernels its own head dims (q and k ``qk_nope + qk_rope``, v ``v_head_dim``)
and scale. Decode attention is plain PyTorch, as the JAX package leaves it to
jnp outside any kernel; MLA decodes with the absorbed f32 products over its
latent cache.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..kernels.flash_attention import NEG_INF, blockwise_attention
from ..kernels.ops import flash_attention
from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_init

__all__ = [
    "blockwise_attention",
    "decode_attention",
    "gqa_apply",
    "gqa_decode",
    "gqa_init",
    "gqa_init_cache",
    "mla_apply",
    "mla_decode",
    "mla_init",
    "mla_init_cache",
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
    if isinstance(cache, DTensor):
        # out of place, as the JAX package writes it: DTensor has no
        # index_put_ along a sharded batch dim (the dry run's caches)
        hit = torch.arange(cache.shape[1], device=rows.device)[None, :] == rows[:, None]
        return torch.where(hit.reshape(*hit.shape, *[1] * (cache.dim() - 2)), new, cache)
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


# ---------------------------------------------------------------------------
# MLA mixer (DeepSeek-V2/V3, MiniCPM3)
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = cfg.head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    p: dict = {}
    if cfg.q_lora_rank:
        p["q_down"] = dense_init(gen, d, cfg.q_lora_rank, dtype, device)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, device)
        p["q_up"] = dense_init(gen, cfg.q_lora_rank, H * (dn + dr), dtype, device)
    else:
        p["wq"] = dense_init(gen, d, H * (dn + dr), dtype, device)
    p["kv_down"] = dense_init(gen, d, r + dr, dtype, device)  # -> [c_kv ; k_rope]
    p["kv_norm"] = rmsnorm_init(r, device)
    p["kv_up"] = dense_init(gen, r, H * (dn + dv), dtype, device)
    p["wo"] = dense_init(gen, H * dv, d, dtype, device)
    return p


def _mla_q(p: dict, cfg, x: Tensor) -> tuple[Tensor, Tensor]:
    """(q_nope (B, S, H, dn), q_pe (B, S, H, dr)), through the q LoRA where
    the model has one."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        ql = rmsnorm(p["q_norm"], x @ p["q_down"], cfg.norm_eps)
        q = (ql @ p["q_up"]).reshape(B, S, H, dn + dr)
    else:
        q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]


def mla_apply(p: dict, cfg, x: Tensor, *, chunk: int = 1024) -> Tensor:
    """Prefill: the latent is expanded to per-head k and v, and attention
    runs at Dk = qk_nope + qk_rope against Dv = v_head_dim, scaled by
    Dk**-0.5."""
    B, S, _ = x.shape
    H, dn, dr, dv, r = (cfg.n_heads, cfg.head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    pos = torch.arange(S, device=x.device)
    q_nope, q_pe = _mla_q(p, cfg, x)
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    kv = x @ p["kv_down"]  # (B, S, r + dr)
    c_kv = rmsnorm(p["kv_norm"], kv[..., :r], cfg.norm_eps)
    k_pe = apply_rope(kv[..., None, r:], pos, cfg.rope_theta)  # (B, S, 1, dr): one for all heads
    kv_up = (c_kv @ p["kv_up"]).reshape(B, S, H, dn + dv)
    k_nope, v = kv_up[..., :dn], kv_up[..., dn:]
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, dr)], dim=-1)
    o = flash_attention(q, k, v, chunk=chunk, scale=(dn + dr) ** -0.5)
    return o.reshape(B, S, H * dv) @ p["wo"]


def mla_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    """MLA's serving advantage: the cache holds the compressed latent and the
    shared rope key, (r + dr) values a position instead of 2 * H * Dh."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "kpe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_decode(p: dict, cfg, x: Tensor, cache: dict, length) -> tuple[Tensor, dict]:
    """Absorbed-product decode: q is folded through kv_up so attention runs
    against the latent cache directly (DeepSeek-V2 Sec. 2.1.3), in f32. The
    new latent and rope key are written into the cache in place; the
    returned dict holds the same tensors."""
    B = x.shape[0]
    H, dn, dr, dv, r = (cfg.n_heads, cfg.head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    lengths = _lengths(length, B, x.device)
    pos = lengths[:, None]  # (B, 1)
    q_nope, q_pe = _mla_q(p, cfg, x)  # (B, 1, H, dn), (B, 1, H, dr)
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    kv = x @ p["kv_down"]
    c_kv = rmsnorm(p["kv_norm"], kv[..., :r], cfg.norm_eps)  # (B, 1, r)
    k_pe = apply_rope(kv[..., None, r:], pos, cfg.rope_theta).reshape(B, 1, dr)
    ckv_cache = _cache_write(cache["ckv"], c_kv, lengths)
    kpe_cache = _cache_write(cache["kpe"], k_pe, lengths)
    w = p["kv_up"].reshape(r, H, dn + dv).float()
    w_uk, w_uv = w[..., :dn], w[..., dn:]  # (r, H, dn), (r, H, dv)
    q_lat = torch.einsum("bxhd,rhd->bxhr", q_nope.float(), w_uk)
    ckv = ckv_cache.float()
    s = (torch.einsum("bxhr,bjr->bhj", q_lat, ckv)
         + torch.einsum("bxhd,bjd->bhj", q_pe.float(), kpe_cache.float())) * (dn + dr) ** -0.5
    valid = torch.arange(ckv.shape[1], device=x.device)[None, :] < (lengths + 1)[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    attn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhj,bjr->bhr", attn, ckv)
    o = torch.einsum("bhr,rhd->bhd", ctx, w_uv).to(x.dtype)
    out = o.reshape(B, 1, H * dv) @ p["wo"]
    return out, {"ckv": ckv_cache, "kpe": kpe_cache}
