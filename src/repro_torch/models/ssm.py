"""SSM sequence mixers: Mamba-2 (SSD) and RWKV-6 (Finch).

Each mixer has a prefill form, which runs its scan kernel through
``kernels.ops`` (the CUDA kernel on the card, its chunked plain version on the
CPU, where the JAX model runs the jnp twin), and a single-step decode with
explicit recurrent state, plain PyTorch as in the JAX package. The decode
steps update the cache's state tensors in place (the JAX package returns
fresh arrays) and return the same tensors.

Ops that would round differently at bf16 are spelled the way the JAX model
writes them: the causal conv as a sum of ``d_conv`` shifted products,
``softplus`` as ``logaddexp(x, 0)``, the group norm's variance as the
population variance, the D skip term added in the activation dtype.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .layers import dense_init, silu, truncated_normal

__all__ = [
    "RWKV_HEAD",
    "mamba2_apply",
    "mamba2_decode",
    "mamba2_init",
    "mamba2_init_cache",
    "rwkv6_apply",
    "rwkv6_decode",
    "rwkv6_init",
    "rwkv6_init_cache",
]

Tensor = torch.Tensor
F32 = torch.float32


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> Tensor:
    return torch.rand(shape, generator=gen, dtype=F32, device=device) * (hi - lo) + lo


def _pad_front(x: Tensor, n: int) -> Tensor:
    """``x`` (B, S, C) with ``n`` zero rows before its sequence: a
    concatenation with a zero block, the bits of ``F.pad(x, (0, 0, n, 0))``.
    Not ``F.pad`` itself: PyTorch 2.11's DTensor fails ``constant_pad_nd``
    with an IndexError in its sharding planner (the dry run)."""
    return torch.cat([x.new_zeros((x.shape[0], n, x.shape[2])), x], dim=1)


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# ===========================================================================
# Mamba-2 / SSD
# ===========================================================================
def mamba2_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * N
    return {
        "in_proj": dense_init(gen, d, 2 * din + 2 * N + H, dtype, device),
        "conv_w": truncated_normal(gen, (cfg.d_conv, conv_dim), 0.3, dtype, device),
        "A_log": torch.log(_uniform(gen, (H,), 1.0, 16.0, device)),
        "D": torch.ones((H,), dtype=F32, device=device),
        "dt_bias": torch.log(torch.expm1(_uniform(gen, (H,), 1e-3, 0.1, device))),
        "gnorm": torch.ones((din,), dtype=F32, device=device),
        "out_proj": dense_init(gen, din, d, dtype, device),
    }


def _mamba2_split(p, cfg, zxbcdt: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    din, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :din]
    xBC = zxbcdt[..., din : 2 * din + 2 * N]
    dt_raw = zxbcdt[..., 2 * din + 2 * N :]
    return z, xBC, dt_raw


def _gated_norm(g: Tensor, y: Tensor, z: Tensor, eps: float) -> Tensor:
    h = (y * silu(z.float())).float()
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * g).to(y.dtype)


def mamba2_apply(p: dict, cfg, x: Tensor, *, chunk: int = 64) -> Tensor:
    B, S, d = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt_raw = _mamba2_split(p, cfg, x @ p["in_proj"])
    # causal depthwise conv, kernel d_conv: d_conv shifted products summed in
    # order, each rounded to the activation dtype (F.conv1d would round once)
    pad = _pad_front(xBC, cfg.d_conv - 1)
    conv = sum(pad[:, i : i + S] * p["conv_w"][i][None, None, :] for i in range(cfg.d_conv))
    xBC = silu(conv)
    xs = xBC[..., :din].reshape(B, S, H, P)  # a strided view: the kernel reads it in place
    Bm, Cm = xBC[..., din : din + N], xBC[..., din + N :]
    dt = softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=chunk)
    y = y + xs.to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, din)
    return _gated_norm(p["gnorm"], y, z, cfg.norm_eps) @ p["out_proj"]


def mamba2_init_cache(cfg, batch: int, dtype, device) -> dict:
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_dim = din + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=F32, device=device),
    }


def mamba2_decode(p: dict, cfg, x: Tensor, cache: dict, length) -> tuple[Tensor, dict]:
    """One-token step: O(1) state update. ``cache['conv']`` and
    ``cache['ssm']`` are written in place."""
    B = x.shape[0]
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt_raw = _mamba2_split(p, cfg, x @ p["in_proj"])
    window = torch.cat([cache["conv"], xBC[:, :1]], dim=1)  # (B, d_conv, conv_dim)
    conv = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    xBC = silu(conv).to(x.dtype)
    xs = xBC[..., :din].reshape(B, H, P)
    Bm, Cm = xBC[..., din : din + N], xBC[..., din + N :]
    dt = softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B, H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))
    ssm = cache["ssm"] * a[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, Bm.float(), xs.float()
    )
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), ssm)
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(B, 1, din).to(x.dtype)
    out = _gated_norm(p["gnorm"], y, z, cfg.norm_eps) @ p["out_proj"]
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(ssm)
    return out, cache


# ===========================================================================
# RWKV-6 (Finch)
# ===========================================================================
RWKV_HEAD = 64  # P (key/value head size)


def rwkv6_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H = d // RWKV_HEAD
    return {
        "mu": _uniform(gen, (5, d), 0.0, 1.0, device),  # r, k, v, g, w lerp
        "wr": dense_init(gen, d, d, dtype, device),
        "wk": dense_init(gen, d, d, dtype, device),
        "wv": dense_init(gen, d, d, dtype, device),
        "wg": dense_init(gen, d, d, dtype, device),
        "w_lora_a": dense_init(gen, d, 64, dtype, device),
        "w_lora_b": dense_init(gen, 64, d, dtype, device),
        "w_bias": torch.full((d,), -2.0, dtype=F32, device=device),  # w ~ exp(-exp(-2))
        "u": truncated_normal(gen, (H, RWKV_HEAD), 0.3, F32, device),
        "ln_w": torch.ones((d,), dtype=F32, device=device),
        "ln_b": torch.zeros((d,), dtype=F32, device=device),
        "out": dense_init(gen, d, d, dtype, device),
    }


def _rwkv6_mix(p: dict, x: Tensor, xprev: Tensor) -> list[Tensor]:
    """Token-shift lerp per projection stream: xr, xk, xv, xg, xw."""
    return [x + p["mu"][i].to(x.dtype) * (xprev - x) for i in range(5)]


def _rwkv6_decay(p: dict, xw: Tensor) -> Tensor:
    raw = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return -torch.exp(torch.clamp(raw.float() + p["w_bias"], -8.0, 1.0))


def _rwkv6_out(p: dict, cfg, y: Tensor, g: Tensor, B: int, S: int, d: int) -> Tensor:
    H = d // RWKV_HEAD
    yf = y.reshape(B, S, H, RWKV_HEAD).float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)  # jnp.var: the population variance
    yf = (yf - mean) * torch.rsqrt(var + cfg.norm_eps)
    yf = yf.reshape(B, S, d) * p["ln_w"] + p["ln_b"]
    return (yf.to(y.dtype) * g) @ p["out"]


def rwkv6_apply(p: dict, cfg, x: Tensor, *, chunk: int = 16) -> Tensor:
    B, S, d = x.shape
    H = d // RWKV_HEAD
    xprev = _pad_front(x, 1)[:, :-1]
    xr, xk, xv, xg, xw = _rwkv6_mix(p, x, xprev)
    r = (xr @ p["wr"]).reshape(B, S, H, RWKV_HEAD)
    k = (xk @ p["wk"]).reshape(B, S, H, RWKV_HEAD)
    v = (xv @ p["wv"]).reshape(B, S, H, RWKV_HEAD)
    g = silu(xg @ p["wg"])
    logw = _rwkv6_decay(p, xw).reshape(B, S, H, RWKV_HEAD)
    y = ops.rwkv6_scan(r, k, v, logw, p["u"], chunk=chunk)
    return _rwkv6_out(p, cfg, y, g, B, S, d)


def rwkv6_init_cache(cfg, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    H = d // RWKV_HEAD
    return {
        "x_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, RWKV_HEAD, RWKV_HEAD), dtype=F32, device=device),
    }


def rwkv6_decode(p: dict, cfg, x: Tensor, cache: dict, length) -> tuple[Tensor, dict]:
    """One-token step. ``cache['x_prev']`` and ``cache['wkv']`` are written in
    place."""
    B, _, d = x.shape
    H = d // RWKV_HEAD
    xt = x[:, 0]
    xprev = cache["x_prev"].to(x.dtype)
    xr, xk, xv, xg, xw = _rwkv6_mix(p, xt, xprev)
    r = (xr @ p["wr"]).reshape(B, H, RWKV_HEAD).float()
    k = (xk @ p["wk"]).reshape(B, H, RWKV_HEAD).float()
    v = (xv @ p["wv"]).reshape(B, H, RWKV_HEAD).float()
    g = silu(xg @ p["wg"])
    logw = _rwkv6_decay(p, xw).reshape(B, H, RWKV_HEAD)
    s = cache["wkv"]
    kv = torch.einsum("bhp,bhq->bhpq", k, v)
    y = torch.einsum("bhp,bhpq->bhq", r, s + p["u"][None, :, :, None] * kv)
    s = s * torch.exp(logw)[..., None] + kv
    y = y.reshape(B, 1, d).to(x.dtype)
    out = _rwkv6_out(p, cfg, y, g[:, None], B, 1, d)
    cache["x_prev"].copy_(xt)
    cache["wkv"].copy_(s)
    return out, cache
