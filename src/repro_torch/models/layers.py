"""Shared layers: RMSNorm, RoPE, MLPs, embeddings, initializers.

Functional style, as in the JAX package: every module is an ``init(...) ->
params`` + ``apply(params, x, ...) -> y`` pair over plain dicts of tensors.
Initializers draw from an explicit ``torch.Generator`` on the parameters'
device, so a seed gives the same weights on every run (not the JAX package's
weights: the two generators differ; ``models/convert.py`` carries those over).
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def truncated_normal(gen: torch.Generator, shape, scale: float, dtype, device) -> Tensor:
    """Normal truncated at +-2 sigma, drawn in f32, scaled, then cast."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device) -> Tensor:
    return truncated_normal(gen, (d_in, d_out), d_in**-0.5, dtype, device)


# ---------------------------------------------------------------------------
# RMSNorm (fp32 statistics)
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, device) -> Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(g: Tensor, x: Tensor, eps: float = 1e-5) -> Tensor:
    h = x.float()
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * g).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_frequencies(dim: int, theta: float, device) -> Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta**exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, d_ff: int, gated: bool, dtype, device) -> dict:
    p = {
        "up": dense_init(gen, d, d_ff, dtype, device),
        "down": dense_init(gen, d_ff, d, dtype, device),
    }
    if gated:
        p["gate"] = dense_init(gen, d, d_ff, dtype, device)
    return p


# The activations spell out jax.nn's formulas op by op, each op rounding to
# the input's dtype as XLA's do: at bf16 a fused F.silu (one rounding) differs
# from jax.nn.silu in a third of its outputs, this form in none.
def silu(x: Tensor) -> Tensor:
    one = torch.tensor(1.0, dtype=x.dtype)
    return x * (one / (one + torch.exp(-x)))


def gelu_tanh(x: Tensor) -> Tensor:
    """jax.nn.gelu's default (tanh) approximation."""
    c = lambda v: torch.tensor(v, dtype=x.dtype)  # noqa: E731
    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def mlp_apply(p: dict, x: Tensor) -> Tensor:
    up = x @ p["up"]
    if "gate" in p:
        h = silu(x @ p["gate"]) * up  # SwiGLU
    else:
        h = gelu_tanh(up)
    return h @ p["down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device) -> Tensor:
    return truncated_normal(gen, (vocab, d), 1.0, dtype, device)


def embed_apply(table: Tensor, tokens: Tensor) -> Tensor:
    return table[tokens]


class MixedUnembed(torch.autograd.Function):
    """``x2 @ table.T`` from bf16 operands into f32 logits in one product
    (``torch.mm(..., out_dtype=float32)``, which has no derivative of its
    own), with the gradient autograd gives the bf16 product cast to f32: the
    f32 logit gradient is rounded to the operands' dtype, then ``dx = g @
    table`` and ``dtable = g.T @ x2``. Neither pass copies the table to
    f32."""

    @staticmethod
    def forward(ctx, x2: Tensor, table: Tensor) -> Tensor:
        ctx.save_for_backward(x2, table)
        return torch.mm(x2, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad: Tensor):
        x2, table = ctx.saved_tensors
        g = grad.to(x2.dtype)
        dx = g @ table if ctx.needs_input_grad[0] else None
        dtable = g.t() @ x2 if ctx.needs_input_grad[1] else None
        return dx, dtable


def unembed_apply(table: Tensor, x: Tensor) -> Tensor:
    """Logits in f32 from the (possibly bf16) operands, never rounded to the
    operands' type: greedy argmax over a 262144-entry vocab ties often at
    bf16. On the card a bf16 table goes through one mixed-precision product
    (:class:`MixedUnembed`) and is never copied to f32; on the CPU, where
    that product does not exist, the operands are upcast (bf16 products are
    exact in f32)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and table.dtype != torch.float32:
        out = MixedUnembed.apply(x2, table)
    else:
        out = x2.float() @ table.float().t()
    return out.reshape(*lead, table.shape[0])
