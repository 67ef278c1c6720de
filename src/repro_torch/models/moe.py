"""Mixture-of-Experts channel mixer (DeepSeek-style: shared + routed experts,
top-k of a softmax router) with capacity-based grouped dispatch.

The JAX package's ``models/moe.py``, step for step. Dispatch is per group (a
group is one sequence at prefill, the whole slot batch at decode): each group
scatters its tokens into an ``(E * C + 1, d)`` buffer at rank-in-expert
positions from one-hot cumsums (no sort, no ``(T, E, C)`` dispatch tensor);
tokens past an expert's capacity C go to the overflow row ``E * C``, which is
cut off before the experts run, and are carried by the residual stream. The
expert products are batched over (G, E), plain ``torch.einsum`` as the JAX
package leaves them to XLA outside any kernel; each token's outputs are then
gathered by destination and summed with its gates in f32, and the shared
experts added.

The 4-D dispatch buffers (the expert inputs, ``up`` and the expert outputs)
pass through ``models/hints.py::constrain_moe_buffer`` where the JAX package
pins them to its expert-parallel layout: a no-op unless the dry run
installed a layout.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from .hints import constrain_moe_buffer
from .layers import gelu_tanh, mlp_apply, mlp_init, silu, truncated_normal

__all__ = ["moe_apply", "moe_capacity", "moe_init"]

Tensor = torch.Tensor


def moe_capacity(tokens_per_group: int, cfg) -> int:
    """Slots an expert has in one group: ``capacity_factor`` times its even
    share of the group's top-k choices, at least 4, a multiple of 4."""
    c = math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


def _experts_init(gen, E: int, d_in: int, d_out: int, dtype, device) -> Tensor:
    """E stacked ``dense_init`` matrices ``(E, d_in, d_out)``."""
    return truncated_normal(gen, (E, d_in, d_out), d_in**-0.5, dtype, device)


def moe_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": truncated_normal(gen, (d, E), d**-0.5, torch.float32, device),
        "w_up": _experts_init(gen, E, d, f, dtype, device),
        "w_down": _experts_init(gen, E, f, d, dtype, device),
    }
    if cfg.mlp_gated:
        p["w_gate"] = _experts_init(gen, E, d, f, dtype, device)
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.n_shared_experts * f, cfg.mlp_gated, dtype, device)
    return p


def _replicated(t: Tensor) -> Tensor:
    """``t`` whole on every rank when it is a DTensor (DTensor's scatter
    cannot take an index sharded over two mesh dims, nor some PyTorch
    versions flatten one); else ``t`` itself."""
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return t


def _dispatch_out_of_place(x: Tensor, dst: Tensor, rows: int) -> Tensor:
    """The buffer ``_dispatch_group``'s row scatters write, built out of
    place, as a DTensor needs it (DTensor cannot run the in-place scatter):
    each row's source token is scattered first (T, a zero row, where none
    lands) and the rows gathered from it. The same forward bits; its
    backward sums a token's gradient by a ``scatter_add`` over its k
    choices, so the plain path keeps the scatters."""
    G, T, d = x.shape
    k = dst.shape[-1]
    tok = torch.arange(T, device=x.device).repeat_interleave(k).expand(G, T * k)
    src = torch.full((G, rows), T, dtype=torch.int64, device=x.device)
    src = src.scatter(1, _replicated(dst).reshape(G, T * k), tok)
    xz = torch.cat([x, x.new_zeros((G, 1, d))], dim=1)
    return xz.gather(1, src[..., None].expand(G, rows, d))


def _dispatch_group(x: Tensor, topi: Tensor, C: int, cfg) -> tuple[Tensor, Tensor, Tensor]:
    """Every group's scatter at once. x: (G, T, d); topi: (G, T, k).

    Returns (buffer (G, E*C+1, d), dst (G, T, k), keep (G, T, k)); dst ==
    E*C is the overflow row of capacity-dropped tokens. A token's rank in
    its expert counts the tokens before it that chose that expert with the
    same choice j, plus every token that chose it with an earlier choice."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    experts = torch.arange(E, device=x.device)
    counts = None  # (G, E): the tokens each expert took with the earlier choices
    dst, keep = [], []
    for j in range(k):  # a small static loop: rank-in-expert per routing choice
        e_j = topi[..., j]  # (G, T)
        # the one-hot as (G, E, T), tokens innermost, where a cumsum runs in
        # parallel; over (G, T, E)'s middle dim it scans a thread per expert
        # (chip_smoke.py on an H100: 1.13 s of deepseek-v2-lite-16b's 2.15 s
        # prefill at S=32768)
        onehot = (e_j[:, None, :] == experts[None, :, None]).int()
        ranks_within = onehot.cumsum(dim=-1, dtype=torch.int32) - onehot  # rank among choice j
        rank = ranks_within.gather(1, e_j[:, None, :])[:, 0]
        taken = onehot.sum(dim=-1, dtype=torch.int32)
        # no zero start: DTensor turns a replicated int into a partial sum by
        # dividing it, in floats
        if counts is None:
            counts = taken
        else:
            rank = rank + counts.gather(1, e_j)
            counts = counts + taken
        ok = rank < C
        dst.append(torch.where(ok, e_j * C + rank, E * C))
        keep.append(ok)
    # (G, T, k); a positive dim, as DTensor on PyTorch 2.11 labels a stack at
    # dim=-1 of tensors sharded on dim 1 as sharded on the new dim
    dst = torch.stack(dst, dim=2)
    keep = torch.stack(keep, dim=2)
    # every destination but the overflow row is written once; that row is
    # never read (moe_apply cuts it off before the experts run)
    if isinstance(x, DTensor):
        return _dispatch_out_of_place(x, dst, E * C + 1), dst, keep
    buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        buf.scatter_(1, dst[..., j, None].expand(G, T, d), x)
    return buf, dst, keep


def moe_apply(p: dict, cfg, x: Tensor) -> tuple[Tensor, dict]:
    """x: (G, T, d) — G groups dispatch independently (G = batch at
    prefill, 1 at decode). Returns (y, aux) with the load-balance metrics,
    each an f32 scalar tensor."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(T, cfg)

    logits = x.float() @ p["router"]  # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, topi = torch.topk(probs, k, dim=-1)  # (G, T, k), largest first
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    buf, dst, keep = _dispatch_group(x, topi, C, cfg)
    ebuf = constrain_moe_buffer(buf[:, : E * C].reshape(G, E, C, d))
    # expert products, batched over (G, E)
    up = constrain_moe_buffer(torch.einsum("gecd,edf->gecf", ebuf, p["w_up"]))
    if "w_gate" in p:
        h = silu(torch.einsum("gecd,edf->gecf", ebuf, p["w_gate"])) * up
    else:
        h = gelu_tanh(up)
    y_e = constrain_moe_buffer(torch.einsum("gecf,efd->gecd", h, p["w_down"]))
    # dropped choices read a zero row
    y_flat = torch.cat([y_e.reshape(G, E * C, d), y_e.new_zeros((G, 1, d))], dim=1)
    out = torch.zeros((G, T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        gathered = y_flat.gather(1, dst[..., j, None].expand(G, T, d))
        w = (gates[..., j] * keep[..., j])[..., None]
        out = out + gathered.float() * w
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x)

    # aux: Switch-style load-balance loss, dropped-choice share, router z-loss
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = torch.nn.functional.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    aux = {
        "moe_balance_loss": E * torch.sum(me * ce),
        "moe_dropped_frac": 1.0 - keep.float().mean(),
        "moe_router_zloss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
    }
    return out, aux
