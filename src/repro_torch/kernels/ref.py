"""Dense oracles for the port's kernels (the allclose targets of the tests)
and the comparison that holds the attention kernel to its plain version.

Layouts follow the kernels' heads-major convention. Nothing on the model path
calls these.
"""
from __future__ import annotations

import torch

__all__ = ["attention_limit_ratio", "flash_attention_ref"]


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KH, Skv, D)
    v: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Full-matrix causal softmax attention in f32, scaled by ``D**-0.5``;
    the causal mask is right-aligned when Sq < Skv."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    scale = D**-0.5
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhid,bhjd->bhij", q.float(), kk) * scale
    i = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    j = torch.arange(Skv, device=q.device)[None, :]
    mask = j <= i
    if window > 0:
        mask &= j > i - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, vv).to(q.dtype)


def attention_limit_ratio(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Largest ``|got - want|`` over its limit ``tol * (|want| + rms)``, where
    ``rms`` is the root mean square of ``want``'s row (over the last axis).
    Each row is held to ``tol`` of its own scale: an attention row over n
    live keys of unit-variance values shrinks like ``n**-0.5``, so a fixed
    atol would be as large as the late rows of a long causal sequence. The
    outputs agree when the ratio is at most 1."""
    got, want = got.float(), want.float()
    rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    limit = (tol * (want.abs() + rms)).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() / limit).max())
