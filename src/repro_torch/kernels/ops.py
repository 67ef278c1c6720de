"""Model-layout wrappers over the port's kernels.

The models are sequence-major ``(B, S, H, D)``, the kernels heads-major
``(B, H, S, D)``; these wrappers transpose in and out. Each kernel wrapper
launches its CUDA kernel on a CUDA tensor and runs its plain version on a CPU
tensor.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_hsd

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D) — model layout
    k: torch.Tensor,  # (B, S, KH, D)
    v: torch.Tensor,
    *,
    window: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Causal (sliding-window when ``window > 0``) GQA attention in the model
    layout; ``chunk`` tiles the plain version only."""
    out = flash_attention_hsd(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        window=window,
        chunk=chunk,
    )
    return out.transpose(1, 2)
