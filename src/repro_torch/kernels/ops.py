"""Model-layout wrappers over the port's kernels.

The models are sequence-major ``(B, S, H, D)``, the kernels heads-major
``(B, H, S, D)``. The attention wrapper transposes into contiguous copies; the
scan kernels read strided views, so their wrappers hand them transposed views
and transpose the result back without a copy. Each kernel wrapper launches its
CUDA kernel on a CUDA tensor and runs its plain version on a CPU tensor.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_hsd
from .rwkv6 import MAX_CHUNK, rwkv6_scan_hsd
from .ssd import ssd_scan_hsd

__all__ = ["flash_attention", "rwkv6_scan", "ssd_scan"]


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D) — model layout
    k: torch.Tensor,  # (B, S, KH, D)
    v: torch.Tensor,  # (B, S, KH, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """GQA attention in the model layout, ``(B, S, H, Dv)``: causal unless
    ``causal=False`` (sliding-window when ``window > 0``), scores scaled by
    ``scale`` (``D**-0.5`` when None); ``chunk`` tiles the plain version
    only."""
    out = flash_attention_hsd(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=causal,
        window=window,
        scale=scale,
        chunk=chunk,
    )
    return out.transpose(1, 2)


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P) — model layout
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """The Mamba-2 SSD scan in the model layout; ``y (B, S, H, P)``."""
    y = ssd_scan_hsd(x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm, chunk=chunk)
    return y.transpose(1, 2)


def rwkv6_scan(
    r: torch.Tensor,  # (B, S, H, P) — model layout
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,
    u: torch.Tensor,  # (H, P)
    *,
    chunk: int = MAX_CHUNK,
) -> torch.Tensor:
    """The RWKV-6 wkv scan in the model layout; ``y (B, S, H, P)``. The chunk
    defaults to 16 and may not exceed it (see ``kernels/rwkv6.py``)."""
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    return t(rwkv6_scan_hsd(t(r), t(k), t(v), t(logw), u, chunk=chunk))
