"""Model-layout wrappers over the port's kernels.

The models are sequence-major ``(B, S, H, D)``, the kernels heads-major
``(B, H, S, D)``. The attention wrapper transposes into contiguous copies; the
scan kernels read strided views, so their wrappers hand them transposed views
and transpose the result back without a copy.

Each wrapper routes by device (:func:`_route`): on a CPU tensor it runs the
kernel's plain version, differentiable as it is; on a CUDA tensor it launches
the kernel through the kernel's ``autograd.Function`` (the kernel's forward,
the plain version's gradient), which builds no graph under ``no_grad`` or
when no input requires a gradient. On the card nothing runs the plain version
in the forward, and an input the kernels do not take raises.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from .flash_attention import FlashAttention, flash_attention_plain
from .rwkv6 import MAX_CHUNK, RWKV6Scan, rwkv6_scan_plain
from .ssd import SSDScan, ssd_scan_plain

__all__ = ["flash_attention", "rwkv6_scan", "ssd_scan"]


def _route(plain, function, args: tuple, kw: dict) -> torch.Tensor:
    """``plain`` on a CPU tensor; on a CUDA one ``function``: the kernel's
    forward, the plain version's gradient. A ``meta`` tensor, which holds no
    data (the dry run's DTensors have ``meta`` shards), takes the plain
    version, as the JAX package's dry run lowers its jnp twins. A DTensor on
    the card raises: the kernels take whole tensors."""
    x = args[0]
    if x.device.type in ("cpu", "meta"):
        return plain(*args, **kw)
    if isinstance(x, DTensor):
        raise TypeError(f"a DTensor on {x.device}: the kernels take whole tensors; "
                        "pass its to_local() shards or a full_tensor()")
    return function.apply(*args, kw)


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
    args = tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(causal=causal, window=window, scale=scale, chunk=chunk)
    return _route(flash_attention_plain, FlashAttention, args, kw
                  ).transpose(1, 2)


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
    args = (x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm)
    return _route(ssd_scan_plain, SSDScan, args, dict(chunk=chunk)).transpose(1, 2)


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
    args = (*(a.transpose(1, 2) for a in (r, k, v, logw)), u)
    return _route(rwkv6_scan_plain, RWKV6Scan, args, dict(chunk=chunk)
                  ).transpose(1, 2)
