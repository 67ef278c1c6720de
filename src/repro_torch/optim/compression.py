"""Gradient compression for the cross-pod reduction, the JAX package's
``optim/compression.py`` in PyTorch. Two codecs, both with error feedback so
that compression noise does not accumulate (Seide et al., 1-bit SGD;
Karimireddy et al., EF-SGD):

  * ``bf16``: cast down and back up (2x);
  * ``int8``: a per-tensor symmetric scale (4x).

``cross_pod_allreduce`` compresses, sums over a ``torch.distributed`` process
group (the JAX package sums over the mesh's ``pod`` axis with ``psum``) and
decompresses; ``codec="none"`` is a plain f32 all-reduce.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map

Tensor = torch.Tensor

__all__ = [
    "compress_bf16", "compress_int8", "cross_pod_allreduce", "decompress_bf16",
    "decompress_int8", "ef_compress",
]


def compress_bf16(g: Tensor) -> Tensor:
    return g.to(torch.bfloat16)


def decompress_bf16(c: Tensor) -> Tensor:
    return c.float()


def compress_int8(g: Tensor) -> tuple[Tensor, Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def decompress_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def ef_compress(g: Tensor, err: Tensor, codec: str) -> tuple[Tensor, Tensor, Tensor | None]:
    """Error-feedback compression: returns (payload, new_err, scale or None)."""
    corrected = g.float() + err.float()
    if codec == "bf16":
        payload = compress_bf16(corrected)
        restored = decompress_bf16(payload)
        return payload, (corrected - restored).to(err.dtype), None
    if codec == "int8":
        payload, scale = compress_int8(corrected)
        restored = decompress_int8(payload, scale)
        return payload, (corrected - restored).to(err.dtype), scale
    raise ValueError(codec)


def cross_pod_allreduce(grads, err_state, *, codec: str = "bf16", group=None):
    """Error-feedback compress each gradient, sum the decompressed payloads
    over ``group`` (the default process group when None) and return (the
    summed f32 gradients, the new error state). With ``codec="none"`` a plain
    f32 sum, the error state unchanged."""
    import torch.distributed as dist

    def summed(x: Tensor) -> Tensor:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    if codec == "none":
        return tree_map(lambda g: summed(g.float().clone()), grads), err_state
    sums, errors = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err_state)):
        payload, new_err, scale = ef_compress(g, e, codec)
        restored = decompress_bf16(payload) if codec == "bf16" else decompress_int8(payload, scale)
        sums.append(summed(restored))
        errors.append(new_err)
    sums, errors = iter(sums), iter(errors)
    return tree_map(lambda _: next(sums), grads), tree_map(lambda _: next(errors), grads)
