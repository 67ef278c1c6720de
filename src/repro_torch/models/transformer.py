"""Decoder stack: blocks -> (prefix, pattern groups, suffix).

The layout is the JAX package's: ``prefix`` blocks, ``n_pattern_repeats``
groups of ``cfg.pattern`` blocks, ``suffix`` blocks. The JAX package stacks
each group's parameters and runs the groups as one ``lax.scan`` (with remat);
here ``groups`` is a list of per-group tuples and a Python loop walks the
blocks in layer order (inference only, so nothing is rematerialized). Its
``models/hints.py`` (GSPMD sharding pins for the scan carry) has no
counterpart on one card.

Only ``gqa``/``swa`` mixers with ``dense`` (or no) MLPs are ported; any other
block raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import torch

from . import attention as attn
from .layers import mlp_apply, mlp_init, rmsnorm, rmsnorm_init

Tensor = torch.Tensor

# block kinds of later slices -> the ROADMAP item that ports them
NOT_PORTED = {
    "mamba2": "ROADMAP A7b (Mamba-2 mixer with the SSD kernel, B3)",
    "shared_attn": "ROADMAP A7b (zamba2 shared attention)",
    "rwkv6": "ROADMAP A7c (RWKV-6 mixer with its kernel, B4)",
    "mla": "ROADMAP A7d (MLA)",
    "moe": "ROADMAP A7e (MoE)",
}


def pick_chunk(s: int, target: int = 1024) -> int:
    """Largest divisor of ``s`` that is <= target (the plain attention's
    tiling)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def check_block(block) -> None:
    """Raise ``NotImplementedError`` for a block the port does not run yet."""
    for kind in (block.mixer, block.mlp, "shared_attn" if block.shared_attn else ""):
        if kind in NOT_PORTED:
            raise NotImplementedError(f"{kind} blocks are not ported yet: {NOT_PORTED[kind]}")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------
def block_init(gen: torch.Generator, cfg, block, dtype, device) -> dict:
    check_block(block)
    p: dict = {"norm1": rmsnorm_init(cfg.d_model, device)}
    p["mixer"] = attn.gqa_init(gen, cfg, dtype, device)
    if block.mlp == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype, device)
    return p


def block_apply(p: dict, cfg, block, x: Tensor, *, chunk: int = 1024) -> Tensor:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + attn.gqa_apply(p["mixer"], cfg, h, window=block.window, chunk=chunk)
    if block.mlp == "dense":
        x = x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x


def block_init_cache(cfg, block, batch: int, max_len: int, dtype, device) -> dict:
    check_block(block)
    return attn.gqa_init_cache(cfg, batch, max_len, block.window, dtype, device)


def block_decode(p: dict, cfg, block, x: Tensor, cache: dict, length) -> tuple[Tensor, dict]:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    y, cache = attn.gqa_decode(p["mixer"], cfg, h, cache, length, window=block.window)
    x = x + y
    if block.mlp == "dense":
        x = x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, cache


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------
def _layout(cfg, make) -> dict:
    """``make(block)`` for every block, in the prefix/groups/suffix layout."""
    return {
        "prefix": [make(b) for b in cfg.prefix],
        "groups": [tuple(make(b) for b in cfg.pattern) for _ in range(cfg.n_pattern_repeats)],
        "suffix": [make(b) for b in cfg.suffix],
    }


def layers(cfg, tree: dict) -> list:
    """The entries of a prefix/groups/suffix ``tree`` in layer order: group g,
    pattern position i is layer ``len(prefix) + g * len(pattern) + i``."""
    return [*tree["prefix"], *(e for group in tree["groups"] for e in group), *tree["suffix"]]


def stack_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    for b in cfg.blocks:
        check_block(b)
    return _layout(cfg, lambda b: block_init(gen, cfg, b, dtype, device))


def stack_apply(p: dict, cfg, x: Tensor, *, chunk: int = 1024) -> tuple[Tensor, dict]:
    for bp, b in zip(layers(cfg, p), cfg.blocks):
        x = block_apply(bp, cfg, b, x, chunk=chunk)
    return x, {}


def stack_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    return _layout(cfg, lambda b: block_init_cache(cfg, b, batch, max_len, dtype, device))


def stack_decode(p: dict, cfg, x: Tensor, cache: dict, length) -> tuple[Tensor, dict]:
    """One token through every block; the caches are written in place and
    returned in the same layout."""
    new = []
    for bp, b, bc in zip(layers(cfg, p), cfg.blocks, layers(cfg, cache)):
        x, nc = block_decode(bp, cfg, b, x, bc, length)
        new.append(nc)
    it = iter(new)
    return x, _layout(cfg, lambda b: next(it))
