"""Decoder stack: blocks -> (prefix, pattern groups, suffix).

The layout is the JAX package's: ``prefix`` blocks, ``n_pattern_repeats``
groups of ``cfg.pattern`` blocks, ``suffix`` blocks. The JAX package stacks
each group's parameters and runs the groups as one ``lax.scan`` (with remat);
here ``groups`` is a list of per-group tuples and a Python loop walks the
blocks in layer order (inference only, so nothing is rematerialized). Its
``models/hints.py`` (GSPMD sharding pins for the scan carry) has no
counterpart on one card. Zamba-style shared attention keeps one mixer
parameter set at ``stack["shared_attn"]`` (``None`` for every other model);
each ``shared_attn`` block reads those same tensors and keeps its own norms
and MLP.

Mixers ``gqa``/``swa``, ``mamba2`` and ``rwkv6`` with ``dense`` or no MLPs are
ported; an MLA or MoE block raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ssm
from .layers import mlp_apply, mlp_init, rmsnorm, rmsnorm_init

Tensor = torch.Tensor

# block kinds of later slices -> the ROADMAP item that ports them
NOT_PORTED = {
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
    for kind in (block.mixer, block.mlp):
        if kind in NOT_PORTED:
            raise NotImplementedError(f"{kind} blocks are not ported yet: {NOT_PORTED[kind]}")


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------
def mixer_init(gen: torch.Generator, cfg, block, dtype, device) -> dict:
    if block.mixer in ("gqa", "swa"):
        return attn.gqa_init(gen, cfg, dtype, device)
    if block.mixer == "mamba2":
        return ssm.mamba2_init(gen, cfg, dtype, device)
    if block.mixer == "rwkv6":
        return ssm.rwkv6_init(gen, cfg, dtype, device)
    raise ValueError(block.mixer)


def block_init(gen: torch.Generator, cfg, block, dtype, device) -> dict:
    check_block(block)
    p: dict = {"norm1": rmsnorm_init(cfg.d_model, device)}
    if not block.shared_attn:
        p["mixer"] = mixer_init(gen, cfg, block, dtype, device)
    if block.mlp == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype, device)
    return p


def _apply_mixer(mp: dict, cfg, block, h: Tensor, chunk: int) -> Tensor:
    if block.mixer in ("gqa", "swa"):
        return attn.gqa_apply(mp, cfg, h, window=block.window, chunk=chunk)
    if block.mixer == "mamba2":
        return ssm.mamba2_apply(mp, cfg, h, chunk=min(64, chunk))
    if block.mixer == "rwkv6":
        return ssm.rwkv6_apply(mp, cfg, h, chunk=min(16, chunk))
    raise ValueError(block.mixer)


def block_apply(
    p: dict, cfg, block, x: Tensor, *, shared_mixer: dict | None = None, chunk: int = 1024
) -> Tensor:
    mp = shared_mixer if block.shared_attn else p["mixer"]
    x = x + _apply_mixer(mp, cfg, block, rmsnorm(p["norm1"], x, cfg.norm_eps), chunk)
    if block.mlp == "dense":
        x = x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x


def block_init_cache(cfg, block, batch: int, max_len: int, dtype, device) -> dict:
    check_block(block)
    if block.mixer in ("gqa", "swa"):
        return attn.gqa_init_cache(cfg, batch, max_len, block.window, dtype, device)
    if block.mixer == "mamba2":
        return ssm.mamba2_init_cache(cfg, batch, dtype, device)
    if block.mixer == "rwkv6":
        return ssm.rwkv6_init_cache(cfg, batch, dtype, device)
    raise ValueError(block.mixer)


def block_decode(
    p: dict, cfg, block, x: Tensor, cache: dict, length, *, shared_mixer: dict | None = None
) -> tuple[Tensor, dict]:
    mp = shared_mixer if block.shared_attn else p["mixer"]
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if block.mixer in ("gqa", "swa"):
        y, cache = attn.gqa_decode(mp, cfg, h, cache, length, window=block.window)
    elif block.mixer == "mamba2":
        y, cache = ssm.mamba2_decode(mp, cfg, h, cache, length)
    elif block.mixer == "rwkv6":
        y, cache = ssm.rwkv6_decode(mp, cfg, h, cache, length)
    else:
        raise ValueError(block.mixer)
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
    # the shared mixer is drawn first, as the JAX package draws it
    shared = next((b for b in cfg.blocks if b.shared_attn), None)
    shared_attn = None if shared is None else mixer_init(gen, cfg, shared, dtype, device)
    p = _layout(cfg, lambda b: block_init(gen, cfg, b, dtype, device))
    p["shared_attn"] = shared_attn
    return p


def stack_apply(p: dict, cfg, x: Tensor, *, chunk: int = 1024) -> tuple[Tensor, dict]:
    shared = p["shared_attn"]
    for bp, b in zip(layers(cfg, p), cfg.blocks):
        x = block_apply(bp, cfg, b, x, shared_mixer=shared, chunk=chunk)
    return x, {}


def stack_init_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    return _layout(cfg, lambda b: block_init_cache(cfg, b, batch, max_len, dtype, device))


def stack_decode(p: dict, cfg, x: Tensor, cache: dict, length) -> tuple[Tensor, dict]:
    """One token through every block; the caches are written in place and
    returned in the same layout."""
    new = []
    shared = p["shared_attn"]
    for bp, b, bc in zip(layers(cfg, p), cfg.blocks, layers(cfg, cache)):
        x, nc = block_decode(bp, cfg, b, x, bc, length, shared_mixer=shared)
        new.append(nc)
    it = iter(new)
    return x, _layout(cfg, lambda b: next(it))
