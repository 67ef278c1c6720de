"""Decoder stack: blocks -> (prefix, pattern groups, suffix).

The layout is the JAX package's: ``prefix`` blocks, ``n_pattern_repeats``
groups of ``cfg.pattern`` blocks, ``suffix`` blocks. The JAX package stacks
each group's parameters and runs the groups as one ``lax.scan`` (with remat);
here ``groups`` is a list of per-group tuples and a Python loop walks the
blocks in layer order, rematerializing the same units as the JAX package
when a gradient is taken (``stack_apply``). The layer-boundary activations
pass through ``models/hints.py::constrain_activation`` where the JAX package
pins them (before each prefix and suffix block, at each group's start and
end): a no-op unless the dry run installed a layout. Zamba-style shared
attention keeps one mixer parameter set at ``stack["shared_attn"]``
(``None`` for every other model); each ``shared_attn`` block reads those
same tensors and keeps its own norms and MLP.

Every block kind of the configs runs: mixers ``gqa``/``swa``, ``mla``,
``mamba2`` and ``rwkv6``; channel mixers ``dense``, ``moe`` or none. A MoE
block's load-balance metrics come back as the forward's ``aux``, summed over
the layers in f32 as the JAX package's ``_sum_aux`` sums them; a model
without MoE blocks returns ``{}``.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import hints
from . import moe as moe_mod
from . import ssm
from ..tree import tree_leaves, tree_paths
from .layers import mlp_apply, mlp_init, rmsnorm, rmsnorm_init

Tensor = torch.Tensor


def pick_chunk(s: int, target: int = 1024) -> int:
    """Largest divisor of ``s`` that is <= target (the plain attention's
    tiling)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------
def mixer_init(gen: torch.Generator, cfg, block, dtype, device) -> dict:
    if block.mixer in ("gqa", "swa"):
        return attn.gqa_init(gen, cfg, dtype, device)
    if block.mixer == "mla":
        return attn.mla_init(gen, cfg, dtype, device)
    if block.mixer == "mamba2":
        return ssm.mamba2_init(gen, cfg, dtype, device)
    if block.mixer == "rwkv6":
        return ssm.rwkv6_init(gen, cfg, dtype, device)
    raise ValueError(block.mixer)


def block_init(gen: torch.Generator, cfg, block, dtype, device) -> dict:
    p: dict = {"norm1": rmsnorm_init(cfg.d_model, device)}
    if not block.shared_attn:
        p["mixer"] = mixer_init(gen, cfg, block, dtype, device)
    if block.mlp == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype, device)
    elif block.mlp == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device)
    return p


def _apply_mixer(mp: dict, cfg, block, h: Tensor, chunk: int) -> Tensor:
    if block.mixer in ("gqa", "swa"):
        return attn.gqa_apply(mp, cfg, h, window=block.window, chunk=chunk)
    if block.mixer == "mla":
        return attn.mla_apply(mp, cfg, h, chunk=chunk)
    if block.mixer == "mamba2":
        return ssm.mamba2_apply(mp, cfg, h, chunk=min(64, chunk))
    if block.mixer == "rwkv6":
        return ssm.rwkv6_apply(mp, cfg, h, chunk=min(16, chunk))
    raise ValueError(block.mixer)


def block_apply(
    p: dict, cfg, block, x: Tensor, *, shared_mixer: dict | None = None, chunk: int = 1024
) -> tuple[Tensor, dict]:
    """One block; returns (x, aux), aux the MoE metrics (``{}`` for a dense
    or MLP-less block)."""
    aux: dict = {}
    mp = shared_mixer if block.shared_attn else p["mixer"]
    x = x + _apply_mixer(mp, cfg, block, rmsnorm(p["norm1"], x, cfg.norm_eps), chunk)
    if block.mlp == "dense":
        x = x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    elif block.mlp == "moe":
        y, aux = moe_mod.moe_apply(p["moe"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps))
        x = x + y
    return x, aux


def block_init_cache(cfg, block, batch: int, max_len: int, dtype, device) -> dict:
    if block.mixer in ("gqa", "swa"):
        return attn.gqa_init_cache(cfg, batch, max_len, block.window, dtype, device)
    if block.mixer == "mla":
        return attn.mla_init_cache(cfg, batch, max_len, dtype, device)
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
    elif block.mixer == "mla":
        y, cache = attn.mla_decode(mp, cfg, h, cache, length)
    elif block.mixer == "mamba2":
        y, cache = ssm.mamba2_decode(mp, cfg, h, cache, length)
    elif block.mixer == "rwkv6":
        y, cache = ssm.rwkv6_decode(mp, cfg, h, cache, length)
    else:
        raise ValueError(block.mixer)
    x = x + y
    if block.mlp == "dense":
        x = x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    elif block.mlp == "moe":
        # the whole slot batch is one dispatch group, free slots included
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        B = h2.shape[0]
        y2, _ = moe_mod.moe_apply(p["moe"], cfg, h2.reshape(1, B, -1))
        x = x + y2.reshape(B, 1, -1)
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


def reference_leaves(tree: dict) -> list[tuple[str, list, bool]]:
    """The JAX package's leaves for a tree in the port's layout, in its
    flattening order, as ``(path, tensors, stacked)``: a leaf outside the
    pattern groups is the one port tensor at that path; a group leaf
    (``stack/groups/<i>/...``, ``stacked``) is the stack of pattern position
    i's tensor over the groups, in group order. Tests carry JAX trees over
    with ``models/convert.py``; the optimizer reads this to treat each tensor
    as the JAX package treats its leaf.
    Paths are joined with ``/`` as ``train/checkpoint.py`` keys them."""
    out = []
    for key in sorted(tree):
        if key != "stack":
            out += [(path, [t], False) for path, t in tree_paths(tree[key], key)]
            continue
        stack = tree["stack"]
        for part in sorted(stack):
            if part != "groups":
                out += [(path, [t], False) for path, t in tree_paths(stack[part], f"stack/{part}")]
            elif stack["groups"]:
                per_group = [dict(tree_paths(group, "stack/groups")) for group in stack["groups"]]
                out += [(path, [g[path] for g in per_group], True) for path in per_group[0]]
    return out


def stack_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    # the shared mixer is drawn first, as the JAX package draws it
    shared = next((b for b in cfg.blocks if b.shared_attn), None)
    shared_attn = None if shared is None else mixer_init(gen, cfg, shared, dtype, device)
    p = _layout(cfg, lambda b: block_init(gen, cfg, b, dtype, device))
    p["shared_attn"] = shared_attn
    return p


def _sum_aux(total: dict, aux: dict) -> dict:
    for k, v in aux.items():
        total[k] = total.get(k, 0.0) + v.float()
    return total


def stack_apply(p: dict, cfg, x: Tensor, *, chunk: int = 1024) -> tuple[Tensor, dict]:
    """Every block in layer order; returns (x, the blocks' aux summed in
    f32). With ``cfg.remat``, when a gradient can flow (grad mode on, and
    ``x`` or a parameter requires one), the units the JAX package
    wraps in ``jax.checkpoint`` are rematerialized: each prefix and suffix
    block on its own and each pattern group as one unit keep only their
    input, and run again in the backward (``torch.utils.checkpoint``,
    non-reentrant)."""
    shared = p["shared_attn"]

    def unit(params: list, blocks: tuple, x: Tensor, group: bool) -> tuple[Tensor, dict]:
        aux: dict = {}
        if group:  # the group's carry, which remat saves: keep it sharded
            x = hints.constrain_activation(x)
        for bp, b in zip(params, blocks):
            x, a = block_apply(bp, cfg, b, x, shared_mixer=shared, chunk=chunk)
            aux = _sum_aux(aux, a)
        if group:
            x = hints.constrain_activation(x)
        return x, aux

    units = [([bp], (b,), False) for bp, b in zip(p["prefix"], cfg.prefix)]
    units += [(list(group), cfg.pattern, True) for group in p["groups"]]
    units += [([bp], (b,), False) for bp, b in zip(p["suffix"], cfg.suffix)]
    remat = cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(p)))
    aux: dict = {}
    for params, blocks, group in units:
        if not group:  # checkpoint saves it sharded
            x = hints.constrain_activation(x)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(unit, params, blocks, x, group,
                                                     use_reentrant=False)
        else:
            x, a = unit(params, blocks, x, group)
        aux = _sum_aux(aux, a)
    return x, aux


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
