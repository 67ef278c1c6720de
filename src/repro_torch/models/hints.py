"""Mesh-dependent sharding hints for model internals.

The JAX package's ``models/hints.py`` for DTensors. Model code is
mesh-agnostic; a launcher (the dry run, ``launch/dryrun.py``) installs a
layout here before it runs a step. Where the JAX package calls
``jax.lax.with_sharding_constraint``, the port redistributes: a layout is a
``(mesh, placements)`` pair, and a ``DTensor`` that reaches a hint while one
is installed is redistributed to it (``x.redistribute(mesh, placements)``),
a dim the mesh does not divide left whole.
A plain tensor, or any tensor when nothing is installed, comes back as it
is, so a run without a layout computes exactly what it did before.

The consumers are the JAX package's: the layer-boundary activation (the
embedding output and the stack's carry, which remat saves, kept
sequence-sharded over ``model``) and the MoE dispatch buffers ``(G, E, C,
d)``, pinned to the expert-parallel layout so tokens are redistributed once.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_ACTIVATION_SHARDING: Any = None
_MOE_SHARDING: Any = None  # (G, E, C, d) dispatch-buffer layout pin


def _constrain(x: torch.Tensor, layout) -> torch.Tensor:
    if layout is None or not isinstance(x, DTensor):
        return x
    mesh, placements = layout
    placements = _divisible(x.shape, mesh, placements)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def _divisible(shape, mesh, placements) -> list:
    """``placements`` with every shard of a dim that the mesh dims sharding
    it do not divide exactly made ``Replicate()`` (the sharding rules'
    convention; XLA pads such a dim, DTensor cannot reshape its empty
    shards), so a decode group of one token stays whole."""
    ways: dict[int, int] = {}
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            ways[pl.dim] = ways.get(pl.dim, 1) * mesh.size(m)
    return [Replicate() if isinstance(pl, Shard) and shape[pl.dim] % ways[pl.dim] else pl
            for pl in placements]


def set_activation_sharding(sharding) -> None:
    """Install ``(mesh, placements)`` for the (B, S, d) activations, or None."""
    global _ACTIVATION_SHARDING
    _ACTIVATION_SHARDING = sharding


def constrain_activation(x: torch.Tensor) -> torch.Tensor:
    return _constrain(x, _ACTIVATION_SHARDING)


def set_moe_sharding(sharding) -> None:
    """Install ``(mesh, placements)`` for the 4-D dispatch buffers, or None."""
    global _MOE_SHARDING
    _MOE_SHARDING = sharding


def constrain_moe_buffer(x: torch.Tensor) -> torch.Tensor:
    """Pin the (G, E, C, d/f) expert-dispatch buffers so token redistribution
    happens once (data -> expert layout, the EP all-to-all) instead of
    replicating whole buffers."""
    if x.ndim != 4:
        return x
    return _constrain(x, _MOE_SHARDING)


@contextlib.contextmanager
def activation_sharding(sharding):
    global _ACTIVATION_SHARDING
    prev = _ACTIVATION_SHARDING
    _ACTIVATION_SHARDING = sharding
    try:
        yield
    finally:
        _ACTIVATION_SHARDING = prev
