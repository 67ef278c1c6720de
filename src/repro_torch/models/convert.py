"""Carry the JAX package's parameters over to the port.

``params_from_jax`` takes the JAX ``init_params`` tree with every leaf as a
numpy array (``jax.tree.map(np.asarray, params)``) and returns the port's
tree on ``device``. The JAX stack keeps each pattern position's leaves
stacked over the ``n_pattern_repeats`` groups (its ``lax.scan`` layout); the
port keeps one dict per block, so group g, pattern position i becomes layer
``len(prefix) + g * len(pattern) + i``. The shared attention mixer
(``stack["shared_attn"]``, ``None`` for every model but zamba2) is carried
once, and every ``shared_attn`` block reads it. Every leaf is carried as it
is, whatever its block: MLA's (``q_down``/``q_norm``/``q_up`` or ``wq``,
``kv_down``, ``kv_norm``, ``kv_up``, ``wo``) and MoE's (the f32 ``router``,
``w_up``/``w_gate``/``w_down`` stacked over the experts, the ``shared``
experts' MLP), a group-stacked leaf losing only its leading group axis. bf16
leaves (numpy's ``bfloat16`` extension type) are carried bit for bit. A
train state's ``mtp_proj`` (the MTP head) is carried when it is there.

``models/transformer.py::reference_leaves`` goes the other way. Nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: torch may not share read-only memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return tensor_from_numpy(x, device)


def params_from_jax(tree: dict, cfg, device="cuda") -> dict:
    stack = tree["stack"]
    groups = []
    for g in range(cfg.n_pattern_repeats):
        groups.append(
            tuple(
                _tree(_index(stack["groups"][i], g), device) for i in range(len(cfg.pattern))
            )
        )
    out = {
        "embed": tensor_from_numpy(tree["embed"], device),
        "final_norm": tensor_from_numpy(tree["final_norm"], device),
        "stack": {
            "prefix": [_tree(bp, device) for bp in stack["prefix"]],
            "groups": groups,
            "suffix": [_tree(bp, device) for bp in stack["suffix"]],
            "shared_attn": None
            if stack["shared_attn"] is None
            else _tree(stack["shared_attn"], device),
        },
    }
    for name in ("unembed", "mtp_proj"):
        if name in tree:
            out[name] = tensor_from_numpy(tree[name], device)
    return out


def _index(x, g: int):
    """Group ``g`` of a group-stacked subtree."""
    if isinstance(x, dict):
        return {k: _index(v, g) for k, v in x.items()}
    return x[g]
