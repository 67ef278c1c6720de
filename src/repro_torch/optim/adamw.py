"""AdamW, the JAX package's ``optim/adamw.py`` in PyTorch: a configurable
moment dtype, global-norm clipping, decoupled weight decay, warmup then
cosine decay, and an optional Adafactor-style factored second moment.

The JAX package decides two things from a leaf's rank: weight decay applies
where ``p.ndim >= 2``, and the factored second moment where the leaf has two
dims or more. Its stack keeps each pattern position's leaves stacked over
the ``n_pattern_repeats`` groups, so a group's RMSNorm scale there is an
``(R, d)`` leaf: decayed, and under ``factored_second_moment`` factored with
one column moment ``v_c`` shared by the groups. The port keeps one tensor a
layer, so every rule here follows the reference leaf's rank
(``models/transformer.py::reference_leaves``): a tensor inside ``stack.groups``
counts one rank more. A group's stacked matrices factor per layer, which is
what the reference computes for ``(R, din, dout)``; a group's 1-D tensors
factor together, each group's copy of ``v_c`` holding the same shared values.

``apply_updates`` updates the parameters and the moments in place, under
``torch.no_grad``, and returns them with the new step and the metrics.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.transformer import reference_leaves
from ..tree import tree_leaves, tree_map

Tensor = torch.Tensor

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state", "schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # rank-1 factored second moment over the last two dims: v drops from
    # O(params) to O(rows + cols)
    factored_second_moment: bool = False


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * lr``, in f32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * progress))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _slots(params: dict):
    """(tensor, reference rank, stacked) for every tensor, by reference
    leaf."""
    for _, tensors, stacked in reference_leaves(params):
        yield [(t, t.dim() + stacked, stacked) for t in tensors]


def init_state(cfg: AdamWConfig, params: dict) -> dict:
    """Zero moments: ``m`` and ``v`` in the moment dtype, or, factored, ``m``
    and the f32 ``v_r`` (rows; the whole v of a leaf of rank < 2) and
    ``v_c`` (columns; a zero-size stub where v_r holds the whole v)."""
    dt = getattr(torch, cfg.moment_dtype)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
    if not cfg.factored_second_moment:
        v = tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
        return {"m": m, "v": v, "step": step}
    rank = {id(t): (r, stacked) for leaf in _slots(params) for t, r, stacked in leaf}

    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def v_r(p):
        r, _ = rank[id(p)]
        return zeros(p.shape[:-1] if r >= 2 else p.shape, p)

    def v_c(p):
        r, _ = rank[id(p)]
        return zeros(p.shape[:-2] + p.shape[-1:] if r >= 2 else (0,), p)

    return {"m": m, "v_r": tree_map(v_r, params), "v_c": tree_map(v_c, params), "step": step}


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict
                  ) -> tuple[dict, dict, dict]:
    """One AdamW step in place; returns (params, state, metrics) with the
    metrics ``grad_norm``, ``lr`` and ``clip_scale`` as 0-d f32 tensors."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def finish(p, g, m, vh, rank):
        m_new = b1 * m.float() + (1 - b1) * g
        delta = (m_new / bc1) / (torch.sqrt(vh) + cfg.eps)
        if rank >= 2:  # decoupled weight decay on the reference's matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)

    def leaves(tree):
        return [tensors for _, tensors, _ in reference_leaves(tree)]

    if not cfg.factored_second_moment:
        for slots, gs, ms, vs in zip(_slots(params), leaves(grads), leaves(state["m"]),
                                     leaves(state["v"])):
            for (p, rank, _), g, m, v in zip(slots, gs, ms, vs):
                g = g.float() * scale
                v_new = b2 * v.float() + (1 - b2) * g * g
                finish(p, g, m, v_new / bc2, rank)
                v.copy_(v_new)
    else:
        for slots, gs, ms, vrs, vcs in zip(_slots(params), leaves(grads), leaves(state["m"]),
                                           leaves(state["v_r"]), leaves(state["v_c"])):
            p0, rank, stacked = slots[0]
            if rank >= 2 and p0.dim() < 2:  # a group's 1-D tensors: one (R, d) leaf
                g = torch.stack([g.float() * scale for g in gs])
                g2 = g * g + 1e-30
                vr_new = b2 * torch.stack(vrs) + (1 - b2) * g2.mean(dim=-1)
                vc_new = b2 * vcs[0] + (1 - b2) * g2.mean(dim=-2)
                denom = torch.clamp(vr_new.mean(dim=-1, keepdim=True), min=1e-30)
                vh = (vr_new[:, None] * vc_new[None, :]) / denom[:, None]
                for i, ((p, _, _), m, vr, vc) in enumerate(zip(slots, ms, vrs, vcs)):
                    finish(p, g[i], m, vh[i] / bc2, rank)
                    vr.copy_(vr_new[i])
                    vc.copy_(vc_new)
                continue
            for (p, rank, _), g, m, vr, vc in zip(slots, gs, ms, vrs, vcs):
                g = g.float() * scale
                g2 = g * g + 1e-30
                if rank >= 2:
                    vr_new = b2 * vr + (1 - b2) * g2.mean(dim=-1)
                    vc_new = b2 * vc + (1 - b2) * g2.mean(dim=-2)
                    denom = torch.clamp(vr_new.mean(dim=-1, keepdim=True), min=1e-30)
                    vh = (vr_new[..., None] * vc_new[..., None, :]) / denom[..., None]
                    vc.copy_(vc_new)
                else:
                    vr_new = b2 * vr + (1 - b2) * g2
                    vh = vr_new
                finish(p, g, m, vh / bc2, rank)
                vr.copy_(vr_new)
    new_state = {k: v for k, v in state.items() if k != "step"}
    new_state["step"] = step
    return params, new_state, {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
