"""Training losses: next-token CE, plus the MoE auxiliaries and the optional
multi-token-prediction term (the JAX package's ``train/losses.py``)."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

Tensor = torch.Tensor

__all__ = ["cross_entropy", "total_loss"]


def cross_entropy(logits: Tensor, labels: Tensor, *, ignore_id: int = -1) -> Tensor:
    """Mean next-token CE in f32 over the labels that are not ``ignore_id``;
    logits (B, S, V), labels (B, S). ``logsumexp - gather``, as the
    reference writes it, never materializes a second normalized (B, S, V)
    tensor."""
    logits = logits.float()
    lz = torch.logsumexp(logits, dim=-1)
    labels_ = labels.clamp_min(0).long()
    if isinstance(logits, DTensor):
        # the dry run shards the vocab: a gather along it yields a partial
        # DTensor cannot reduce, and nll_loss's backward is whole on every
        # rank; the label's logit picked by a mask keeps its gradient
        # sharded as the logits are
        hit = labels_[..., None] == torch.arange(logits.shape[-1], device=logits.device)
        picked = torch.where(hit, logits, 0.0).sum(dim=-1)
    else:
        picked = logits.gather(-1, labels_[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((lz - picked) * mask) / torch.clamp(mask.sum(), min=1.0)


def total_loss(
    logits: Tensor,
    labels: Tensor,
    aux: dict,
    *,
    moe_balance_weight: float = 0.01,
    moe_zloss_weight: float = 1e-4,
    mtp_logits: Tensor | None = None,
    mtp_weight: float = 0.0,
) -> tuple[Tensor, dict]:
    """CE plus the MoE load-balance and router z-loss terms and, with
    ``mtp_logits`` and a positive ``mtp_weight``, the CE of the head that
    predicts token t+2. Returns (loss, metrics)."""
    ce = cross_entropy(logits, labels)
    loss = ce
    metrics = {"ce": ce}
    if "moe_balance_loss" in aux:
        loss = loss + moe_balance_weight * aux["moe_balance_loss"]
        loss = loss + moe_zloss_weight * aux.get("moe_router_zloss", 0.0)
        metrics["moe_balance"] = aux["moe_balance_loss"]
        metrics["moe_dropped_frac"] = aux.get("moe_dropped_frac", 0.0)
    if mtp_logits is not None and mtp_weight > 0.0:
        # predict t+2: shift the labels left once more, ignore the tail
        mtp_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1)
        mtp = cross_entropy(mtp_logits, mtp_labels)
        loss = loss + mtp_weight * mtp
        metrics["mtp_ce"] = mtp
    metrics["loss"] = loss
    return loss, metrics
