"""Plain float32 reference of the benchmark's training steps, for any
architecture module (``arch``, such as ``mla.py``): next-token cross entropy
plus the experts' load-balance and router z-loss terms, the gradient by
autograd, global-norm clipping and AdamW.

AdamW is the program's rule, written out: bias-corrected moments in float32,
linear warm-up then cosine decay of the learning rate, decoupled weight decay
on the leaves the architecture's ``decayed`` names, and each updated weight
stored back in its own dtype (bfloat16, the norms and the router float32).
"""
from __future__ import annotations

import math

import torch

from portbench.reference.lowp import Arith

Tensor = torch.Tensor


def schedule(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of the rate."""
    warm = opt["warmup_steps"]
    if step < warm:
        return opt["lr"] * step / max(warm, 1)
    progress = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * progress))
    return opt["lr"] * frac


def loss_fn(arch, s, w: dict[str, Tensor], tokens: Tensor, labels: Tensor, ar: Arith,
            balance_weight: float, zloss_weight: float = 1e-4) -> Tensor:
    logits, total = arch.forward(s, w, tokens, ar)
    ce = (torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels.long()[..., None])[..., 0]
          ).mean()
    loss = ce
    if "moe_balance_loss" in total:
        loss = loss + balance_weight * total["moe_balance_loss"]
        loss = loss + zloss_weight * total["moe_router_zloss"]
    return loss


def clipped_grads(arch, s, w: dict[str, Tensor], batch: dict, clip_norm: float,
                  balance_weight: float, ar: Arith) -> tuple[float, dict, dict]:
    """One step's loss, each leaf's gradient as the optimizer takes it
    (clipped by the global norm), and each leaf's raw gradient's norm."""
    names = list(w)
    loss = loss_fn(arch, s, w, batch["tokens"], batch["labels"], ar, balance_weight)
    grads = torch.autograd.grad(loss, [w[k] for k in names])
    with torch.no_grad():
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads))
        scale = min(clip_norm / max(gnorm, 1e-9), 1.0)
        raw = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(names, grads)}
        for g in grads:
            g.mul_(scale)
    return float(loss.detach()), dict(zip(names, grads)), raw


def train_steps(arch, s, seed: int, batches: list[dict], opt: dict, balance_weight: float,
                device, ar: Arith | None = None, dtype=torch.bfloat16, first_grad=None) -> dict:
    """The first ``len(batches)`` steps from the weights drawn from ``seed``.
    Returns each step's loss, each leaf's norm of the first step's gradient
    as the optimizer takes it (clipped) and of its raw gradient, and each
    leaf's norm of the change in its stored value over the steps. With
    ``first_grad``, ``out["first"][leaf]`` is ``first_grad(leaf, gradient)``
    of each leaf's clipped first gradient."""
    ar = ar or Arith()
    stored = arch.all_weights(s, seed, device, dtype)
    dtypes = {k: t.dtype for k, t in stored.items()}
    w = {k: t.float().requires_grad_() for k, t in stored.items()}
    del stored
    names = list(w)
    m = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in w.items()}
    v = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in w.items()}
    b1, b2 = opt["beta1"], opt["beta2"]
    out: dict = {"loss": []}
    for step, batch in enumerate(batches, start=1):
        loss, grads, raw = clipped_grads(arch, s, w, batch, opt["clip_norm"], balance_weight, ar)
        out["loss"].append(loss)
        with torch.no_grad():
            lr = schedule(opt, step)
            bc1, bc2 = 1 - b1**step, 1 - b2**step
            if step == 1:
                out["grad_raw"] = raw
                out["grad"] = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
                if first_grad is not None:
                    out["first"] = {k: first_grad(k, g) for k, g in grads.items()}
            for k in names:
                g = grads.pop(k)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                m[k].mul_(b1).add_((1 - b1) * g)
                delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + opt["eps"])
                if arch.decayed(s, k, w[k]):
                    delta = delta + opt["weight_decay"] * w[k]
                w[k].copy_((w[k] - lr * delta).to(dtypes[k]).float())
        del grads
    del m, v
    with torch.no_grad():
        init = arch.all_weights(s, seed, device, dtype)
        out["change"] = {k: float(torch.linalg.vector_norm(w[k] - init[k].float()))
                         for k in names}
    return out
