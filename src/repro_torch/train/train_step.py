"""The train step: forward, CE (plus the MoE terms and the optional MTP
head), the gradient, clipping and AdamW, with optional gradient accumulation
over microbatches (the JAX package's ``train/train_step.py``).

``make_train_step(cfg, opt_cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``. The gradient is autograd's through the model: on the card
the forward runs the hand-written kernels and each kernel's gradient is its
plain version's (``kernels/grad.py``), as the JAX package trains through the
jnp twins of its Pallas kernels. Each microbatch's gradient is taken with
``torch.autograd.grad`` and accumulated in f32, divided by their count; the
parameters' ``.grad`` is never used. ``apply_updates`` updates the parameters
and the moments in place, so the returned state holds the same tensors as the
one passed in, with a new step.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import forward, init_params
from ..models.layers import dense_init, unembed_apply
from ..models.model import _generator, param_dtype
from ..optim import AdamWConfig, apply_updates, init_state
from ..tree import tree_leaves, tree_map
from .losses import total_loss

Tensor = torch.Tensor

__all__ = ["TrainConfig", "init_train_state", "loss_and_grads", "make_train_step",
           "split_microbatches"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1  # gradient accumulation steps per train step
    mtp_weight: float = 0.0
    moe_balance_weight: float = 0.01


def init_train_state(cfg, opt_cfg: AdamWConfig, generator: torch.Generator | int = 0, *,
                     train_cfg: TrainConfig | None = None, device="cuda") -> dict:
    """Parameters from the seed or generator on ``device`` (requiring a
    gradient; with an MTP weight, ``mtp_proj`` drawn after them), zero AdamW
    moments, step 0."""
    train_cfg = train_cfg or TrainConfig()
    gen = _generator(generator, torch.device(device))
    params = init_params(cfg, gen, device=device)
    if train_cfg.mtp_weight > 0.0:
        with torch.no_grad():
            params["mtp_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, param_dtype(cfg),
                                            torch.device(device))
    params = tree_map(lambda t: t.requires_grad_(), params)
    step = torch.zeros((), dtype=torch.int32, device=device)
    return {"params": params, "opt": init_state(opt_cfg, params), "step": step}


def _loss_fn(params: dict, cfg, train_cfg: TrainConfig, batch: dict) -> tuple[Tensor, dict]:
    want_mtp = train_cfg.mtp_weight > 0.0 and "mtp_proj" in params
    logits, aux = forward(params, cfg, batch["tokens"], batch.get("frontend_embeds"),
                          return_hidden=want_mtp)
    mtp_logits = None
    if want_mtp:  # the MTP head: unembed the projected final hidden state
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        mtp_logits = unembed_apply(table, aux.pop("hidden") @ params["mtp_proj"])
    return total_loss(logits, batch["labels"], aux,
                      moe_balance_weight=train_cfg.moe_balance_weight, mtp_logits=mtp_logits,
                      mtp_weight=train_cfg.mtp_weight)


def _grads(params: dict, cfg, train_cfg: TrainConfig, batch: dict) -> tuple[list, dict]:
    loss, metrics = _loss_fn(params, cfg, train_cfg, batch)
    # a parameter the loss does not reach gets a zero gradient, as in JAX
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                materialize_grads=True)
    return list(grads), {k: torch.as_tensor(v).detach().float() for k, v in metrics.items()}


def split_microbatches(batch: dict, n: int) -> list[dict]:
    """The batch as ``n`` microbatches, each a slice along the first axis."""
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(n)]


def loss_and_grads(params: dict, cfg, train_cfg: TrainConfig, batch: dict) -> tuple[dict, dict]:
    """The gradient of the step's loss against every parameter, in the
    parameters' tree, and the loss metrics. With ``microbatches`` n > 1 the
    batch is split along its first axis and the gradients (in f32) and the
    metrics are the microbatches' sums divided by n."""
    n = train_cfg.microbatches
    if n == 1:
        grads, metrics = _grads(params, cfg, train_cfg, batch)
    else:
        grads, metrics = None, None
        for mb in split_microbatches(batch, n):
            g, m = _grads(params, cfg, train_cfg, mb)
            if grads is None:
                grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in g]
                metrics = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                           for k, v in m.items()}
            grads = [a + b.float() / n for a, b in zip(grads, g)]
            metrics = {k: metrics[k] + v / n for k, v in m.items()}
    it = iter(grads)
    return tree_map(lambda _: next(it), params), metrics


def make_train_step(cfg, opt_cfg: AdamWConfig, train_cfg: TrainConfig | None = None):
    train_cfg = train_cfg or TrainConfig()

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        grads, metrics = loss_and_grads(state["params"], cfg, train_cfg, batch)
        params, opt, opt_metrics = apply_updates(opt_cfg, state["params"], grads, state["opt"])
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {**metrics, **opt_metrics}

    return train_step
