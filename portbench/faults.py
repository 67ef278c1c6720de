"""Faults planted in the program under a run, for the check's own tests and
for the readings its limits are set from (``control.py``). Each is a
context manager that patches one function of ``repro_torch`` where the
benchmark's drivers call it; none is used by a benchmark run."""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def half_batch():
    """Each step's loss and gradient taken over the first half of its batch,
    the mean over the rest."""
    from repro_torch.train import train_step

    real = train_step.loss_and_grads

    def half(params, cfg, train_cfg, batch):
        n = next(iter(batch.values())).shape[0] // 2
        return real(params, cfg, train_cfg, {k: v[:n] for k, v in batch.items()})

    with mock.patch.object(train_step, "loss_and_grads", half):
        yield


@contextlib.contextmanager
def loss_altered(share: float = 0.01):
    """Each step's reported loss ``share`` above the one it computed."""
    from repro_torch.train import train_step

    real = train_step.loss_and_grads

    def altered(params, cfg, train_cfg, batch):
        grads, metrics = real(params, cfg, train_cfg, batch)
        return grads, dict(metrics, loss=metrics["loss"] * (1.0 + share))

    with mock.patch.object(train_step, "loss_and_grads", altered):
        yield


@contextlib.contextmanager
def state_unchanged():
    """A step that returns the parameters and the optimizer's state as they
    came in."""
    import torch
    from repro_torch.train import train_step

    def unchanged(opt_cfg, params, grads, state):
        zero = torch.zeros((), dtype=torch.float32)
        return params, state, {"grad_norm": zero, "lr": zero, "clip_scale": zero}

    with mock.patch.object(train_step, "apply_updates", unchanged):
        yield


@contextlib.contextmanager
def stale_answer():
    """Every prefill returns the first prefill's logits."""
    from repro_torch.models import model

    real = model.prefill
    first = []

    def stale(params, cfg, tokens, *rest):
        if not first:
            first.append(real(params, cfg, tokens, *rest))
        return first[0]

    with mock.patch.object(model, "prefill", stale):
        yield


@contextlib.contextmanager
def half_batch_prefill():
    """Each prefill computes the first half of its prompts and answers the
    rest with those answers again."""
    from repro_torch.models import model

    real = model.prefill

    def half(params, cfg, tokens, *rest):
        B = tokens.shape[0]
        n = max(B // 2, 1)
        logits, aux = real(params, cfg, tokens[:n], *rest)
        return logits.repeat(-(-B // n), 1, 1)[:B], aux

    with mock.patch.object(model, "prefill", half):
        yield


@contextlib.contextmanager
def token_altered():
    """Each prompt's last token id raised by one where the prefill reads
    it."""
    from repro_torch.models import model

    real = model.prefill

    def altered(params, cfg, tokens, *rest):
        tokens = tokens.clone()
        tokens[:, -1] = (tokens[:, -1] + 1) % cfg.vocab
        return real(params, cfg, tokens, *rest)

    with mock.patch.object(model, "prefill", altered):
        yield
