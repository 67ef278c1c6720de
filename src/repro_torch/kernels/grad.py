"""The model kernels' gradients: the kernel's forward, the plain version's
backward.

The JAX package trains through the jnp twins of its Pallas kernels
(``jax.value_and_grad`` of the loss; no ``custom_vjp`` reaches a
``pallas_call``), so it has no backward kernel and neither has the port.
Each kernel's ``torch.autograd.Function`` (``FlashAttention``, ``SSDScan``,
``RWKV6Scan``) launches the kernel in its forward and saves its inputs; its
backward recomputes the plain version on them under autograd and returns that
version's gradients, bit for bit what autograd gives through the plain version
at the same inputs.
"""
from __future__ import annotations

import torch

__all__ = ["plain_gradients"]


def plain_gradients(ctx, plain, grad_out: torch.Tensor) -> tuple:
    """The gradients of ``plain(*saved inputs, **ctx.kw)`` against
    ``grad_out``: one for each saved input that needs one, None for the
    others (``ctx.needs_input_grad``), then None for the keywords argument."""
    saved = ctx.saved_tensors  # unpacked once: remat's hooks allow no second unpack
    needs = ctx.needs_input_grad[: len(saved)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*leaves, **ctx.kw)
        grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], grad_out))
    return (*(next(grads) if n else None for n in needs), None)
