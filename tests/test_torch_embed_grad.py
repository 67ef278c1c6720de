"""The embedding's bf16 gradient against the JAX package's.

At bf16 the gradient of ``table[tokens]`` sums a repeated token's rows in
bf16, rounding each partial sum, and so far from the exact sum. The JAX
package's ``embed_apply`` (``jnp.take``) does the same: ``jax.vjp`` of it
gives the port's gradient bit for bit, here on a heavy repeated-token case
(a fifth of 8192 positions on token 0), so the gap is the reference's too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.layers import embed_apply as ref_embed_apply
from repro_torch.models.layers import embed_apply

V, D, T = 64, 8, 8192


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, V, size=T).astype(np.int32)
    tokens[rng.random(T) < 0.2] = 0  # a fifth of the positions on one row
    table = rng.standard_normal((V, D)).astype(np.float32)
    cot = (rng.standard_normal((T, D)) * 0.1).astype(np.float32)
    return tokens, table, cot


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


def test_bf16_embedding_gradient_matches_jax_bit_for_bit():
    tokens, table, cot = _inputs()
    jt, jc = jnp.asarray(table, jnp.bfloat16), jnp.asarray(cot, jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: ref_embed_apply(t, jnp.asarray(tokens)), jt)
    (want,) = vjp(jc)

    tt = torch.from_numpy(table).to(torch.bfloat16).requires_grad_()
    tc = torch.from_numpy(cot).to(torch.bfloat16)
    (got,) = torch.autograd.grad(embed_apply(tt, torch.from_numpy(tokens)), [tt], tc)
    got_np = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got_np, _bits(want))

    # both miss the exact sum of token 0's (bf16) rows by the same margin
    exact = np.asarray(jc, np.float64)[tokens == 0].sum(0)
    gap = np.abs(got[0].float().numpy() - exact).max()
    ref_gap = np.abs(np.asarray(want[0], np.float64) - exact).max()
    assert gap == ref_gap and gap > 1e-2
