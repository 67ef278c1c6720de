"""The port's flash attention (``repro_torch.kernels``) against the JAX
package's, on the CPU: ``ops.flash_attention`` runs its plain version here
(``blockwise_attention``), held against the Pallas kernel in interpret mode and
against the dense oracle over ``tests/test_kernels.py``'s cases, with that
file's tolerances. Inputs are made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import ATTN_CASES

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    # tests/test_kernels.py: chunked-vs-sequential reassociation noise
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-4, atol=5e-4)


def _inputs(seed, shapes, name):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt, tdt = DTYPES[name]
    jx = [jnp.asarray(a, jdt) for a in arrs]
    # both sides see the same (rounded) values
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jx]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_flash_matches_pallas_and_oracle(case, name):
    B, S, H, KH, D, window, bq, bk = case
    (q, k, v), (tq, tk, tv) = _inputs(
        sum(case), [(B, S, H, D), (B, S, KH, D), (B, S, KH, D)], name
    )
    got = ops.flash_attention(tq, tk, tv, window=window, chunk=bq)
    assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (B, S, H, D)
    pallas = jops.flash_attention(
        q, k, v, causal=True, window=window, block_q=bq, block_k=bk, interpret=True
    )
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    oracle = t(jref.flash_attention_ref(t(q), t(k), t(v), causal=True, window=window))
    np.testing.assert_allclose(_np(got), _np(pallas), **tol(name))
    np.testing.assert_allclose(_np(got), _np(oracle), **tol(name))
    # the port's own dense oracle agrees with the JAX package's
    mine = ref.flash_attention_ref(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), window=window
    ).transpose(1, 2)
    np.testing.assert_allclose(_np(mine), _np(oracle), **tol(name))


@pytest.mark.parametrize("window", [0, 5, 24])
def test_blockwise_matches_jax_blockwise(window):
    """A window smaller than the chunk, equal-ish, and larger; f32."""
    B, S, H, KH, D, chunk = 2, 48, 4, 2, 16, 16
    (q, k, v), (tq, tk, tv) = _inputs(
        window + 7, [(B, S, H, D), (B, S, KH, D), (B, S, KH, D)], "float32"
    )
    want = jattn.blockwise_attention(q, k, v, window=window, chunk=chunk)
    got = tattn.blockwise_attention(tq, tk, tv, window=window, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fa.flash_attention_hsd(q, torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_hsd(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention_hsd(q, torch.zeros(1, 1, 8, 16), torch.zeros(1, 1, 8, 16), chunk=3)
    before = fa.flash_attention_hsd.launches
    fa.flash_attention_hsd(q, torch.zeros(1, 1, 8, 16), torch.zeros(1, 1, 8, 16))
    assert fa.flash_attention_hsd.launches == before  # the plain version is no launch


def test_attention_limit_scales_with_each_row():
    """The kernel-vs-plain comparison holds every row to the tolerance of its
    own scale: an error of 3% of the late rows' scale on a long causal
    sequence fails it, though a fixed atol of 2e-2 would let it through,
    while rounding the output to bf16 passes it."""
    S = 2048
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1, S, 32)).astype(np.float32))
               for _ in range(3))
    want = fa.flash_attention_plain(q, k, v)
    assert ref.row_limit_ratio(want.bfloat16(), want, 2e-2) <= 1.0
    rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    late = want.clone()
    late[..., S - 256 :, :] += 0.03 * rms[..., S - 256 :, :]
    torch.testing.assert_close(late, want, rtol=2e-2, atol=2e-2)
    assert ref.row_limit_ratio(late, want, 2e-2) > 1.0
