"""The port's flash attention (``repro_torch.kernels``) against the JAX
package's, on the CPU: ``ops.flash_attention`` runs its plain version here
(``blockwise_attention``), held against the Pallas kernel in interpret mode
and against the dense oracle over ``tests/test_kernels.py``'s cases and GQA
groups of 9 (starcoder2-7b's), with that file's tolerances, and with the
keywords the model never passes (``causal=False``, a caller's ``scale``), and
at MLA's head dims (v narrower than q and k). The bf16 kernel's arithmetic (P rounded to bf16 for P.V) is
emulated here and held to the same references and to the JAX model's logits;
its host-side plan is checked for every (D, Dv) pair. Inputs are made with
numpy from a seed."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import ATTN_CASES
from test_torch_models import _pair, _tokens, bf16_tol

import repro.configs as jm_configs
import repro.models as jm
from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
import repro_torch.configs as tm_configs
import repro_torch.models as tm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models.convert import params_from_jax

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


# GQA groups of 9 query heads a kv head at D=128, starcoder2-7b's (36 over
# 4), which neither tests/test_kernels.py nor a smoke config has: (B, S, H,
# KH, D, window, bq, bk)
GROUP9_CASES = [(1, 128, 9, 1, 128, 0, 64, 64), (2, 192, 18, 2, 128, 0, 64, 64)]


@pytest.mark.parametrize("case", ATTN_CASES + GROUP9_CASES)
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


# (B, S, H, KH, D, window, bq, bk), causal, scale: not causal with window 0
# and > 0, and scales other than D**-0.5, causal or not
KEYWORD_CASES = [
    ((1, 128, 4, 4, 64, 0, 64, 64), False, None),
    ((2, 256, 4, 2, 64, 96, 64, 64), False, None),
    ((1, 256, 4, 1, 128, 0, 64, 128), False, 0.05),
    ((2, 256, 8, 2, 64, 0, 128, 64), True, 0.3),
    ((1, 512, 2, 2, 32, 128, 128, 128), False, 0.25),
    ((1, 128, 2, 2, 96, 0, 128, 128), True, 1.5),
]


def _keyword_refs(q, k, v, case, causal, scale):
    """The JAX package's Pallas kernel (interpret mode) and dense oracle, in
    the model layout."""
    B, S, H, KH, D, window, bq, bk = case
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    pallas = t(jflash.flash_attention_hsd(t(q), t(k), t(v), causal=causal, window=window,
                                          scale=scale, block_q=bq, block_k=bk, interpret=True))
    oracle = t(jref.flash_attention_ref(t(q), t(k), t(v), causal=causal, window=window,
                                        scale=scale))
    return pallas, oracle


@pytest.mark.parametrize("case, causal, scale", KEYWORD_CASES)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_flash_keywords_match_pallas_and_oracle(case, causal, scale, name):
    """``flash_attention_hsd``, ``ops.flash_attention`` and the port's
    oracle take ``causal=`` and ``scale=`` as the JAX package's do, and
    agree with its Pallas kernel and its oracle."""
    B, S, H, KH, D, window, bq, bk = case
    (q, k, v), (tq, tk, tv) = _inputs(
        sum(case) + 3, [(B, S, H, D), (B, S, KH, D), (B, S, KH, D)], name
    )
    pallas, oracle = _keyword_refs(q, k, v, case, causal, scale)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    got = t(fa.flash_attention_hsd(t(tq), t(tk), t(tv), causal=causal, window=window,
                                   scale=scale, chunk=bq))
    assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol(name))
    np.testing.assert_allclose(_np(got), _np(oracle), **tol(name))
    if scale is None:  # the model-layout wrapper takes causal= as the JAX one does
        mine = ops.flash_attention(tq, tk, tv, causal=causal, window=window, chunk=bq)
        np.testing.assert_allclose(_np(mine), _np(pallas), **tol(name))
        jmine = jops.flash_attention(q, k, v, causal=causal, window=window, block_q=bq,
                                     block_k=bk, interpret=True)
        np.testing.assert_allclose(_np(mine), _np(jmine), **tol(name))
    dense = t(ref.flash_attention_ref(t(tq), t(tk), t(tv), causal=causal, window=window,
                                      scale=scale))
    np.testing.assert_allclose(_np(dense), _np(oracle), **tol(name))


def test_noncausal_blockwise_visits_every_tile():
    """Without the causal mask a query's output depends on later keys: with
    the tiles after the diagonal skipped, changing the last key would not
    change the first query's row."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(np.float32))
               for _ in range(3))
    base = fa.blockwise_attention(q, k, v, chunk=16, causal=False)
    v2 = v.clone()
    v2[:, -1] += 1.0
    moved = fa.blockwise_attention(q, k, v2, chunk=16, causal=False)
    assert not torch.allclose(base[:, 0], moved[:, 0])
    assert torch.equal(fa.blockwise_attention(q, k, v, chunk=16)[:, 0],
                       fa.blockwise_attention(q, k, v2, chunk=16)[:, 0])


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


def wgmma_emulation(q, k, v, *, causal=True, window=0, scale=None):
    """The bf16 kernel's arithmetic (``csrc/flash_attention_wgmma.cu``) in
    the heads-major layout: bf16 operands with f32 sums, the scale (``D**-0.5``
    when None) applied to the f32 scores (in base 2, as the kernel's exp2), an
    online softmax over kv tiles of the plan's ``block_k`` keys with the
    -1e30 sentinel, the causal mask only when ``causal``, l summed from the
    f32 P, and P rounded to bf16 before P.V (at v's own head dim)."""
    B, H, S, D = q.shape
    Dv = v.shape[-1]
    G = H // k.shape[1]
    bk = fa.wgmma_plan(D, Dv).block_k
    c = (D**-0.5 if scale is None else scale) * math.log2(math.e)
    qf = q.float()
    kf, vf = (x.repeat_interleave(G, dim=1).float() for x in (k, v))
    pos = torch.arange(S)
    m = torch.full((B, H, S), fa.NEG_INF)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, Dv))
    for k0 in range(0, S, bk):
        u = qf @ kf[:, :, k0 : k0 + bk].transpose(-1, -2) * c
        pk = pos[k0 : k0 + bk]
        live = torch.ones((S, pk.numel()), dtype=torch.bool)
        if causal:
            live &= pk[None, :] <= pos[:, None]
        if window > 0:
            live &= pk[None, :] > pos[:, None] - window
        u = torch.where(live, u, fa.NEG_INF)
        m_new = torch.maximum(m, u.amax(-1))
        p = torch.exp2(u - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.bfloat16().float() @ vf[:, :, k0 : k0 + bk]
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _emulated_attention(q, k, v, *, causal=True, window=0, scale=None, chunk=1024):
    """:func:`wgmma_emulation` in the model layout, as ``ops.flash_attention``."""
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(wgmma_emulation(t(q), t(k), t(v), causal=causal, window=window, scale=scale))


@pytest.mark.parametrize("case", ATTN_CASES + GROUP9_CASES)
def test_wgmma_arithmetic_matches_pallas_and_oracle(case):
    """P in bf16 for P.V fits the bf16 tolerance the card holds the kernel to."""
    B, S, H, KH, D, window, bq, bk = case
    (q, k, v), (tq, tk, tv) = _inputs(
        sum(case), [(B, S, H, D), (B, S, KH, D), (B, S, KH, D)], "bfloat16"
    )
    got = _emulated_attention(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, H, D)
    pallas = jops.flash_attention(
        q, k, v, causal=True, window=window, block_q=bq, block_k=bk, interpret=True
    )
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    oracle = t(jref.flash_attention_ref(t(q), t(k), t(v), causal=True, window=window))
    np.testing.assert_allclose(_np(got), _np(pallas), **tol("bfloat16"))
    np.testing.assert_allclose(_np(got), _np(oracle), **tol("bfloat16"))


@pytest.mark.parametrize("case, causal, scale", KEYWORD_CASES)
def test_wgmma_arithmetic_keywords_match_pallas_and_oracle(case, causal, scale):
    """The emulated bf16 kernel with ``causal=False`` and a caller's scale
    fits the bf16 tolerance against the Pallas kernel and the oracle."""
    B, S, H, KH, D, window, bq, bk = case
    (q, k, v), (tq, tk, tv) = _inputs(
        sum(case) + 3, [(B, S, H, D), (B, S, KH, D), (B, S, KH, D)], "bfloat16"
    )
    pallas, oracle = _keyword_refs(q, k, v, case, causal, scale)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    got = t(wgmma_emulation(t(tq), t(tk), t(tv), causal=causal, window=window, scale=scale))
    np.testing.assert_allclose(_np(got), _np(pallas), **tol("bfloat16"))
    np.testing.assert_allclose(_np(got), _np(oracle), **tol("bfloat16"))


def test_wgmma_arithmetic_in_gemma3_forward(monkeypatch):
    """The emulated kernel in place of the attention of the gemma3-1b smoke
    forward (global and sliding-window layers) keeps the logits within the
    bound the bf16 forward is held to against the JAX package."""
    jc, tc, jp, tp = _pair("gemma3-1b-smoke", "bfloat16")
    tok = _tokens(jc)
    want = np.asarray(jm.forward(jp, jc, jnp.asarray(tok))[0])
    monkeypatch.setattr(tattn, "flash_attention", _emulated_attention)
    got, _ = tm.forward(tp, tc, torch.from_numpy(tok).long())
    np.testing.assert_allclose(got.numpy(), want, **bf16_tol(want))


@pytest.mark.parametrize("D, Dv", fa.HEAD_DIMS)
def test_wgmma_plan_fits_every_head_dim(D, Dv):
    """Every (D, Dv) pair gets a plan: whole 128-byte swizzled boxes of 64
    bf16 columns for q and k (D) and for v and o (Dv), a kv tile the wgmma
    shapes take, a ring that fits the block's 227 KB of shared memory
    (deepseek-v2's (192, 128) the largest: 48 KB of Q, a K ring of 96 KB
    and a V ring of 64 KB), and one CTA per (128-row q tile, head, batch)."""
    plan = fa.wgmma_plan(D, Dv)
    assert (plan.head_dim, plan.v_head_dim) == (D, Dv)
    for dim, pad in ((D, plan.d_pad), (Dv, plan.dv_pad)):
        assert pad >= dim and pad % fa.BOX_COLS == 0 and pad - dim < fa.BOX_COLS
    assert plan.box_q == (64, 128) and plan.box_kv == (64, plan.block_k)
    assert plan.box_q[0] * 2 == 128  # bytes: the swizzle's span
    assert plan.block_k in (64, 128) and plan.stages >= 2
    # f32 accumulators a consumer thread holds: O (64 x dv_pad) and S (64 x block_k)
    assert (plan.dv_pad + plan.block_k) // 2 <= 192
    assert plan.smem_bytes <= fa.SMEM_LIMIT == 227 * 1024
    q_tile = fa.BLOCK_Q * plan.d_pad * 2
    ring = plan.stages * plan.block_k * (plan.d_pad + plan.dv_pad) * 2
    # and the mbarriers (q; k full, v full, empty a slot) with 1024 bytes of alignment slack
    assert plan.smem_bytes == q_tile + ring + 1024 + 8 * (1 + 3 * plan.stages)
    if (D, Dv) == (192, 128):
        assert (q_tile, ring) == (48 * 1024, 160 * 1024) and plan.d_pad // fa.BOX_COLS == 3
    assert plan.block_k == (64 if Dv == 256 else 128)  # as before v had a head dim of its own
    for B, H, S in ((1, 4, 1), (2, 8, 77), (1, 32, 1000), (1, 4, 32768)):
        assert plan.grid(B, H, S) == math.ceil(S / 128) * H * B


def test_wgmma_plan_rejects_other_head_dims():
    for D in (8, 48, 80, 192, 512):
        with pytest.raises(ValueError, match="head dim"):
            fa.wgmma_plan(D, D)
    for D, Dv in ((192, 192), (96, 48), (128, 64), (64, 128), (96, 128)):
        with pytest.raises(ValueError, match="head dims"):
            fa.wgmma_plan(D, Dv)


# MLA's prefill attention: (B, S, H, D = qk_nope + qk_rope, Dv, window,
# chunk); minicpm3-4b's and deepseek-v2's head dims at a short S, and the
# smoke configs' (16 + 8, 16)
MLA_CASES = [
    (2, 64, 4, 96, 64, 0, 16),
    (1, 128, 3, 192, 128, 0, 32),
    (2, 96, 2, 24, 16, 0, 32),
    (1, 128, 2, 96, 64, 40, 64),
]


@pytest.mark.parametrize("case", MLA_CASES)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_flash_mla_dims_match_oracle_and_jax_blockwise(case, name):
    """v narrower than q and k, MLA's scale (D**-0.5 of the whole q.k head),
    causal: ``ops.flash_attention`` (the plain version here) and
    ``flash_attention_hsd`` against the JAX package's dense oracle and its
    ``blockwise_attention`` (what its MLA prefill runs). The Pallas kernel
    takes one head dim for q, k and v, so it is no witness here."""
    B, S, H, D, Dv, window, chunk = case
    (q, k, v), (tq, tk, tv) = _inputs(sum(case), [(B, S, H, D), (B, S, H, D), (B, S, H, Dv)],
                                      name)
    scale = D**-0.5
    got = ops.flash_attention(tq, tk, tv, window=window, scale=scale, chunk=chunk)
    assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (B, S, H, Dv)
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    oracle = t(jref.flash_attention_ref(t(q), t(k), t(v), window=window, scale=scale))
    twin = jattn.blockwise_attention(q, k, v, window=window, chunk=chunk, scale=scale)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol(name))
    np.testing.assert_allclose(_np(got), _np(twin), **tol(name))
    tt = lambda x: x.transpose(1, 2)  # noqa: E731
    hsd = tt(fa.flash_attention_hsd(tt(tq), tt(tk), tt(tv), window=window, scale=scale,
                                    chunk=chunk))
    assert torch.equal(hsd, got)
    mine = tt(ref.flash_attention_ref(tt(tq), tt(tk), tt(tv), window=window, scale=scale))
    np.testing.assert_allclose(_np(mine), _np(oracle), **tol(name))


@pytest.mark.parametrize("case", [c for c in MLA_CASES if (c[3], c[4]) in fa.HEAD_DIMS])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_arithmetic_mla_dims_match_oracle(case, causal):
    """The emulated bf16 kernel at MLA's (D, Dv) pairs, with MLA's scale,
    causal or not, fits the bf16 tolerance against the JAX package's dense
    oracle and its blockwise twin."""
    B, S, H, D, Dv, window, chunk = case
    (q, k, v), (tq, tk, tv) = _inputs(sum(case) + 1,
                                      [(B, S, H, D), (B, S, H, D), (B, S, H, Dv)], "bfloat16")
    scale = D**-0.5
    got = _emulated_attention(tq, tk, tv, causal=causal, window=window, scale=scale)
    assert tuple(got.shape) == (B, S, H, Dv)
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    oracle = t(jref.flash_attention_ref(t(q), t(k), t(v), causal=causal, window=window,
                                        scale=scale))
    np.testing.assert_allclose(_np(got), _np(oracle), **tol("bfloat16"))
    if causal:
        twin = jattn.blockwise_attention(q, k, v, window=window, chunk=chunk, scale=scale)
        np.testing.assert_allclose(_np(got), _np(twin), **tol("bfloat16"))


def test_wgmma_arithmetic_in_minicpm3_forward(monkeypatch):
    """The emulated kernel in place of the attention of a minicpm3-4b
    forward cut to width at its own MLA head dims (qk 64 + 32, v 64; two
    layers, 4 heads) keeps the logits within the bound the bf16 forward is
    held to against the JAX package."""
    import dataclasses as dc

    narrow = dict(d_model=64, vocab=512, n_heads=4, n_kv_heads=4, q_lora_rank=32,
                  kv_lora_rank=32, d_ff=128, n_pattern_repeats=2)
    jc = dc.replace(jm_configs.get_config("minicpm3-4b"), **narrow)
    tc = dc.replace(tm_configs.get_config("minicpm3-4b"), **narrow)
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    tok = _tokens(jc)
    want = np.asarray(jm.forward(jp, jc, jnp.asarray(tok))[0])
    seen = []

    def emulated(q, k, v, **kw):
        seen.append((q.shape[-1], v.shape[-1]))
        return _emulated_attention(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", emulated)
    got, _ = tm.forward(tp, tc, torch.from_numpy(tok).long())
    assert seen == [(96, 64)] * 2
    np.testing.assert_allclose(got.numpy(), want, **bf16_tol(want))
