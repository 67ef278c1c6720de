"""The port's SSM scans and mixers (``repro_torch.kernels.ssd`` / ``rwkv6`` and
``repro_torch.models.ssm``) against the JAX package's, on the CPU. Inputs are
made with numpy from a seed and handed to both packages bit for bit. The scan
wrappers run their chunked plain versions here; they are held to the JAX
package's Pallas kernels in interpret mode and to the sequential oracles at
``tests/test_kernels.py``'s cases and tolerances, and at the odd chunk lengths
the model passes for short prompts. The kernels' decompositions are emulated
here and held to the same references: the bf16 RWKV-6 kernel's (its bf16
hi + lo rounding points and its sequence split, also against the JAX model's
logits), and the f32 SSD and RWKV-6 kernels' (the SSD's C B^T once per
(b, chunk) and its chunks padded to their tile, the RWKV-6 sequence split).
The mixers run from the same parameters
(the JAX init carried over)."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_kernels import RWKV_CASES, SSD_CASES, tol
from test_torch_models import _pair, _tokens, bf16_tol

import repro.configs as jconfigs
import repro.models as jm
from repro.kernels import ops as jops
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
import repro_torch.models as tm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6 as trw
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.rwkv6 import rwkv6_chunked, rwkv6_scan_hsd
from repro_torch.kernels.ssd import ssd_chunked, ssd_scan_hsd
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import tensor_from_numpy

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
F32 = dict(rtol=1e-4, atol=1e-4)
# (B, S, H, P, N, chunk) at chunk lengths the model passes for prompts
# shorter than 64 tokens (min(64, pick_chunk(S))): 48, 37 and 24, and 8
SSD_ODD_CASES = [(2, 96, 3, 64, 16, 48), (1, 37, 2, 64, 64, 37), (2, 64, 2, 32, 16, 8),
                 (1, 120, 2, 16, 8, 24)]
# tests/test_kernels.py's f32 tolerance (rtol, atol as a share of each
# output row's root mean square, kernels.ref.row_limit_ratio)
F32_ROW = (2e-4, 5e-4)


def _both(a: np.ndarray, dtype: str = "float32"):
    """(jax array, torch tensor) holding the same values in ``dtype``."""
    j = jnp.asarray(a).astype(JDT[dtype])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _close(got, want, dtype: str, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **(kw or tol(JDT[dtype])))


def _ssd_inputs(case, dtype, seed=0):
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = _both(rng.standard_normal((B, S, H, P)), dtype)
    dt = _both(np.logaddexp(rng.standard_normal((B, S, H)) - 1.0, 0.0))  # softplus
    A = _both(-np.exp(rng.uniform(0.0, 2.0, H)))
    Bm = _both(rng.standard_normal((B, S, N)), dtype)
    Cm = _both(rng.standard_normal((B, S, N)), dtype)
    return x, dt, A, Bm, Cm


def _rwkv_inputs(case, dtype, seed=0):
    B, S, H, P, _ = case
    rng = np.random.default_rng(seed)
    r = _both(rng.standard_normal((B, S, H, P)) * 0.5, dtype)
    k = _both(rng.standard_normal((B, S, H, P)) * 0.5, dtype)
    v = _both(rng.standard_normal((B, S, H, P)), dtype)
    # decay across the model's whole valid range, logw in [-e, ~0)
    logw = _both(-np.exp(rng.uniform(-8.0, 1.0, (B, S, H, P))))
    u = _both(rng.standard_normal((H, P)) * 0.3)
    return r, k, v, logw, u


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", SSD_CASES + SSD_ODD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_and_sequential(case, dtype):
    chunk = case[-1]
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _ssd_inputs(case, dtype)
    before = ssd_scan_hsd.launches
    got = tops.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk)
    assert ssd_scan_hsd.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == tx.dtype and got.shape == tx.shape
    pallas = jops.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    _close(got, pallas, dtype)
    seq, seq_state = tref.ssd_sequential(tx, tdt, tA, tB, tC)
    _close(got, seq, dtype)
    y, state = ssd_chunked(tx, tdt, tA, tB, tC, chunk=chunk)
    assert torch.equal(y, got)
    _close(state, seq_state, "float32", **tol(jnp.float32))
    jseq, jstate = jssm.ssd_sequential(jx, jdt, jA, jB, jC)  # the two oracles agree
    _close(seq, jseq, dtype)
    _close(seq_state, jstate, "float32", **tol(jnp.float32))


@pytest.mark.parametrize("case", RWKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_plain_matches_pallas_and_sequential(case, dtype):
    chunk = case[-1]
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu) = _rwkv_inputs(case, dtype)
    before = rwkv6_scan_hsd.launches
    got = tops.rwkv6_scan(tr, tk, tv, tw, tu, chunk=chunk)
    assert rwkv6_scan_hsd.launches == before
    assert got.dtype == tr.dtype and got.shape == tr.shape
    pallas = jops.rwkv6_scan(jr, jk, jv, jw, ju, chunk=chunk, interpret=True)
    _close(got, pallas, dtype)
    seq, seq_state = tref.rwkv6_sequential(tr, tk, tv, tw, tu)
    _close(got, seq, dtype)
    y, state = rwkv6_chunked(tr, tk, tv, tw, tu, chunk=chunk)
    assert torch.equal(y, got)
    _close(state, seq_state, "float32", **tol(jnp.float32))
    jseq, jstate = jssm.rwkv6_sequential(jr, jk, jv, jw, ju)
    _close(seq, jseq, dtype)
    _close(seq_state, jstate, "float32", **tol(jnp.float32))


@settings(max_examples=8, deadline=None)
@given(chunks=st.integers(1, 3), n=st.sampled_from([4, 8]), seed=st.integers(0, 2**16))
def test_ssd_property_no_decay_cumsum(chunks, n, seed):
    """With A -> 0 (no decay) and C_t = B_t = const of unit norm, the SSD scan
    is a causal cumulative sum of dt_j * x_j."""
    B, Q, H, P = 1, 32, 2, 8
    S = chunks * Q
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((B, S, H)), 0.0).astype(np.float32))
    A = torch.full((H,), -1e-9)
    Bv = torch.ones((B, S, n)) / np.sqrt(n)
    out = tops.ssd_scan(x, dt, A, Bv, Bv, chunk=Q)
    expect = torch.cumsum(dt[..., None] * x, dim=1)
    np.testing.assert_allclose(out.numpy(), expect.numpy(), rtol=1e-4, atol=1e-4)


@settings(max_examples=8, deadline=None)
@given(
    chunks=st.integers(1, 4),
    h=st.sampled_from([1, 2]),
    p=st.sampled_from([8, 16]),
    seed=st.integers(0, 2**16),
)
def test_rwkv6_property_cliff_decay(chunks, h, p, seed):
    """At the model's decay clamp (|logw| = e, the strongest decay) on half
    the channels and nearly none on the rest, a cliff profile, the chunked
    scan at Q=16 still matches the sequential oracle."""
    B, Q = 1, 16
    S = chunks * Q
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, p)).astype(np.float32))
               for _ in range(3))
    u = torch.from_numpy(rng.standard_normal((h, p)).astype(np.float32))
    cliff = torch.where(torch.arange(p) < p // 2, -float(np.e), -1e-3)
    logw = cliff.expand(B, S, h, p).contiguous()
    out = tops.rwkv6_scan(r, k, v, logw, u, chunk=Q)
    expect, _ = tref.rwkv6_sequential(r, k, v, logw, u)
    np.testing.assert_allclose(out.numpy(), expect.numpy(), rtol=1e-4, atol=1e-4)


def _split(x):
    """x (f32) as bf16 hi and lo parts, each held in f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _mm_built(a, b):
    """A product of two operands built in f32, as the kernel feeds them to
    the tensor cores: hi.hi + hi.lo + lo.hi, f32 sums."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _mm_half(a, b):
    """A product of an operand built in f32 with a bf16 one: hi.b + lo.b."""
    ah, al = _split(a)
    return ah @ b + al @ b


def rwkv6_mma_emulation(r, k, v, logw, u, *, chunk=16, segment_chunks=None):
    """The bf16 kernel's arithmetic (``csrc/rwkv6_scan_mma.cu``) in the model
    layout ``(B, S, H, P)``: chunks zero-padded to 16 rows; exclusive decay
    cumsums; qn, kn, A, kdec and the state fed to their products as bf16 hi +
    lo pairs with f32 sums (v as it is, bf16); the u bonus and the decays in
    f32; the sequence cut into segments of ``segment_chunks`` chunks (the
    port's plan when None), whose end states run from zero, are passed along
    (``exp`` of the summed log decay), and enter each segment's y."""
    return _rwkv6_emulation(r, k, v, logw, u, chunk, segment_chunks, _mm_built, _mm_half)


def rwkv6_f32_emulation(r, k, v, logw, u, *, chunk=16, segment_chunks=None):
    """The f32 kernel's decomposition (``csrc/rwkv6_scan.cu``): the bf16
    kernel's (the same zero padding, cumsums, factorization, segment plan and
    state passing) with every product in f32."""
    return _rwkv6_emulation(r, k, v, logw, u, chunk, segment_chunks, torch.matmul, torch.matmul)


def _rwkv6_emulation(r, k, v, logw, u, chunk, segment_chunks, mm_built, mm_half):
    """The RWKV-6 kernels' decomposition; ``mm_built`` multiplies two
    operands built in f32, ``mm_half`` one built in f32 by v."""
    B, S, H, P = r.shape
    Q = min(chunk, S)
    nc = S // Q
    f32 = torch.float32

    def tiles(a):  # (B, H, nc, 16, P), rows Q..15 zero
        a = a.to(f32).transpose(1, 2).reshape(B, H, nc, Q, P)
        return torch.cat([a, a.new_zeros(B, H, nc, 16 - Q, P)], 3)

    rc, kc, vc, lw = (tiles(a) for a in (r, k, v, logw))
    cw = torch.cumsum(lw, 3)
    cwp = torch.cat([torch.zeros_like(cw[..., :1, :]), cw[..., :-1, :]], 3)
    end = cw[..., -1:, :]
    qn, kn, kd = rc * torch.exp(cwp), kc * torch.exp(-cw), kc * torch.exp(end - cw)
    bonus = (rc * u.to(f32)[None, :, None, None, :] * kc).sum(-1)
    i = torch.arange(16)
    A = torch.where(i[None, :] < i[:, None], mm_built(qn, kn.transpose(-1, -2)), 0.0)
    A = A + torch.diag_embed(bonus)
    y_intra = mm_half(A, vc)
    kdv = mm_half(kd.transpose(-1, -2), vc)  # (B, H, nc, P, P): S[p][q]
    dec = torch.exp(end[..., 0, :])[..., None]  # (B, H, nc, P, 1)
    seg = segment_chunks or trw.segment_chunks(B, H, S, P, Q)
    bounds = [(c, min(c + seg, nc)) for c in range(0, nc, seg)]
    state, entering = torch.zeros((B, H, P, P)), []
    for c0, c1 in bounds:  # the segments' end states from zero, passed along
        entering.append(state)
        s_end, ld = torch.zeros((B, H, P, P)), torch.zeros((B, H, P))
        for c in range(c0, c1):
            s_end = s_end * dec[:, :, c] + kdv[:, :, c]
            ld = ld + end[:, :, c, 0]
        state = torch.exp(ld)[..., None] * state + s_end
    ys = []
    for (c0, c1), s_in in zip(bounds, entering):  # y from each segment's entering state
        for c in range(c0, c1):
            ys.append(y_intra[:, :, c] + mm_built(qn[:, :, c], s_in))
            s_in = s_in * dec[:, :, c] + kdv[:, :, c]
    y = torch.stack(ys, 2)[..., :Q, :].reshape(B, H, S, P)
    return y.transpose(1, 2).to(r.dtype)


@pytest.mark.parametrize("segments", [None, 2])
@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_mma_arithmetic_matches_pallas_and_sequential(case, segments):
    """hi + lo operands keep the bf16 kernel inside the bf16 tolerance against
    the Pallas kernel and the sequential oracle, with the port's segment plan
    and with segments of two chunks (end states, passing, y)."""
    chunk = case[-1]
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu) = _rwkv_inputs(case, "bfloat16")
    got = rwkv6_mma_emulation(tr, tk, tv, tw, tu, chunk=chunk, segment_chunks=segments)
    assert got.dtype == torch.bfloat16 and got.shape == tr.shape
    pallas = jops.rwkv6_scan(jr, jk, jv, jw, ju, chunk=chunk, interpret=True)
    _close(got, pallas, "bfloat16")
    seq, _ = tref.rwkv6_sequential(tr, tk, tv, tw, tu)
    _close(got, seq, "bfloat16")


def test_rwkv6_mma_rounding_needs_hi_lo():
    """What the emulation guards: the same scan with every operand built in
    f32 rounded to bf16 alone leaves the bf16 tolerance at a model-like
    shape, while the kernel's hi + lo pairs stay well inside it."""
    (_, tr), (_, tk), (_, tv), (_, tw), (_, tu) = _rwkv_inputs((1, 256, 4, 64, 16), "bfloat16")
    want, _ = rwkv6_chunked(tr, tk, tv, tw, tu)
    assert tref.row_limit_ratio(rwkv6_mma_emulation(tr, tk, tv, tw, tu), want, 2e-2) < 0.5

    def hi_only(x):
        hi = x.bfloat16().float()
        return hi, torch.zeros_like(hi)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules[__name__], "_split", hi_only)
        rounded = rwkv6_mma_emulation(tr, tk, tv, tw, tu)
    assert tref.row_limit_ratio(rounded, want, 2e-2) > 1.0


def test_rwkv6_mma_arithmetic_in_rwkv6_forward(monkeypatch):
    """The emulated kernel in place of the wkv scan of the rwkv6-3b smoke
    forward keeps the logits within the bound the bf16 forward is held to
    against the JAX package."""
    jc, tc, jp, tp = _pair("rwkv6-3b-smoke", "bfloat16")
    tok = _tokens(jc)
    want = np.asarray(jm.forward(jp, jc, jnp.asarray(tok))[0])
    monkeypatch.setattr(tops, "rwkv6_scan", lambda *a, chunk=16: rwkv6_mma_emulation(
        *a, chunk=chunk, segment_chunks=1))
    got, _ = tm.forward(tp, tc, torch.from_numpy(tok).long())
    np.testing.assert_allclose(got.numpy(), want, **bf16_tol(want))


@pytest.mark.parametrize("P", [16, 32, 48, 64])
def test_rwkv6_segment_plan_counts_the_kernels_warps(P):
    """The bf16 kernel's segment plan counts the warps the launcher runs: a
    warp per value_cols(P) columns (32 where they divide P, else 16), so
    rwkv6-3b-like heads reach about TARGET_WARPS warps and short sequences
    keep segments of at least MIN_SEGMENT_CHUNKS chunks."""
    cols = trw.value_cols(P)
    assert cols == (32 if P % 32 == 0 else 16) and P % cols == 0
    B, H, S, Q = 1, 40, 32768, 16
    seg = trw.segment_chunks(B, H, S, P, Q)
    nseg = -(-(S // Q) // seg)
    warps = B * H * (P // cols) * nseg
    assert warps >= trw.TARGET_WARPS > B * H * (P // cols) * (nseg - 1)
    assert trw.segment_chunks(B, H, 256, P, Q) == 256 // Q  # one segment: a single grid


def ssd_f32_emulation(x, dt, A, Bm, Cm, *, chunk=64, padded=True):
    """The f32 SSD kernel's decomposition (``csrc/ssd_scan.cu``) in the model
    layout ``(B, S, H, P)``, all in f32: with ``padded``, each chunk of Q rows
    in its tile of ``ssd.chunk_tile(Q)`` rows whose padding rows are zero
    (x = B = C = dt = 0), as the kernel holds it; G = C B^T once per
    (b, chunk), shared by the heads (its first grid); per head W = mask(G
    exp(cum_i - cum_j) dt_j) and B o w with w_j = exp(cum_last - cum_j) dt_j;
    the state carried across every chunk from zero; y = exp(cum) (C S) + W x
    on the chunk's own rows."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    T = tssd.chunk_tile(Q) if padded else Q
    f32 = torch.float32

    def tiles(t):  # (B, S, ...) -> (B, nc, T, ...), rows Q..T-1 zero
        t = t.to(f32).reshape(B, nc, Q, *t.shape[2:])
        return torch.cat([t, torch.zeros((B, nc, T - Q, *t.shape[3:]), dtype=f32)], 2)

    xc, dtc, Bc, Cc = tiles(x), tiles(dt), tiles(Bm), tiles(Cm)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # once per (b, chunk)
    cum = torch.cumsum(dtc * A.to(f32), dim=2)  # (B, nc, T, H)
    ctot = cum[:, :, -1]  # (B, nc, H): the padding rows add no decay
    i = torch.arange(T)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # cum_i - cum_j
    W = torch.where((i[None, :] <= i[:, None])[None, None, :, :, None],
                    G[..., None] * torch.exp(diff) * dtc[:, :, None, :, :], 0.0)
    w = torch.exp(ctot[:, :, None, :] - cum) * dtc  # (B, nc, T, H)
    Bw = Bc[:, :, :, None, :] * w[..., None]  # (B, nc, T, H, N)
    right = torch.einsum("bcjhn,bcjhp->bchnp", Bw, xc)
    dec = torch.exp(ctot)[..., None, None]  # (B, nc, H, 1, 1)
    state, ys = torch.zeros((B, H, N, P)), []
    for c in range(nc):
        inter = torch.einsum("bin,bhnp->bihp", Cc[:, c], state) * torch.exp(cum[:, c])[..., None]
        ys.append((inter + torch.einsum("bijh,bjhp->bihp", W[:, c], xc[:, c]))[:, :Q])
        state = state * dec[:, c] + right[:, c]
    return torch.stack(ys, 1).reshape(B, S, H, P)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("case", SSD_CASES + SSD_ODD_CASES)
def test_ssd_f32_decomposition_matches_pallas_and_sequential(case, padded):
    """The f32 SSD kernel's decomposition against the Pallas kernel and the
    sequential oracle at f32 tolerance, at every chunk the kernel takes, with
    each chunk as it is and padded with zero rows to its tile instance."""
    chunk = case[-1]
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _ssd_inputs(case, "float32")
    got = ssd_f32_emulation(tx, tdt, tA, tB, tC, chunk=chunk, padded=padded)
    pallas = jops.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    assert tref.row_limit_ratio(got, torch.from_numpy(np.array(pallas)), *F32_ROW) <= 1.0
    seq, _ = tref.ssd_sequential(tx, tdt, tA, tB, tC)
    assert tref.row_limit_ratio(got, seq, *F32_ROW) <= 1.0


@pytest.mark.parametrize("segments", [None, 2])
@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_f32_decomposition_matches_pallas_and_sequential(case, segments):
    """The f32 RWKV-6 kernel's decomposition against the Pallas kernel and
    the sequential oracle at f32 tolerance, with the port's segment plan and
    with segments of two chunks."""
    chunk = case[-1]
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu) = _rwkv_inputs(case, "float32")
    got = rwkv6_f32_emulation(tr, tk, tv, tw, tu, chunk=chunk, segment_chunks=segments)
    assert got.dtype == torch.float32 and got.shape == tr.shape
    pallas = jops.rwkv6_scan(jr, jk, jv, jw, ju, chunk=chunk, interpret=True)
    assert tref.row_limit_ratio(got, torch.from_numpy(np.array(pallas)), *F32_ROW) <= 1.0
    seq, _ = tref.rwkv6_sequential(tr, tk, tv, tw, tu)
    assert tref.row_limit_ratio(got, seq, *F32_ROW) <= 1.0


@pytest.mark.parametrize("P", [16, 32, 48, 64, 128])
def test_ssd_f32_column_blocks_match_pallas(P):
    """The f32 SSD kernel's grid takes ``block_cols(P)`` value columns a block
    (64 where they divide P, else 16): its decomposition run block by block
    and put together matches the Pallas kernel and the sequential oracle at
    f32 tolerance."""
    cols = tssd.block_cols(P)
    assert cols == (64 if P % 64 == 0 else 16) and P % cols == 0
    case = (1, 96, 2, P, 16, 32)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _ssd_inputs(case, "float32", seed=P)
    got = torch.cat([ssd_f32_emulation(tx[..., p0:p0 + cols], tdt, tA, tB, tC, chunk=32)
                     for p0 in range(0, P, cols)], -1)
    pallas = jops.ssd_scan(jx, jdt, jA, jB, jC, chunk=32, interpret=True)
    assert tref.row_limit_ratio(got, torch.from_numpy(np.array(pallas)), *F32_ROW) <= 1.0
    seq, _ = tref.ssd_sequential(tx, tdt, tA, tB, tC)
    assert tref.row_limit_ratio(got, seq, *F32_ROW) <= 1.0


def test_ssd_chunk_tile_is_the_smallest_instance():
    """Every chunk of 1 to 128 rows runs in the smallest tile instance that
    holds it; longer chunks have none."""
    for Q in range(1, 129):
        tile = tssd.chunk_tile(Q)
        assert tile in tssd.CHUNKS and tile >= Q
        assert all(t < Q for t in tssd.CHUNKS if t < tile)
    with pytest.raises(ValueError, match="chunk"):
        tssd.chunk_tile(129)


@pytest.mark.parametrize("chunk", [17, 32, 64])
def test_rwkv6_wrapper_raises_above_chunk_16(chunk):
    """exp(-cumsum(logw)) reaches e^(Q e): finite in f32 only up to Q=16, so
    the wrapper refuses longer chunks on every device (the JAX package's
    model-layout wrapper defaults to 64)."""
    (_, r), (_, k), (_, v), (_, w), (_, u) = _rwkv_inputs((1, 64, 1, 16, 16), "float32")
    with pytest.raises(ValueError, match="chunk"):
        tops.rwkv6_scan(r, k, v, w, u, chunk=chunk)
    with pytest.raises(ValueError, match="chunk"):
        rwkv6_scan_hsd(*(t.transpose(1, 2) for t in (r, k, v, w)), u, chunk=chunk)
    assert tops.rwkv6_scan(r, k, v, w, u).shape == r.shape  # the default is 16


def test_scan_outputs_keep_the_model_layout():
    """The heads-major wrappers take transposed views of model-layout tensors;
    the result transposes back to a contiguous model-layout tensor."""
    from repro_torch.kernels.ssd import empty_in_layout

    x = torch.zeros(2, 5, 3, 4).transpose(1, 2)  # a (B, H, S, P) view of (B, S, H, P)
    y = empty_in_layout(x)
    assert y.shape == x.shape and y.stride() == x.stride()
    assert y.transpose(1, 2).is_contiguous()
    sliced = torch.zeros(2, 5, 20)[..., :12].reshape(2, 5, 3, 4).transpose(1, 2)
    assert empty_in_layout(sliced).transpose(1, 2).is_contiguous()


# ---------------------------------------------------------------------------
# the mixers, from the same parameters
# ---------------------------------------------------------------------------
def _mixer_pair(arch, dtype, init):
    jc = dataclasses.replace(jconfigs.get_config(arch), dtype=dtype)
    tc = dataclasses.replace(tconfigs.get_config(arch), dtype=dtype)
    jp = getattr(jssm, init)(jax.random.PRNGKey(3), jc, JDT[dtype])
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return jc, tc, jp, tp


def _mixer_tol(dtype, want):
    """f32 within 1e-4; bf16 by tests/test_torch_models.py's rule (rtol 2e-2,
    atol 2e-2 of the largest output)."""
    if dtype == "float32":
        return F32
    return dict(rtol=2e-2, atol=2e-2 * float(np.abs(_np(want)).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "arch, mixer", [("zamba2-7b-smoke", "mamba2"), ("rwkv6-3b-smoke", "rwkv6")]
)
def test_mixer_apply_and_decode_match_jax(arch, mixer, dtype):
    """``*_apply`` on a whole sequence, then ``*_decode`` token by token from
    a zero cache (state written in place), against the JAX functions."""
    B, S = 2, 32
    jc, tc, jp, tp = _mixer_pair(arch, dtype, f"{mixer}_init")
    rng = np.random.default_rng(7)
    jx, tx = _both(rng.standard_normal((B, S, jc.d_model)), dtype)
    chunk = 32 if mixer == "mamba2" else 16
    want = getattr(jssm, f"{mixer}_apply")(jp, jc, jx, chunk=chunk)
    got = getattr(tssm, f"{mixer}_apply")(tp, tc, tx, chunk=chunk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype, **_mixer_tol(dtype, want))

    jcache = getattr(jssm, f"{mixer}_init_cache")(jc, B, JDT[dtype])
    tcache = getattr(tssm, f"{mixer}_init_cache")(tc, B, tx.dtype, "cpu")
    state = {k: v for k, v in tcache.items()}  # the tensors the steps must write
    jstep = jax.jit(lambda p, x, c: getattr(jssm, f"{mixer}_decode")(p, jc, x, c, 0))
    for t in range(S):
        jy, jcache = jstep(jp, jx[:, t : t + 1], jcache)
        ty, tcache = getattr(tssm, f"{mixer}_decode")(tp, tc, tx[:, t : t + 1], tcache, t)
        _close(ty, jy, dtype, **_mixer_tol(dtype, jy))
    for name, leaf in tcache.items():
        assert leaf is state[name]  # updated in place
        _close(leaf, jcache[name], dtype, **_mixer_tol(dtype, jcache[name]))


@pytest.mark.parametrize("n", [1, 3])
def test_pad_front_on_a_dtensor_is_f_pad(tmp_path, n):
    """The mixers' zero padding before the sequence (the causal conv's
    ``d_conv - 1`` rows, RWKV-6's token shift's one) is a concatenation with
    a zero block: its values and gradient equal ``F.pad``'s bit for bit, on a
    plain tensor and on a DTensor (a one-rank ``gloo`` group, the sequence
    sharded or replicated)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_debug_mesh

    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, 8, 6))).to(torch.bfloat16)
    g = torch.from_numpy(np.random.default_rng(n + 1).standard_normal((2, 8 + n, 6)))
    g = g.to(torch.bfloat16)
    want = torch.nn.functional.pad(x, (0, 0, n, 0))
    xg = x.clone().requires_grad_(True)
    got = tssm._pad_front(xg, n)
    assert tref.same_bits(got.detach(), want)
    got.backward(g)
    assert tref.same_bits(xg.grad, g[:, n:])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh((1, 1), device_type="cpu")
        for placements in ([Shard(0), Shard(1)], [Replicate(), Replicate()]):
            got = tssm._pad_front(distribute_tensor(x, mesh, placements), n)
            assert isinstance(got, DTensor)
            assert tref.same_bits(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()
