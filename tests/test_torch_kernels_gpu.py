"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Runs on a machine with a CUDA device (``python -m pytest -q -m gpu
tests/test_torch_kernels_gpu.py``); elsewhere every test skips with its
reason. Imports no JAX: the card machine has none."""
import numpy as np
import pytest
import torch

from repro_torch.core import SCENARIOS, build_program, random_flow_sets
from repro_torch.core.jrba import (
    _finalize,
    _link_slots,
    solve_relaxation_sparse,
    solve_relaxation_sparse_batch,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import jrba_congestion as jc
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6 as rw
from repro_torch.kernels import ssd

pytestmark = pytest.mark.gpu

K = 3
N_ITERS = 200
SCEN = ("edge-mesh", "wan-mesh-xl", "fat-tree", "edge-mesh-flash")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _programs(name, n_sets=3, n_flows=5):
    net, _ = SCENARIOS[name].build(seed=0, n_jobs=4)
    progs = [build_program(net, fs, k=K) for fs in random_flow_sets(net, n_sets, n_flows, seed=11)]
    return [p for p in progs if p is not None]


def _record(prog, m, span):
    res = _finalize(prog, m, span)
    return res.routes, res.bandwidth.tolist(), res.span


@pytest.mark.parametrize("name", SCEN)
def test_kernel_matches_plain_single(name):
    """One lane at a time: the kernel and its plain version sum in the same
    order, so on the card they agree bit for bit (hence identical records)."""
    _need_card()
    for prog in _programs(name):
        out = {}
        for backend in ("cuda", "sparse"):
            m, sp, steps = solve_relaxation_sparse(
                prog, n_iters=N_ITERS, backend=backend, device="cuda"
            )
            assert np.isfinite(m).all() and 0 < steps <= N_ITERS
            out[backend] = (m, sp, steps)
        (m_c, sp_c, st_c), (m_t, sp_t, st_t) = out["cuda"], out["sparse"]
        assert _record(prog, m_c, sp_c) == _record(prog, m_t, sp_t)
        np.testing.assert_array_equal(m_c, m_t)
        assert (sp_c, st_c) == (sp_t, st_t)


def test_kernel_matches_plain_batched():
    """A mixed batch in one launch rounds like the plain batched solve."""
    _need_card()
    progs = _programs("edge-mesh", n_sets=12, n_flows=4)
    keys = [(p.ridx.shape, p.la_pad) for p in progs]
    top = max(keys, key=keys.count)
    progs = [p for p, k in zip(progs, keys) if k == top]
    assert len(progs) >= 2
    before = jc.sparse_congestion_solve.launches
    got = solve_relaxation_sparse_batch(progs, n_iters=N_ITERS, backend="cuda", device="cuda")
    assert jc.sparse_congestion_solve.launches == before + 1
    want = solve_relaxation_sparse_batch(progs, n_iters=N_ITERS, backend="sparse", device="cuda")
    for prog, (m_c, sp_c, st_c), (m_t, sp_t, st_t) in zip(progs, got, want):
        assert _record(prog, m_c, sp_c) == _record(prog, m_t, sp_t)
        np.testing.assert_array_equal(m_c, m_t)
        assert (sp_c, st_c) == (sp_t, st_t)


def test_kernel_early_exit_off_runs_full_budget():
    _need_card()
    prog = _programs("fat-tree")[0]
    _, _, steps = solve_relaxation_sparse(
        prog, n_iters=N_ITERS, early_exit=False, backend="cuda", device="cuda"
    )
    assert steps == N_ITERS


def test_wrapper_rejects_bad_inputs():
    """The wrapper raises on what the kernel does not take; it never falls
    back to the plain version for a CUDA tensor."""
    _need_card()
    prog = _programs("edge-mesh")[0]
    dev = torch.device("cuda")
    args = [
        torch.from_numpy(prog.ridx).to(dev)[None],
        torch.from_numpy(prog.valid).to(dev)[None],
        torch.from_numpy(prog.volumes).to(dev)[None],
        torch.from_numpy(prog.capacity_active()).to(dev)[None],
        torch.tensor([float(len(prog.capacity) - prog.la_pad)], device=dev),
        torch.from_numpy(prog.csr_ptr).to(dev)[None],
        torch.from_numpy(prog.csr_slot).to(dev),
    ]
    w, span, steps = jc.sparse_congestion_solve(*args, n_iters=50)
    torch.cuda.synchronize()
    assert tuple(w.shape) == (1, *prog.valid.shape) and steps.dtype == torch.int32
    bad = list(args)
    bad[2] = bad[2].double()
    with pytest.raises(TypeError):
        jc.sparse_congestion_solve(*bad, n_iters=50)
    bad = list(args)
    bad[3] = bad[3].cpu()
    with pytest.raises(ValueError):
        jc.sparse_congestion_solve(*bad, n_iters=50)


def _synthetic_batch(B, Nf, K, P, La, seed):
    """A batch of random programs of one shape: each path a random run of
    1..P distinct active links (sentinel La after it), some paths invalid,
    random volumes and capacities; slot lists from the engine's builder."""
    rng = np.random.default_rng(seed)
    ridx = np.full((B, Nf, K, P), La, dtype=np.int32)
    valid = rng.random((B, Nf, K)) < 0.8
    valid[:, :, 0] = True
    for b in range(B):
        for i in range(Nf):
            for k in range(K):
                n = min(int(rng.integers(1, P + 1)), La)
                ridx[b, i, k, :n] = rng.choice(La, size=n, replace=False)
    ptrs, slots, off = [], [], 0
    for b in range(B):
        ptr, slot = _link_slots(ridx[b], La)
        ptrs.append(ptr + off)
        slots.append(slot)
        off += len(slot)
    dev = torch.device("cuda")
    return [
        torch.from_numpy(ridx).to(dev),
        torch.from_numpy(valid).to(dev),
        torch.from_numpy(rng.uniform(0.1, 5.0, (B, Nf)).astype(np.float32)).to(dev),
        torch.from_numpy(rng.uniform(0.5, 4.0, (B, La)).astype(np.float32)).to(dev),
        torch.from_numpy(rng.integers(0, 50, B).astype(np.float32)).to(dev),
        torch.from_numpy(np.stack(ptrs)).to(dev),
        torch.from_numpy(np.concatenate(slots)).to(dev),
    ]


# (Nf, La): one-warp lanes, lanes wider than a warp by rows, by links or
# both, and lanes wider than the staged block (513-1024 threads, the general
# instance) by links and by rows
LANE_SHAPES = [(8, 16), (24, 32), (40, 16), (8, 100), (64, 256), (8, 600), (600, 40)]


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("P", [4, 8, 16, 32])
def test_kernel_bits_across_instances(P, early_exit):
    """The one-warp, the block and the general instances, at every hop
    width (P=32 sums two 16-hop trees), against the plain version bit for
    bit."""
    _need_card()
    for j, (nf, la) in enumerate(LANE_SHAPES):
        args = _synthetic_batch(6, nf, K, P, la, seed=100 * P + j)
        kw = dict(n_iters=N_ITERS, early_exit=early_exit)
        plan = jc.launch_plan(6, nf, K, P, la, N_ITERS)
        threads = plan["threads"]
        assert (threads == 32) == (max(nf, la) <= 32)
        assert plan["staged"] == (threads <= jc.STAGED_THREADS)
        w_k, span_k, steps_k = jc.sparse_congestion_solve(*args, **kw)
        w_p, span_p, steps_p = jc.sparse_congestion_plain(*args, **kw)
        torch.cuda.synchronize()
        label = f"Nf={nf} La={la} P={P} threads={threads}"
        assert torch.equal(w_k, w_p), f"{label}: w differs by {float((w_k - w_p).abs().max())}"
        assert torch.equal(span_k, span_p) and torch.equal(steps_k, steps_p), label
        if not early_exit:
            assert bool((steps_k == N_ITERS).all()), label


@pytest.mark.parametrize("k", range(1, jc.MAX_K + 1))
def test_kernel_bits_every_k(k):
    """Every K from 1 to 8 (instances over 3, 4 or 8 paths, padding k >= K)
    on a one-warp and a block lane, against the plain version bit for
    bit."""
    _need_card()
    for j, (nf, la) in enumerate([(8, 16), (40, 64)]):
        args = _synthetic_batch(4, nf, k, 8, la, seed=10 * k + j)
        w_k, span_k, steps_k = jc.sparse_congestion_solve(*args, n_iters=N_ITERS)
        w_p, span_p, steps_p = jc.sparse_congestion_plain(*args, n_iters=N_ITERS)
        torch.cuda.synchronize()
        label = f"K={k} Nf={nf} La={la}"
        assert torch.equal(w_k, w_p), f"{label}: w differs by {float((w_k - w_p).abs().max())}"
        assert torch.equal(span_k, span_p) and torch.equal(steps_k, steps_p), label


@pytest.mark.parametrize("k", [2, 4, 6])
@pytest.mark.parametrize("P", [4, 16, 32])
def test_general_instance_bits_on_staged_shapes(monkeypatch, P, k):
    """The general instance (schedule from device memory, tables in the
    workspace, row state in shared memory), forced onto lanes a staged
    instance would take, gives the plain version's bits."""
    _need_card()
    plan = jc.launch_plan

    def general(B, Nf, K_, P_, La, n_iters):
        out = plan(B, Nf, K_, P_, La, n_iters)
        return dict(out, staged=False, workspace=jc.table_bytes(Nf, K_, P_),
                    smem=jc.kernel_smem_bytes(Nf, K_, La, P_, n_iters, staged=False))

    monkeypatch.setattr(jc, "launch_plan", general)
    for j, (nf, la) in enumerate([(8, 16), (40, 100)]):
        args = _synthetic_batch(4, nf, k, P, la, seed=1000 + 10 * P + j)
        w_k, span_k, steps_k = jc.sparse_congestion_solve(*args, n_iters=N_ITERS)
        w_p, span_p, steps_p = jc.sparse_congestion_plain(*args, n_iters=N_ITERS)
        torch.cuda.synchronize()
        label = f"K={k} P={P} Nf={nf} La={la}"
        assert torch.equal(w_k, w_p), f"{label}: w differs by {float((w_k - w_p).abs().max())}"
        assert torch.equal(span_k, span_p) and torch.equal(steps_k, steps_p), label


def test_step_floor_is_below_the_kernels_step():
    """The step-chain microbenchmark runs, and its floor is no more than the
    kernel's own time per step on a one-warp batch that runs its budget."""
    _need_card()
    args = _synthetic_batch(1, 8, K, 4, 16, seed=7)
    jc.sparse_congestion_solve(*args, n_iters=2000, early_exit=False)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    jc.sparse_congestion_solve(*args, n_iters=2000, early_exit=False)
    end.record()
    end.synchronize()
    floor = jc.step_floor_ms(K, 8, 4, device="cuda")
    assert 0 < floor <= start.elapsed_time(end) / 2000


# flash attention: (B, S, H, KH, D, window); tests/test_kernels.py's shapes,
# ragged lengths, and the gemma3-1b / internlm2-1.8b attention shapes
FLASH_CASES = [
    (1, 128, 4, 4, 64, 0), (2, 256, 8, 2, 64, 0), (1, 256, 4, 1, 128, 0),
    (2, 256, 4, 2, 64, 96), (1, 512, 2, 2, 32, 128), (1, 128, 2, 2, 96, 0),
    (1, 200, 4, 2, 16, 0), (1, 333, 4, 1, 256, 100),
    (1, 1024, 4, 1, 256, 512), (1, 1024, 16, 8, 128, 0),
    (1, 256, 32, 32, 112, 0), (1, 300, 4, 4, 112, 0),  # zamba2-7b's shared attention
    # every head dim again at a ragged S (not a multiple of 64 or 128), B=2,
    # GQA 4:1 and 1:1, windows that are no multiple of a kv tile
    (2, 77, 4, 1, 16, 0), (2, 1000, 4, 4, 32, 200), (2, 1000, 8, 2, 64, 0),
    (2, 77, 4, 4, 96, 33), (2, 1000, 4, 4, 112, 0), (2, 1000, 8, 2, 128, 300),
    (2, 1000, 4, 1, 256, 0), (2, 77, 4, 1, 256, 50),
]
# tests/test_kernels.py's tolerances, each row held to them at its own scale
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# the kernel each dtype launches: bf16 on the tensor cores, f32 on the CUDA cores
FLASH_KERNEL = {torch.bfloat16: fa.flash_attention_wgmma, torch.float32: fa.flash_attention_f32}


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(case, dtype):
    _need_card()
    B, S, H, KH, D, window = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
        for s in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D))
    )
    kernels = (fa.flash_attention_wgmma, fa.flash_attention_f32)
    before = fa.flash_attention_hsd.launches, [kern.launches for kern in kernels]
    got = fa.flash_attention_hsd(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_hsd.launches == before[0] + 1
    for kern, n in zip(kernels, before[1]):
        assert kern.launches == n + (kern is FLASH_KERNEL[dtype])
    chunk = 64 if S % 64 == 0 else S
    want = fa.flash_attention_plain(q, k, v, window=window, chunk=chunk)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert ref.row_limit_ratio(got, want, FLASH_TOL[dtype]) <= 1.0


# the keywords the model never passes: (B, S, H, KH, D, window), causal, scale
FLASH_KEYWORD_CASES = [
    ((1, 128, 4, 4, 64, 0), False, None), ((2, 256, 4, 2, 64, 96), False, None),
    ((1, 333, 4, 1, 256, 100), False, 0.05), ((2, 200, 8, 2, 112, 0), True, 0.3),
    ((1, 256, 2, 2, 32, 0), False, 0.25), ((2, 77, 4, 4, 96, 33), False, 0.2),
    ((1, 1000, 8, 2, 128, 300), False, None), ((2, 1000, 4, 4, 16, 0), False, 1.5),
]


@pytest.mark.parametrize("case", FLASH_KEYWORD_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_keywords_match_plain(case, dtype):
    """``causal=False`` (window 0 and > 0) and a caller's scale, on both
    kernels, against the plain version and the dense oracle."""
    _need_card()
    (B, S, H, KH, D, window), causal, scale = case
    rng = np.random.default_rng(sum(case[0]) + 7)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
        for s in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D))
    )
    before = FLASH_KERNEL[dtype].launches
    kw = dict(causal=causal, window=window, scale=scale)
    got = fa.flash_attention_hsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH_KERNEL[dtype].launches == before + 1
    chunk = 64 if S % 64 == 0 else S
    want = fa.flash_attention_plain(q, k, v, chunk=chunk, **kw)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert ref.row_limit_ratio(got, want, FLASH_TOL[dtype]) <= 1.0
    dense = ref.flash_attention_ref(q, k, v, **kw)
    assert ref.row_limit_ratio(got, dense, FLASH_TOL[dtype]) <= 1.0


@pytest.mark.parametrize("case", [(1, 300, 4, 4, 112, 0), (2, 77, 4, 1, 256, 50),
                                  (1, 1000, 8, 2, 64, 0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_kernel_unaligned_rows(case, causal):
    """f32 q, k and v that start one element past a 16-byte boundary load
    element by element: equal to the aligned result bit for bit, and
    against the plain version. bf16 tensors, read by TMA, still raise."""
    _need_card()
    B, S, H, KH, D, window = case
    rng = np.random.default_rng(sum(case) + 3)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda")
        for s in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D))
    )
    kw = dict(causal=causal, window=window)
    for un in ((_unaligned(q), k, v), (q, _unaligned(k), v), (q, k, _unaligned(v))):
        before = fa.flash_attention_f32.launches
        got = fa.flash_attention_hsd(*un, **kw)
        torch.cuda.synchronize()
        assert fa.flash_attention_f32.launches == before + 1
        assert torch.equal(got, fa.flash_attention_hsd(q, k, v, **kw))
    chunk = 64 if S % 64 == 0 else S
    want = fa.flash_attention_plain(q, k, v, chunk=chunk, **kw)
    assert ref.row_limit_ratio(got, want, FLASH_TOL[torch.float32]) <= 1.0
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_hsd(_unaligned(q.bfloat16()), k.bfloat16(), v.bfloat16(), **kw)


def test_flash_wrapper_rejects_bad_inputs():
    _need_card()
    q = torch.zeros(1, 4, 64, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 64, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention_hsd(q, kv.float(), kv)
    with pytest.raises(ValueError):
        fa.flash_attention_hsd(q, kv.cpu(), kv)
    with pytest.raises(ValueError):
        fa.flash_attention_hsd(q[..., :48].contiguous(), kv[..., :48].contiguous(),
                               kv[..., :48].contiguous())  # no D=48 instance
    with pytest.raises(ValueError):
        fa.flash_attention_hsd(q.transpose(2, 3), kv, kv)
    with pytest.raises(TypeError):
        fa.flash_attention_hsd(q.half(), kv.half(), kv.half())


# MLA's head dims: (D of q and k, Dv of v and o); minicpm3-4b and deepseek-v2
MLA_DIMS = [(96, 64), (192, 128)]
# (B, S, H, window, causal): odd batches and heads (H == KH, as MLA's), S a
# multiple of 64 and of neither 64 nor 128 by way of the window, and the
# S=4096 of chip_smoke's model checks; causal, windowed and not causal
MLA_CASES = [
    (3, 64, 5, 0, True), (3, 64, 5, 0, False), (3, 64, 5, 40, True),
    (1, 384, 3, 0, True), (3, 384, 5, 100, True), (1, 384, 3, 130, False),
    (1, 4096, 3, 0, True), (1, 4096, 3, 512, True), (1, 4096, 3, 0, False),
]


def _mla_qkv(case, D, Dv, dtype, seed):
    B, S, H = case[:3]
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
                 for s in ((B, H, S, D), (B, H, S, D), (B, H, S, Dv)))


@pytest.mark.parametrize("dims", MLA_DIMS)
@pytest.mark.parametrize("case", MLA_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_mla_dims_match_plain(dims, case, dtype):
    """Both kernels at Dv != D, with MLA's scale (D**-0.5 of the whole q·k
    head), against the plain version and the dense oracle: the output is
    (B, H, S, Dv) and every row within the kernel's tolerance."""
    _need_card()
    D, Dv = dims
    B, S, H, window, causal = case
    q, k, v = _mla_qkv(case, D, Dv, dtype, sum(case) + D)
    kw = dict(causal=causal, window=window, scale=D**-0.5)
    before = FLASH_KERNEL[dtype].launches
    got = fa.flash_attention_hsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH_KERNEL[dtype].launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, H, S, Dv)
    assert bool(torch.isfinite(got).all())
    want = fa.flash_attention_plain(q, k, v, chunk=64, **kw)
    assert ref.row_limit_ratio(got, want, FLASH_TOL[dtype]) <= 1.0
    if S <= 384:
        dense = ref.flash_attention_ref(q, k, v, **kw)
        assert ref.row_limit_ratio(got, dense, FLASH_TOL[dtype]) <= 1.0


@pytest.mark.parametrize("dims", MLA_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_kernel_mla_dims_unaligned_rows(dims, causal):
    """At Dv != D, f32 q, k and v one element past a 16-byte boundary load
    element by element and give the aligned result bit for bit."""
    _need_card()
    D, Dv = dims
    case = (3, 300, 3, 50, causal)
    q, k, v = _mla_qkv(case, D, Dv, torch.float32, D + 1)
    kw = dict(causal=causal, window=50)
    aligned = fa.flash_attention_hsd(q, k, v, **kw)
    for un in ((_unaligned(q), k, v), (q, _unaligned(k), v), (q, k, _unaligned(v))):
        assert torch.equal(fa.flash_attention_hsd(*un, **kw), aligned)
    want = fa.flash_attention_plain(q, k, v, chunk=300, **kw)
    assert ref.row_limit_ratio(aligned, want, FLASH_TOL[torch.float32]) <= 1.0


@pytest.mark.parametrize("dims, dtype", [((96, 64), torch.float32), ((192, 128), torch.float32),
                                         ((96, 64), torch.bfloat16)])
def test_flash_narrow_v_equals_padded_v_bits(dims, dtype):
    """An output column is a sum of its own, in an order that does not depend
    on how many columns there are: at (D, Dv) a kernel gives bit for bit the
    first Dv columns of V zero-padded to D, through the (D, D) instance (D =
    96), or through (256, 256) with q and k zero-padded too (D = 192, f32:
    the zero columns add exact zeros at the end of each score's sum, and the
    f32 kernel's kv tiles are 64 keys at every D)."""
    _need_card()
    D, Dv = dims
    q, k, v = _mla_qkv((3, 384, 3), D, Dv, dtype, D + 2)
    Dp = D if (D, D) in fa.HEAD_DIMS else 256
    pad = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[-1])).contiguous()  # noqa: E731
    kw = dict(window=100, scale=D**-0.5)  # the padded run keeps the unpadded head's scale
    narrow = fa.flash_attention_hsd(q, k, v, **kw)
    wide = fa.flash_attention_hsd(pad(q, Dp), pad(k, Dp), pad(v, Dp), **kw)
    assert torch.equal(narrow, wide[..., :Dv])


# digests of the Dv == D instances' outputs (bf16 and f32) on the inputs of
# flash_bits, read on an NVIDIA H100 80GB HBM3 (CUDA 12.8, torch 2.11) from
# the kernels as they were before v took a head dim of its own; the kernels
# with Dv as a template parameter gave the same 28 digests in the same run
DV_EQUAL_BITS = {
    "D=16,bfloat16,causal=True,window=100": "9448054f09eb18f5",
    "D=16,bfloat16,causal=False,window=0": "9eb684002e85c248",
    "D=16,float32,causal=True,window=100": "f9c30f0629b941ff",
    "D=16,float32,causal=False,window=0": "de7278eca6641230",
    "D=32,bfloat16,causal=True,window=100": "42b9cf2558a521e2",
    "D=32,bfloat16,causal=False,window=0": "6fdb08aebfa11027",
    "D=32,float32,causal=True,window=100": "d51354eeb5cadbdd",
    "D=32,float32,causal=False,window=0": "c35b1f94152368cb",
    "D=64,bfloat16,causal=True,window=100": "5518c206b47f0206",
    "D=64,bfloat16,causal=False,window=0": "8faacc2e1c4119ab",
    "D=64,float32,causal=True,window=100": "ededb0539024bc81",
    "D=64,float32,causal=False,window=0": "31651e74efa325bf",
    "D=96,bfloat16,causal=True,window=100": "18589146be8438e4",
    "D=96,bfloat16,causal=False,window=0": "42f54e6ebac36a10",
    "D=96,float32,causal=True,window=100": "0eef7b5de8147111",
    "D=96,float32,causal=False,window=0": "9631e154cfdb83dd",
    "D=112,bfloat16,causal=True,window=100": "95be189af376943b",
    "D=112,bfloat16,causal=False,window=0": "67b29009c9d83e0f",
    "D=112,float32,causal=True,window=100": "b36f3656582ae81c",
    "D=112,float32,causal=False,window=0": "ae8b3e35f5bc7eb3",
    "D=128,bfloat16,causal=True,window=100": "aa812c67e0b35096",
    "D=128,bfloat16,causal=False,window=0": "542a5e29a3edac51",
    "D=128,float32,causal=True,window=100": "11e53f5c3340beee",
    "D=128,float32,causal=False,window=0": "9e7dae3b0acf4e04",
    "D=256,bfloat16,causal=True,window=100": "47c674b794c75419",
    "D=256,bfloat16,causal=False,window=0": "8d1e98501a0e1093",
    "D=256,float32,causal=True,window=100": "39a43a3627724937",
    "D=256,float32,causal=False,window=0": "8e03ad6a7dd298ac",
}


def flash_bits(module) -> dict[str, str]:
    """sha256 of each Dv == D instance's output, both dtypes, on seeded
    numpy inputs (causal with a window, and not causal), through
    ``module.flash_attention_hsd``."""
    import hashlib

    out = {}
    for D in (16, 32, 64, 96, 112, 128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(D)
            q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
                       for s in ((2, 4, 333, D), (2, 2, 333, D), (2, 2, 333, D)))
            for causal, window in ((True, 100), (False, 0)):
                o = module.flash_attention_hsd(q, k, v, causal=causal, window=window)
                raw = o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                key = f"D={D},{str(dtype)[6:]},causal={causal},window={window}"
                out[key] = hashlib.sha256(raw).hexdigest()[:16]
    return out


def test_flash_dv_equal_d_instances_keep_their_bits():
    """Every instance with Dv == D gives the bits it gave before V took a
    head dim of its own (DV_EQUAL_BITS)."""
    _need_card()
    assert flash_bits(fa) == DV_EQUAL_BITS


def test_flash_wrapper_rejects_other_dim_pairs():
    """A (D, Dv) pair no instance is built for raises on the card; it does
    not fall back to the plain version."""
    _need_card()
    for D, Dv in ((192, 192), (96, 48), (128, 64), (64, 128)):
        q = torch.zeros(1, 2, 64, D, device="cuda", dtype=torch.bfloat16)
        v = torch.zeros(1, 2, 64, Dv, device="cuda", dtype=torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="head dims"):
                fa.flash_attention_hsd(q.to(dtype), q.to(dtype), v.to(dtype))


# the SSM scans: tests/test_kernels.py's SSD_CASES (B, S, H, P, N, chunk) and
# RWKV_CASES (B, S, H, P, chunk), copied (that file imports JAX), then the
# model heads at a short length: zamba2-7b (H=112, P=64, N=64, chunk 64),
# rwkv6-3b (H=40, P=64, chunk 16)
SSD_CASES = [(2, 128, 2, 16, 8, 32), (1, 256, 4, 64, 64, 64), (2, 64, 1, 32, 16, 64),
             (1, 512, 2, 64, 32, 128), (1, 512, 112, 64, 64, 64), (1, 64, 3, 16, 16, 16)]
RWKV_CASES = [(2, 128, 2, 16, 16), (1, 256, 4, 64, 16), (2, 64, 1, 32, 8),
              (1, 512, 2, 64, 16), (1, 256, 40, 64, 16)]
# tests/test_kernels.py's tolerances (rtol, atol), the atol a share of each
# output row's root mean square
SCAN_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-4, 5e-4)}


def _cuda(rng, shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
        "cuda", dtype
    )


def _ssd_args(case, dtype, seed=0):
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = _cuda(rng, (B, S, H, P), dtype)
    dt = torch.nn.functional.softplus(_cuda(rng, (B, S, H)) - 1.0)
    A = -torch.exp(torch.from_numpy(rng.uniform(0.0, 2.0, H).astype(np.float32)).cuda())
    return x, dt, A, _cuda(rng, (B, S, N), dtype), _cuda(rng, (B, S, N), dtype)


def _rwkv_args(case, dtype, seed=0):
    B, S, H, P, _ = case
    rng = np.random.default_rng(seed)
    r, k = (_cuda(rng, (B, S, H, P), dtype, 0.5) for _ in range(2))
    v = _cuda(rng, (B, S, H, P), dtype)
    logw = -torch.exp(torch.from_numpy(rng.uniform(-8.0, 1.0, (B, S, H, P)).astype(np.float32))
                      ).cuda()
    return r, k, v, logw, _cuda(rng, (H, P), scale=0.3)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_kernel_matches_plain(case, dtype):
    """Through the model-layout wrapper (strided views, no copies), one launch
    each; against the chunked plain version and the sequential oracle."""
    _need_card()
    chunk = case[-1]
    args = _ssd_args(case, dtype)
    before = ssd.ssd_scan_hsd.launches
    got = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_hsd.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous() and bool(torch.isfinite(got).all())
    want, _ = ssd.ssd_chunked(*args, chunk=chunk)
    assert ref.row_limit_ratio(got, want, *SCAN_TOL[dtype]) <= 1.0
    if case[1] <= 256:
        seq, _ = ref.ssd_sequential(*args)
        assert ref.row_limit_ratio(got, seq, *SCAN_TOL[dtype]) <= 1.0


@pytest.mark.parametrize("case", RWKV_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv6_kernel_matches_plain(case, dtype):
    _need_card()
    chunk = case[-1]
    args = _rwkv_args(case, dtype)
    before = rw.rwkv6_scan_hsd.launches
    got = ops.rwkv6_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert rw.rwkv6_scan_hsd.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous() and bool(torch.isfinite(got).all())
    want, _ = rw.rwkv6_chunked(*args, chunk=chunk)
    assert ref.row_limit_ratio(got, want, *SCAN_TOL[dtype]) <= 1.0
    if case[1] <= 256:
        seq, _ = ref.rwkv6_sequential(*args)
        assert ref.row_limit_ratio(got, seq, *SCAN_TOL[dtype]) <= 1.0


# the bf16 SSD kernel at every chunk it takes, N and P at both ends of what
# it takes, with a decay strong enough that exp(cum_i - cum_j) above the
# diagonal overflows to inf: (B, S, H, P, N, chunk)
SSD_MMA_CASES = [(2, 256, 3, p, n, q) for q in ssd.CHUNKS for n in (16, 64) for p in (16, 64)]


@pytest.mark.parametrize("case", SSD_MMA_CASES)
def test_ssd_mma_kernel_strong_decay(case):
    _need_card()
    B, S, H, P, N, chunk = case
    rng = np.random.default_rng(sum(case))
    x = _cuda(rng, (B, S, H, P), torch.bfloat16)
    dt = torch.nn.functional.softplus(_cuda(rng, (B, S, H)) + 2.0)
    A = -torch.exp(torch.from_numpy(rng.uniform(2.0, 4.0, H).astype(np.float32)).cuda())
    Bm, Cm = (_cuda(rng, (B, S, N), torch.bfloat16) for _ in range(2))
    assert float((dt[0, :chunk, 0] * A[0]).sum()) < -89  # exp(-cum) overflows in a chunk
    before = ssd.ssd_scan_mma.launches
    got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_mma.launches == before + 1
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    want, _ = ssd.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    assert ref.row_limit_ratio(got, want, *SCAN_TOL[torch.bfloat16]) <= 1.0


def _unaligned(t):
    """A copy of ``t`` whose data starts one element past a 16-byte
    boundary, so no row of it is 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("N", [12, 40])
def test_ssd_mma_kernel_unaligned_rows(N):
    """The bf16 kernel's element-by-element loads, taken where N is not a
    multiple of 8 or a row of B or C is not 16-byte aligned: against the
    plain version, and, where N allows 16-byte loads, equal to the aligned
    result bit for bit."""
    _need_card()
    case = (2, 256, 3, 32, N, 64)
    x, dt, A, Bm, Cm = _ssd_args(case, torch.bfloat16, seed=N)
    Bu, Cu = _unaligned(Bm), _unaligned(Cm)
    assert Bu.data_ptr() % 16 and Cu.data_ptr() % 16
    got = ops.ssd_scan(x, dt, A, Bu, Cu, chunk=64)
    want, _ = ssd.ssd_chunked(x, dt, A, Bm, Cm, chunk=64)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert ref.row_limit_ratio(got, want, *SCAN_TOL[torch.bfloat16]) <= 1.0
    aligned = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    if N % 8 == 0:  # the aligned inputs took the 16-byte cp.async loads
        assert torch.equal(got, aligned)
    else:
        assert ref.row_limit_ratio(aligned, want, *SCAN_TOL[torch.bfloat16]) <= 1.0


# chunks the model passes for prompts under 64 tokens, which have no tile
# instance of their own: (B, S, H, P, N, chunk)
SSD_ODD_CASES = [(2, 96, 3, 64, 16, 48), (1, 37, 2, 64, 64, 37), (2, 64, 2, 32, 16, 8),
                 (1, 120, 2, 16, 8, 24)]


@pytest.mark.parametrize("case", SSD_ODD_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_kernels_take_odd_chunks(case, dtype):
    """Both SSD kernels run a chunk of 48, 37, 24 or 8 rows in the smallest
    tile instance that holds it, its padding rows zero: against the chunked
    plain version and the sequential oracle, one launch of the dtype's
    kernel."""
    _need_card()
    chunk = case[-1]
    args = _ssd_args(case, dtype, seed=chunk)
    kernel = ssd.ssd_scan_mma if dtype == torch.bfloat16 else ssd.ssd_scan_f32
    before = kernel.launches
    got = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    want, _ = ssd.ssd_chunked(*args, chunk=chunk)
    assert ref.row_limit_ratio(got, want, *SCAN_TOL[dtype]) <= 1.0
    seq, _ = ref.ssd_sequential(*args)
    assert ref.row_limit_ratio(got, seq, *SCAN_TOL[dtype]) <= 1.0


# (case, segments): one segment, segments of two chunks, and a shape whose own
# plan cuts the sequence (rwkv6-3b's heads keep one segment at S=4096)
F32_SEGMENT_CASES = [((1, 256, 2, 64, 16), 1), ((2, 128, 3, 48, 16), 2), ((1, 160, 2, 64, 5), 2),
                     ((1, 1024, 2, 64, 16), None)]


@pytest.mark.parametrize("case, segments", F32_SEGMENT_CASES)
def test_f32_scan_kernels_across_segments(monkeypatch, case, segments):
    """The f32 RWKV-6 kernel with the sequence in one segment, in segments of
    two chunks (end states, passing, y), and at a shape whose own plan makes
    several: against the chunked plain version and the sequential oracle at
    f32 tolerance."""
    _need_card()
    chunk = case[-1]
    nchunks = case[1] // chunk
    if segments is not None:
        seg_len = nchunks if segments == 1 else 2
        monkeypatch.setattr(rw, "segment_chunks", lambda *a: seg_len)
    else:
        B, S, H, P = case[:4]
        assert rw.segment_chunks(B, H, S, P, chunk) < nchunks  # the plan cuts it
    args = _rwkv_args(case, torch.float32, seed=len(case))
    got = ops.rwkv6_scan(*args, chunk=chunk)
    want, _ = rw.rwkv6_chunked(*args, chunk=chunk)
    seq, _ = ref.rwkv6_sequential(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert ref.row_limit_ratio(got, want, *SCAN_TOL[torch.float32]) <= 1.0
    assert ref.row_limit_ratio(got, seq, *SCAN_TOL[torch.float32]) <= 1.0


@pytest.mark.parametrize("case", [(1, 512, 2, 64, 64, 64), (2, 384, 3, 32, 16, 48),
                                  (1, 2048, 2, 64, 64, 64), (1, 4096, 4, 128, 64, 128)])
def test_ssd_f32_kernel_long_sequences(case):
    """The f32 SSD kernel walking many chunks in one block (8 to 64), at one
    and two cp.async stages (chunk 128 takes one): one launch, against the
    chunked plain version and the sequential oracle at f32 tolerance."""
    _need_card()
    chunk = case[-1]
    args = _ssd_args(case, torch.float32, seed=len(case))
    before = ssd.ssd_scan_f32.launches
    got = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_f32.launches == before + 1
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    want, _ = ssd.ssd_chunked(*args, chunk=chunk)
    assert ref.row_limit_ratio(got, want, *SCAN_TOL[torch.float32]) <= 1.0
    seq, _ = ref.ssd_sequential(*args)
    assert ref.row_limit_ratio(got, seq, *SCAN_TOL[torch.float32]) <= 1.0


def test_ssd_routes_by_dtype():
    """bf16 launches the tensor-core kernel, f32 the CUDA-core one; the
    routing wrapper counts both."""
    _need_card()
    case = (1, 128, 2, 32, 16, 32)
    for dtype, kernel in ((torch.bfloat16, ssd.ssd_scan_mma), (torch.float32, ssd.ssd_scan_f32)):
        other = ssd.ssd_scan_f32 if kernel is ssd.ssd_scan_mma else ssd.ssd_scan_mma
        before = ssd.ssd_scan_hsd.launches, kernel.launches, other.launches
        ops.ssd_scan(*_ssd_args(case, dtype), chunk=32)
        torch.cuda.synchronize()
        assert (ssd.ssd_scan_hsd.launches, kernel.launches, other.launches) == (
            before[0] + 1, before[1] + 1, before[2])


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_mma_kernel_matches_plain(monkeypatch, case, segments):
    """The bf16 tensor-core kernel, one launch a call, against the chunked
    plain version and (short cases) the sequential oracle; with
    ``segments`` the sequence is cut into segments of two chunks, so the
    three grids (end states, passing, y) run on every case."""
    _need_card()
    chunk = case[-1]
    if segments:
        monkeypatch.setattr(rw, "segment_chunks", lambda *a: 2)
    args = _rwkv_args(case, torch.bfloat16)
    before = rw.rwkv6_scan_mma.launches, rw.rwkv6_scan_f32.launches
    got = ops.rwkv6_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (rw.rwkv6_scan_mma.launches, rw.rwkv6_scan_f32.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    want, _ = rw.rwkv6_chunked(*args, chunk=chunk)
    assert ref.row_limit_ratio(got, want, *SCAN_TOL[torch.bfloat16]) <= 1.0
    if case[1] <= 256:
        seq, _ = ref.rwkv6_sequential(*args)
        assert ref.row_limit_ratio(got, seq, *SCAN_TOL[torch.bfloat16]) <= 1.0


@pytest.mark.parametrize("P", [16, 48, 64])
def test_rwkv6_mma_kernel_cliff_decay(P):
    """The cliff profile (half the channels at the clamp |logw| = e, half
    nearly without decay) at Q=16, where kn reaches e^43.5: the bf16 kernel
    against the plain version, and chunks of 5 (zero-padded rows) too."""
    _need_card()
    rng = np.random.default_rng(P)
    B, S, H = 2, 160, 3
    r, k, v = (_cuda(rng, (B, S, H, P), torch.bfloat16) for _ in range(3))
    u = _cuda(rng, (H, P))
    cliff = torch.where(torch.arange(P, device="cuda") < P // 2, -float(np.e), -1e-3)
    logw = cliff.expand(B, S, H, P).contiguous()
    for chunk in (16, 5):
        got = ops.rwkv6_scan(r, k, v, logw, u, chunk=chunk)
        want, _ = rw.rwkv6_chunked(r, k, v, logw, u, chunk=chunk)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert ref.row_limit_ratio(got, want, *SCAN_TOL[torch.bfloat16]) <= 1.0


def test_rwkv6_mma_kernel_unaligned_rows():
    """Rows that are not 16-byte aligned load element by element: against
    the plain version, and equal to the aligned result bit for bit."""
    _need_card()
    args = _rwkv_args((1, 256, 4, 64, 16), torch.bfloat16, seed=3)
    r_un = _unaligned(args[0])
    assert r_un.data_ptr() % 16
    got = ops.rwkv6_scan(r_un, *args[1:], chunk=16)
    aligned = ops.rwkv6_scan(*args, chunk=16)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)


def test_rwkv6_routes_by_dtype():
    """bf16 launches the tensor-core kernel, f32 the CUDA-core one, once a
    call each; the routing wrapper counts both."""
    _need_card()
    case = (1, 128, 2, 32, 16)
    for dtype, kernel in ((torch.bfloat16, rw.rwkv6_scan_mma), (torch.float32, rw.rwkv6_scan_f32)):
        other = rw.rwkv6_scan_f32 if kernel is rw.rwkv6_scan_mma else rw.rwkv6_scan_mma
        before = rw.rwkv6_scan_hsd.launches, kernel.launches, other.launches
        ops.rwkv6_scan(*_rwkv_args(case, dtype), chunk=16)
        torch.cuda.synchronize()
        assert (rw.rwkv6_scan_hsd.launches, kernel.launches, other.launches) == (
            before[0] + 1, before[1] + 1, before[2])


def test_rwkv6_mma_wrapper_rejects_bad_inputs():
    """What the bf16 kernel does not take raises; nothing falls back to the
    plain version or to the f32 kernel."""
    _need_card()
    r, k, v, logw, u = _rwkv_args((1, 64, 2, 64, 16), torch.bfloat16)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    before = rw.rwkv6_scan_hsd.launches, rw.rwkv6_scan_mma.launches, rw.rwkv6_scan_f32.launches
    for bad, err in [
        ((t(r), t(k).float(), t(v), t(logw), u), TypeError),  # k not bf16
        ((t(r), t(k), t(v), t(logw), u.bfloat16()), TypeError),  # u must be f32
        ((t(r), t(k), t(v).cpu(), t(logw), u), ValueError),  # device
        ((t(r)[..., :8], t(k)[..., :8], t(v)[..., :8], t(logw)[..., :8], u[:, :8]), ValueError),
        ((t(r)[..., :40], t(k)[..., :40], t(v)[..., :40], t(logw)[..., :40], u[:, :40]),
         ValueError),  # P not a multiple of 16
        ((t(r).transpose(2, 3), t(k), t(v), t(logw), u), ValueError),  # shape
        ((t(r).half(), t(k).half(), t(v).half(), t(logw), u), TypeError),
    ]:
        with pytest.raises(err):
            rw.rwkv6_scan_hsd(*bad)
    with pytest.raises(ValueError, match="chunk"):
        rw.rwkv6_scan_hsd(t(r), t(k), t(v), t(logw), u, chunk=32)
    with pytest.raises(ValueError, match="chunk"):  # 12 does not divide S=64
        rw.rwkv6_scan_hsd(t(r), t(k), t(v), t(logw), u, chunk=12)
    assert (rw.rwkv6_scan_hsd.launches, rw.rwkv6_scan_mma.launches,
            rw.rwkv6_scan_f32.launches) == before


def test_rwkv6_kernel_cliff_decay():
    """Half the channels at the clamp (|logw| = e), half nearly without decay,
    at Q=16: the factorization's largest k-side factor, e^43.5."""
    _need_card()
    rng = np.random.default_rng(4)
    B, S, H, P = 1, 64, 2, 64
    r, k, v = (_cuda(rng, (B, S, H, P)) for _ in range(3))
    u = _cuda(rng, (H, P))
    cliff = torch.where(torch.arange(P, device="cuda") < P // 2, -float(np.e), -1e-3)
    logw = cliff.expand(B, S, H, P).contiguous()
    got = ops.rwkv6_scan(r, k, v, logw, u, chunk=16)
    want, _ = ref.rwkv6_sequential(r, k, v, logw, u)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_scan_wrappers_reject_bad_inputs():
    """Wrong dtype, shape, device or chunk: the wrappers raise and never fall
    back to the plain version for a CUDA tensor."""
    _need_card()
    x, dt, A, Bm, Cm = _ssd_args((1, 128, 2, 32, 16, 32), torch.bfloat16)
    hsd = (x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm)
    ssd.ssd_scan_hsd(*hsd, chunk=32)
    for bad, err in [
        ((hsd[0].float(), *hsd[1:]), TypeError),  # x and B/C types differ
        ((hsd[0], hsd[1].bfloat16(), *hsd[2:]), TypeError),  # dt must be f32
        ((hsd[0], hsd[1], hsd[2], Bm.cpu(), Cm), ValueError),  # device
        ((hsd[0], hsd[1], hsd[2][:1], Bm, Cm), ValueError),  # shape of A
        ((hsd[0][..., :24], *hsd[1:]), ValueError),  # P not a multiple of 16
        ((hsd[0].half(), hsd[1], hsd[2], Bm.half(), Cm.half()), TypeError),
    ]:
        with pytest.raises(err):
            ssd.ssd_scan_hsd(*bad, chunk=32)
    for chunk in (48, 40):  # neither divides S=128, which the JAX twin refuses too
        with pytest.raises(ValueError, match="chunk"):
            ssd.ssd_scan_hsd(*hsd, chunk=chunk)
    long = _ssd_args((1, 512, 2, 32, 16, 256), torch.bfloat16)
    with pytest.raises(ValueError, match="chunk"):  # above the largest tile instance
        ssd.ssd_scan_hsd(long[0].transpose(1, 2), long[1].transpose(1, 2), *long[2:], chunk=256)
    with pytest.raises(ValueError):  # a non-dense last axis
        ssd.ssd_scan_hsd(hsd[0].transpose(2, 3).contiguous().transpose(2, 3), *hsd[1:], chunk=32)

    r, k, v, logw, u = _rwkv_args((1, 64, 2, 64, 16), torch.float32)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    rw.rwkv6_scan_hsd(t(r), t(k), t(v), t(logw), u)
    for bad, err in [
        ((t(r).bfloat16(), t(k), t(v), t(logw), u), TypeError),
        ((t(r), t(k), t(v), t(logw).bfloat16(), u), TypeError),
        ((t(r), t(k).cpu(), t(v), t(logw), u), ValueError),
        ((t(r), t(k), t(v), t(logw), u[:1]), ValueError),
        ((t(r)[..., :8], t(k)[..., :8], t(v)[..., :8], t(logw)[..., :8], u[:, :8]), ValueError),
    ]:
        with pytest.raises(err):
            rw.rwkv6_scan_hsd(*bad)
    for chunk in (32, 64):
        with pytest.raises(ValueError, match="chunk"):
            rw.rwkv6_scan_hsd(t(r), t(k), t(v), t(logw), u, chunk=chunk)
    with pytest.raises(ValueError, match="chunk"):  # 12 does not divide S=64
        rw.rwkv6_scan_hsd(t(r), t(k), t(v), t(logw), u, chunk=12)


# ---------------------------------------------------------------------------
# gradients: each kernel's Function is the kernel forward with the plain
# version's gradient (kernels/grad.py), bit for bit at the same inputs
# ---------------------------------------------------------------------------
def _function_matches_plain(function, hsd, plain, kernel, args, kw, seed):
    """The Function's output equals the kernel's (one launch, none in the
    backward) and every input's gradient equals autograd's through the plain
    version, bit for bit, for a seeded output gradient."""
    with torch.no_grad():
        kernel_out = hsd(*args, **kw)
    ins = [a.detach().clone().requires_grad_() for a in args]
    before = kernel.launches
    out = function.apply(*ins, kw)
    assert kernel.launches == before + 1
    assert ref.same_bits(out.detach(), kernel_out)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, ins, cot)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1  # the backward launches nothing
    ref_in = [a.detach().clone().requires_grad_() for a in args]
    want = torch.autograd.grad(plain(*ref_in, **kw), ref_in, cot)
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype and ref.same_bits(g, w)


@pytest.mark.parametrize("case", FLASH_CASES[:6])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_function_gradient_is_the_plain_versions(case, dtype):
    """tests/test_kernels.py's shapes, causal with the case's window."""
    _need_card()
    B, S, H, KH, D, window = case
    rng = np.random.default_rng(S + H + D)
    q = _cuda(rng, (B, H, S, D), dtype)
    k, v = _cuda(rng, (B, KH, S, D), dtype), _cuda(rng, (B, KH, S, D), dtype)
    kw = dict(causal=True, window=window, scale=None, chunk=64)
    _function_matches_plain(fa.FlashAttention, fa.flash_attention_hsd, fa.flash_attention_plain,
                            FLASH_KERNEL[dtype], (q, k, v), kw, seed=S)


@pytest.mark.parametrize("case", SSD_CASES[:4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_function_gradient_is_the_plain_versions(case, dtype):
    _need_card()
    x, dt, A, Bm, Cm = _ssd_args(case, dtype)
    args = (x.transpose(1, 2), dt.transpose(1, 2), A, Bm, Cm)
    kernel = ssd.ssd_scan_mma if dtype == torch.bfloat16 else ssd.ssd_scan_f32
    _function_matches_plain(ssd.SSDScan, ssd.ssd_scan_hsd, ssd.ssd_scan_plain, kernel, args,
                            dict(chunk=case[-1]), seed=case[1])


@pytest.mark.parametrize("case", RWKV_CASES[:4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv6_function_gradient_is_the_plain_versions(case, dtype):
    _need_card()
    r, k, v, logw, u = _rwkv_args(case, dtype)
    args = (*(a.transpose(1, 2) for a in (r, k, v, logw)), u)
    kernel = rw.rwkv6_scan_mma if dtype == torch.bfloat16 else rw.rwkv6_scan_f32
    _function_matches_plain(rw.RWKV6Scan, rw.rwkv6_scan_hsd, rw.rwkv6_scan_plain, kernel, args,
                            dict(chunk=case[-1]), seed=case[1])


def test_ops_take_the_function_only_when_a_gradient_is_wanted():
    """On the card the model-layout wrapper launches the kernel through
    ``FlashAttention`` either way, and builds a graph only when an input
    requires a gradient and grad mode is on."""
    _need_card()
    rng = np.random.default_rng(4)
    q, k, v = (_cuda(rng, (1, 128, 2, 64), torch.bfloat16) for _ in range(3))
    before = fa.flash_attention_wgmma.launches
    assert ops.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    out = ops.flash_attention(q, k, v)
    assert "FlashAttention" in type(out.grad_fn.next_functions[0][0]).__name__ or \
        "FlashAttention" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention_wgmma.launches == before + 3


def test_unembed_backward_matches_the_f32_products():
    """``unembed_apply`` on bf16 operands on the card (``MixedUnembed``): the
    f32 logits of the upcast product, and gradients within bf16 rounding of
    autograd through the f32 product (1e-2 of each gradient's largest
    entry): the logit gradient rounded to bf16, then bf16 products."""
    from repro_torch.models.layers import unembed_apply

    _need_card()
    rng = np.random.default_rng(9)
    x = _cuda(rng, (2, 64, 256), torch.bfloat16).requires_grad_()
    table = _cuda(rng, (1000, 256), torch.bfloat16, 0.1).requires_grad_()
    logits = unembed_apply(table, x)
    assert logits.dtype == torch.float32
    want = x.float() @ table.float().t()
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-4)
    cot = _cuda(rng, tuple(logits.shape))
    gx, gt = torch.autograd.grad(logits, (x, table), cot)
    xf, tf = x.detach().float().requires_grad_(), table.detach().float().requires_grad_()
    wx, wt = torch.autograd.grad(xf @ tf.t(), (xf, tf), cot)
    assert gx.dtype == gt.dtype == torch.bfloat16
    for g, w in ((gx, wx), (gt, wt)):
        assert float((g.float() - w).abs().max()) <= 1e-2 * float(w.abs().max())
