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
    solve_relaxation_sparse,
    solve_relaxation_sparse_batch,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import jrba_congestion as jc
from repro_torch.kernels import ref

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


# flash attention: (B, S, H, KH, D, window); tests/test_kernels.py's shapes,
# ragged lengths, and the gemma3-1b / internlm2-1.8b attention shapes
FLASH_CASES = [
    (1, 128, 4, 4, 64, 0), (2, 256, 8, 2, 64, 0), (1, 256, 4, 1, 128, 0),
    (2, 256, 4, 2, 64, 96), (1, 512, 2, 2, 32, 128), (1, 128, 2, 2, 96, 0),
    (1, 200, 4, 2, 16, 0), (1, 333, 4, 1, 256, 100),
    (1, 1024, 4, 1, 256, 512), (1, 1024, 16, 8, 128, 0),
]
# tests/test_kernels.py's tolerances, each row held to them at its own scale
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}


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
    before = fa.flash_attention_hsd.launches
    got = fa.flash_attention_hsd(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_hsd.launches == before + 1
    chunk = 64 if S % 64 == 0 else S
    want = fa.flash_attention_plain(q, k, v, window=window, chunk=chunk)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert ref.attention_limit_ratio(got, want, FLASH_TOL[dtype]) <= 1.0


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
