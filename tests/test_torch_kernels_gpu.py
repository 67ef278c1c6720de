"""The port's CUDA kernel against its plain PyTorch version, on the card.

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
from repro_torch.kernels import jrba_congestion as jc

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
