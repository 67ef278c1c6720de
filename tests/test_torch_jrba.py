"""The port's JRBA (``repro_torch.core.jrba``) against the JAX package's, on the
CPU: program tensors, the anneal schedule, the dense oracle, the sparse twin
and the engine. Held quantities are records (routes, bandwidths, spans from
``_finalize``) and certificates to a stated tolerance, never raw ``w`` or
step counts: the relaxed ``w`` drifts between float orderings even inside
the reference, and rounding absorbs the drift."""
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_sanitize import port_sanitizer  # noqa: F401

import repro.core as ref
import repro_torch.core as port
from repro.core.jrba import _finalize as ref_finalize
from repro.core.jrba import probe_schedule as ref_probe_schedule
from repro_torch.core.jrba import _finalize as port_finalize
from repro_torch.core.jrba import _schedule, probe_schedule, resolve_solver

K = 3
N_ITERS = 150
CPU = "cpu"
# The relaxed span is a certificate, not a record. A lane that converged
# (exited before the budget) is held to 5e-2, the reference's own jnp-vs-Pallas
# tolerance. A lane that ran the whole budget stopped at an unconverged
# iterate, where float order moves the certificate further: at 150 steps the
# worst measured gap is 10.7% (one wan-mesh-xl program, full budget in port,
# jnp and Pallas alike); such lanes are held to the reference's dense-vs-sparse
# tolerance, 0.15 (tests/test_solver_sparse.py). The dense oracle (fixed
# schedule) is held to 5e-2.
CERT_RTOL_CONVERGED = 5e-2
CERT_RTOL_FULL_BUDGET = 0.15
TENSORS = (
    "usage", "valid", "volumes", "capacity", "link_idx", "active_links", "usage_active", "ridx",
)


def _corpus(names=("edge-mesh", "wan-mesh", "wan-mesh-xl", "fat-tree"), n_sets=3, n_flows=5):
    """The pinned scenario corpus of the reference's sparse-solver tests,
    built in both packages from the same seeds."""
    out = []
    for name in names:
        rnet, _ = ref.SCENARIOS[name].build(seed=0, n_jobs=4)
        pnet, _ = port.SCENARIOS[name].build(seed=0, n_jobs=4)
        rsets = ref.random_flow_sets(rnet, n_sets, n_flows, seed=11)
        psets = port.random_flow_sets(pnet, n_sets, n_flows, seed=11)
        for rfs, pfs in zip(rsets, psets):
            rp = ref.build_program(rnet, rfs, k=K)
            pp = port.build_program(pnet, pfs, k=K)
            if rp is not None:
                out.append((name, rp, pp))
    return out


def _record(fin, prog, m, span):
    res = fin(prog, m, span)
    return res.routes, res.bandwidth.tolist(), res.span


def test_build_program_tensors_equal():
    corpus = _corpus()
    assert len(corpus) == 12
    for name, rp, pp in corpus:
        for attr in TENSORS:
            a, b = getattr(rp, attr), getattr(pp, attr)
            assert a.dtype == b.dtype and a.shape == b.shape, (name, attr)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{attr}")
        assert rp.paths == pp.paths and rp.n_real == pp.n_real and rp.la_pad == pp.la_pad
        np.testing.assert_array_equal(rp.capacity_active(), pp.capacity_active())


@pytest.mark.parametrize("n_iters", (1, 25, 150, 250, 400))
def test_tau_schedule_within_rtol_of_jnp_geomspace(n_iters):
    """Bit equality with jnp.geomspace is not reachable from PyTorch (XLA's
    f32 linspace+pow differs from a rounded float64 geomspace by up to ~13
    ulp); the schedule is held to 2e-6 relative."""
    want = np.asarray(jnp.geomspace(1.0, 1e-3, n_iters), dtype=np.float32)
    got = _schedule(n_iters)[:, 0]
    assert got.dtype == np.float32 and got.shape == (n_iters,)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    # Adam's bias corrections 1 - beta^t, as the reference computes them in
    # f32: beta^t is near 1, so one ulp of it (6e-8) is the resolution of the
    # difference; hold them to two such ulps
    t = jnp.arange(n_iters, dtype=jnp.int32)
    for col, beta in ((1, 0.9), (2, 0.999)):
        want = np.asarray(1 - beta ** (t + 1), dtype=np.float32)
        np.testing.assert_allclose(_schedule(n_iters)[:, col], want, rtol=0, atol=1.2e-7)


def test_probe_schedule_matches():
    for n in (1, 10, 24, 25, 50, 99, 150, 200, 250, 300, 400, 1000):
        assert probe_schedule(n) == ref_probe_schedule(n)


@pytest.mark.parametrize("name", ("edge-mesh", "wan-mesh", "fat-tree"))
def test_dense_matches_reference_dense(name):
    for _, rp, pp in _corpus((name,), n_sets=2):
        m_r, sp_r = ref.solve_relaxation(rp, n_iters=N_ITERS)
        m_p, sp_p = port.solve_relaxation(pp, n_iters=N_ITERS, device=CPU)
        assert _record(port_finalize, pp, m_p, sp_p) == _record(ref_finalize, rp, m_r, sp_r)
        assert sp_p == pytest.approx(sp_r, rel=5e-2)


@pytest.mark.parametrize("name", ("edge-mesh", "wan-mesh", "wan-mesh-xl", "fat-tree"))
def test_sparse_matches_reference_sparse_and_pallas_interpret(name):
    """The sparse twin against the JAX sparse path and against the Pallas
    kernel's driver in interpret mode."""
    for _, rp, pp in _corpus((name,)):
        m_r, sp_r, _ = ref.solve_relaxation_sparse(rp, n_iters=N_ITERS)
        m_k, sp_k, _ = ref.solve_relaxation_sparse(
            rp, n_iters=N_ITERS, backend="pallas", interpret=True
        )
        m_p, sp_p, steps = port.solve_relaxation_sparse(pp, n_iters=N_ITERS, device=CPU)
        rec = _record(port_finalize, pp, m_p, sp_p)
        assert rec == _record(ref_finalize, rp, m_r, sp_r)
        assert rec == _record(ref_finalize, rp, m_k, sp_k)
        rtol = CERT_RTOL_CONVERGED if steps < N_ITERS else CERT_RTOL_FULL_BUDGET
        assert sp_p == pytest.approx(sp_r, rel=rtol)
        assert 0 < steps <= N_ITERS


def _one_bucket(corpus):
    """The largest group of corpus entries sharing one sparse batch shape
    (Nf, K, Pmax, La_pad)."""
    keys = [(c[2].ridx.shape, c[2].la_pad) for c in corpus]
    top = max(keys, key=keys.count)
    return [c for c, k in zip(corpus, keys) if k == top]


def test_sparse_batch_matches_reference_batch():
    corpus = _one_bucket(_corpus(("edge-mesh",), n_sets=10, n_flows=4))
    assert len(corpus) >= 2
    rb = ref.solve_relaxation_sparse_batch([c[1] for c in corpus], n_iters=N_ITERS)
    pb = port.solve_relaxation_sparse_batch([c[2] for c in corpus], n_iters=N_ITERS, device=CPU)
    for (_, rp, pp), (m_r, sp_r, _), (m_p, sp_p, _) in zip(corpus, rb, pb):
        assert _record(port_finalize, pp, m_p, sp_p) == _record(ref_finalize, rp, m_r, sp_r)


def test_converged_lanes_freeze_exactly():
    """Each lane of a batch lands bitwise on its B == 1 trajectory: lanes that
    converge early freeze while the others anneal on, and padding lanes
    change nothing."""
    progs = [c[2] for c in _one_bucket(_corpus(("edge-mesh",), n_sets=10, n_flows=4))]
    batch = port.solve_relaxation_sparse_batch(progs, n_iters=N_ITERS, device=CPU)
    assert len({steps for _, _, steps in batch}) > 1  # lanes exited at different chunks
    for prog, (m_b, sp_b, st_b) in zip(progs, batch):
        m_s, sp_s, st_s = port.solve_relaxation_sparse(prog, n_iters=N_ITERS, device=CPU)
        np.testing.assert_array_equal(m_b, m_s)
        assert (sp_b, st_b) == (sp_s, st_s)


def test_early_exit_off_walks_the_budget():
    prog = _corpus(("fat-tree",), n_sets=1)[0][2]
    _, _, steps = port.solve_relaxation_sparse(
        prog, n_iters=N_ITERS, early_exit=False, device=CPU
    )
    assert steps == N_ITERS


def _stream():
    """A solve stream with repeats (program-cache hits) and single-flow sets
    (the analytic fast path), on two networks."""
    out = []
    for name in ("edge-mesh", "fat-tree"):
        rnet, _ = ref.SCENARIOS[name].build(seed=1, n_jobs=4)
        pnet, _ = port.SCENARIOS[name].build(seed=1, n_jobs=4)
        for n_flows, seed in ((1, 3), (3, 5), (4, 6), (3, 5), (1, 3)):
            (rfs,) = ref.random_flow_sets(rnet, 1, n_flows, seed=seed)
            (pfs,) = port.random_flow_sets(pnet, 1, n_flows, seed=seed)
            out.append((rnet, rfs, pnet, pfs))
    return out


def test_engine_solve_many_matches_sequential_and_reference_counters():
    stream = _stream()
    reng = ref.JRBAEngine(k=K, n_iters=N_ITERS, solver="sparse")
    seq = port.JRBAEngine(k=K, n_iters=N_ITERS, device=CPU)
    many = port.JRBAEngine(k=K, n_iters=N_ITERS, device=CPU)
    assert seq.solver == "sparse"
    got_ref = [reng.solve(r, f) for r, f, _, _ in stream]
    got_seq = [seq.solve(p, f) for _, _, p, f in stream]
    got_many = many.solve_many([p for *_, p, _ in stream], [f for *_, f in stream])
    for a, b, c in zip(got_ref, got_seq, got_many):
        assert a.routes == b.routes == c.routes
        np.testing.assert_array_equal(a.bandwidth, b.bandwidth)
        np.testing.assert_array_equal(b.bandwidth, c.bandwidth)
        assert a.span == b.span == c.span
    for field in ("fast_path_solves", "prog_cache_hits", "prog_cache_misses", "single_solves"):
        assert getattr(seq.stats, field) == getattr(reng.stats, field), field
    assert seq.stats.fast_path_solves == 4 and seq.stats.prog_cache_hits == 4
    assert many.stats.fast_path_solves == 4 and many.stats.batched_instances == 6


def test_engine_dense_matches_reference_dense_engine():
    stream = _stream()[1:4]
    reng = ref.JRBAEngine(k=K, n_iters=N_ITERS, solver="dense")
    peng = port.JRBAEngine(k=K, n_iters=N_ITERS, solver="dense", device=CPU)
    ra = reng.solve_many([r for r, *_ in stream], [f for _, f, _, _ in stream])
    pa = peng.solve_many([p for *_, p, _ in stream], [f for *_, f in stream])
    for a, b in zip(ra, pa):
        assert a.routes == b.routes and a.span == b.span
    assert peng.stats.fast_path_solves == 0 and peng.stats.batched_solves == reng.stats.batched_solves


def test_program_cache_shares_tensors_and_device_mirrors():
    net, _ = port.SCENARIOS["edge-mesh"].build(seed=0, n_jobs=4)
    (fs,) = port.random_flow_sets(net, 1, 4, seed=5)
    eng = port.JRBAEngine(k=K, n_iters=100, device=CPU)
    p1 = eng.build(net, fs)
    p2 = eng.build(net, fs, capacity=net.capacity * 0.5)
    assert p1.ridx is p2.ridx and p1.csr_slot is p2.csr_slot and p1.dev is p2.dev
    assert p2.capacity.dtype == np.float32
    mirror = p1.device("ridx", eng.device)
    assert p2.device("ridx", eng.device) is mirror
    assert ("ridx", "cpu") in p1.dev


def test_resolve_solver_follows_the_explicit_device(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_JRBA_SOLVER", raising=False)
    assert resolve_solver("auto", "cpu") == "sparse"
    assert resolve_solver("auto", "cuda") == "cuda"
    assert resolve_solver("sparse", "cuda") == "sparse"
    with pytest.raises(ValueError):
        resolve_solver("cuda", "cpu")
    with pytest.raises(ValueError):
        port.JRBAEngine(solver="cuda", device=CPU)
    monkeypatch.setenv("REPRO_TORCH_JRBA_SOLVER", "dense")
    assert port.JRBAEngine(device=CPU).solver == "dense"
    assert resolve_solver("sparse", "cpu") == "sparse"  # explicit beats the env
    monkeypatch.setenv("REPRO_TORCH_JRBA_SOLVER", "bogus")
    with pytest.raises(ValueError):
        resolve_solver("auto", "cpu")
    # the reference's own override does not steer the port
    monkeypatch.delenv("REPRO_TORCH_JRBA_SOLVER")
    monkeypatch.setenv("REPRO_JRBA_SOLVER", "dense")
    assert resolve_solver("auto", "cpu") == "sparse"


def test_jrba_function_matches_reference():
    rnet, _ = ref.SCENARIOS["hetero-low"].build(seed=0, n_jobs=4)
    pnet, _ = port.SCENARIOS["hetero-low"].build(seed=0, n_jobs=4)
    (rfs,) = ref.random_flow_sets(rnet, 1, 5, seed=2)
    (pfs,) = port.random_flow_sets(pnet, 1, 5, seed=2)
    for wf in (False, True):
        a = ref.jrba(rnet, rfs, k=K, n_iters=N_ITERS, water_filling=wf, solver="sparse")
        b = port.jrba(pnet, pfs, k=K, n_iters=N_ITERS, water_filling=wf, device=CPU)
        assert a.routes == b.routes and a.span == b.span
        np.testing.assert_array_equal(a.bandwidth, b.bandwidth)
        np.testing.assert_array_equal(a.link_load, b.link_load)
        np.testing.assert_array_equal(a.candidate_links, b.candidate_links)
