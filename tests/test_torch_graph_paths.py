"""The port's host control plane against the JAX package's: networks, candidate
paths, arrival traces and churn traces from the same seeds are equal, array
for array. Both packages are imported here; data crosses as numpy/Python."""
import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.paths import path_link_index as ref_path_link_index
from repro_torch.core.paths import path_link_index as port_path_link_index

K = 3


def _nets(name, seed=0, n_jobs=4):
    return ref.SCENARIOS[name].build(seed=seed, n_jobs=n_jobs), port.SCENARIOS[name].build(
        seed=seed, n_jobs=n_jobs
    )


def _plain(x):
    """Dataclass trees (Task, JobGraph, ChurnStep, ...) as plain tuples, so
    the two packages' classes compare by value."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    return x


def test_same_scenarios_and_exports():
    assert sorted(ref.SCENARIOS) == sorted(port.SCENARIOS)
    assert len(port.SCENARIOS) == 12
    assert sorted(ref.__all__) == sorted(port.__all__)


@pytest.mark.parametrize("name", sorted(ref.SCENARIOS))
def test_networks_and_arrivals_equal(name):
    (rnet, rarr), (pnet, parr) = _nets(name)
    assert rnet.links == pnet.links
    np.testing.assert_array_equal(rnet.capacity, pnet.capacity)
    np.testing.assert_array_equal(rnet.mem_max, pnet.mem_max)
    np.testing.assert_array_equal(rnet.power, pnet.power)
    assert (rnet.topology_version, rnet.capacity_version) == (
        pnet.topology_version,
        pnet.capacity_version,
    )
    assert _plain(rarr) == _plain(parr)


@pytest.mark.parametrize("name", sorted(ref.SCENARIOS))
def test_paths_and_link_index_equal(name):
    """Yen's enumeration (tie-breaks included) and the padded path->link
    index tensor (sentinel L, power-of-two Pmax) on sampled node pairs."""
    (rnet, _), (pnet, _) = _nets(name)
    rng = np.random.RandomState(7)
    all_r, all_p = [], []
    for _ in range(6):
        u, v = (int(x) for x in rng.choice(rnet.n_nodes, size=2, replace=False))
        pr = ref.k_shortest_paths(rnet, u, v, K)
        pp = port.k_shortest_paths(pnet, u, v, K)
        assert pr == pp
        assert ref.dijkstra(rnet, u, v) == port.dijkstra(pnet, u, v)
        assert ref.avg_path_bandwidth(rnet, u, v) == port.avg_path_bandwidth(pnet, u, v)
        all_r.append(pr)
        all_p.append(pp)
    np.testing.assert_array_equal(
        ref_path_link_index(rnet, all_r, k=K, rows=8),
        port_path_link_index(pnet, all_p, k=K, rows=8),
    )


@pytest.mark.parametrize("name", sorted(ref.SCENARIOS))
def test_churn_traces_and_effects_equal(name):
    """Churn traces are equal, and replaying them mutates both networks
    identically (capacities, liveness, epochs and every ChurnEffect)."""
    rnet, rarr, rch = ref.SCENARIOS[name].build_churn(seed=1, n_jobs=4)
    pnet, parr, pch = port.SCENARIOS[name].build_churn(seed=1, n_jobs=4)
    assert _plain(rarr) == _plain(parr)
    assert _plain(rch) == _plain(pch)
    for rs, ps in zip(rch[:12], pch[:12]):
        re_, pe = ref.apply_churn_step(rnet, rs), port.apply_churn_step(pnet, ps)
        assert _plain(tuple(re_)) == _plain(tuple(pe))
        np.testing.assert_array_equal(rnet.capacity, pnet.capacity)
        np.testing.assert_array_equal(rnet.link_alive, pnet.link_alive)
        assert (rnet.topology_version, rnet.capacity_version) == (
            pnet.topology_version,
            pnet.capacity_version,
        )


def test_generated_traces_equal():
    """The standalone trace generators, seeded alike."""
    (rnet, _), (pnet, _) = _nets("edge-mesh")
    for fn in ("capacity_drift_trace", "link_failure_trace", "mmpp_dip_trace"):
        r = getattr(ref, fn)(rnet, np.random.RandomState(3), t_end=50.0)
        p = getattr(port, fn)(pnet, np.random.RandomState(3), t_end=50.0)
        assert _plain(r) == _plain(p), fn
    r = ref.correlated_failure_trace(rnet, np.random.RandomState(4), t_end=50.0)
    p = port.correlated_failure_trace(pnet, np.random.RandomState(4), t_end=50.0)
    assert _plain(r) == _plain(p)


def test_allocation_equal():
    """Algorithm 1 on the same job and network places identically."""
    (rnet, rarr), (pnet, parr) = _nets("edge-cloud")
    for j, ((_, rjob, _), (_, pjob, _)) in enumerate(zip(rarr, parr)):
        ra, rf = ref.allocate_greedy(rnet, rjob, job_id=j)
        pa, pf = port.allocate_greedy(pnet, pjob, job_id=j)
        assert _plain(ra) == _plain(pa)
        assert _plain(rf) == _plain(pf)
        np.testing.assert_array_equal(rnet.mem_avail, pnet.mem_avail)
        rr, rb = ref.equal_share_bandwidth(rnet, rf)
        pr, pb = port.equal_share_bandwidth(pnet, pf)
        assert rr == pr
        np.testing.assert_array_equal(rb, pb)
        assert ref.job_span(rnet, ra, rf, rb) == port.job_span(pnet, pa, pf, pb)
