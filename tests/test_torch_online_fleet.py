"""The port's online scheduler and fleet runtimes against the JAX package's,
on the CPU: the same scenario, seed and policy give identical job records
(``max_record_rel_dev == 0``) and identical protocol counters."""
import dataclasses

import numpy as np
import pytest
from _torch_sanitize import port_sanitizer  # noqa: F401

import repro.core as ref
import repro.fleet as ref_fleet
import repro_torch.core as port
import repro_torch.fleet as port_fleet

K = 3
N_ITERS = 120
CPU = "cpu"


def max_record_dev(results_a, results_b) -> float:
    """Worst relative deviation between two runs' job records (the fleet
    benchmark's metric): zero only when every schedule/finish time is
    exactly equal; sign or finiteness mismatches count as full deviation."""
    dev = 0.0
    for a, b in zip(results_a, results_b):
        assert len(a.records) == len(b.records)
        for ra, rb in zip(a.records, b.records):
            for va, vb in (
                (ra.schedule_time, rb.schedule_time),
                (ra.finish_time, rb.finish_time),
            ):
                if va == vb:
                    continue
                scale = abs(va) if np.isfinite(va) and va != 0 else 1.0
                gap = abs(va - vb)
                dev = max(dev, gap / scale if np.isfinite(gap) else 1.0)
    return dev


def _counters(res) -> dict:
    return {
        f.name: getattr(res, f.name)
        for f in dataclasses.fields(res)
        if isinstance(getattr(res, f.name), (int, np.integer))
    }


def _assert_same(ra, rb):
    """Records, routes, bandwidths and counters all equal."""
    assert max_record_dev([ra], [rb]) == 0.0
    for a, b in zip(ra.records, rb.records):
        assert (a.job_id, a.submit_time, a.done, a.migrations) == (
            b.job_id,
            b.submit_time,
            b.done,
            b.migrations,
        )
        assert a.routes == b.routes
        if a.bandwidths is None:
            assert b.bandwidths is None
        else:
            np.testing.assert_array_equal(a.bandwidths, b.bandwidths)
    assert _counters(ra) == _counters(rb)


def _ref_sched(net, policy, **kw):
    eng = ref.JRBAEngine(k=K, n_iters=N_ITERS, solver="sparse")
    return ref.OnlineScheduler(net, policy, k_paths=K, jrba_iters=N_ITERS, engine=eng, **kw)


def _port_sched(net, policy, **kw):
    return port.OnlineScheduler(net, policy, k_paths=K, jrba_iters=N_ITERS, device=CPU, **kw)


@pytest.mark.parametrize("policy", ("OTFS", "OTFA", "LR", "BR", "TP"))
@pytest.mark.parametrize("scenario", ("edge-mesh", "wan-mesh", "fat-tree"))
def test_scheduler_records_identical(scenario, policy):
    rnet, rarr = ref.SCENARIOS[scenario].build(seed=0, n_jobs=4)
    pnet, parr = port.SCENARIOS[scenario].build(seed=0, n_jobs=4)
    ra = _ref_sched(rnet, policy).run(rarr)
    sched = _port_sched(pnet, policy)
    assert sched.engine.solver == "sparse" and sched.engine.device.type == "cpu"
    rb = sched.run(parr)
    assert ra.n_scheduled == rb.n_scheduled
    _assert_same(ra, rb)


def test_churn_otfs_records_identical():
    """Churn: footprint-scoped invalidation, speculate-then-repair and
    re-solves of running jobs, on the wan-mesh churn trace."""
    rnet, rarr, rch = ref.SCENARIOS["wan-mesh-churn"].build_churn(seed=1, n_jobs=4)
    pnet, parr, pch = port.SCENARIOS["wan-mesh-churn"].build_churn(seed=1, n_jobs=4)
    ra = _ref_sched(rnet, "OTFS").run(ref.EventTrace(rarr, churn=rch))
    rb = _port_sched(pnet, "OTFS").run(port.EventTrace(parr, churn=pch))
    assert rb.churn_events > 0
    _assert_same(ra, rb)


def test_node_chaos_migration_records_identical():
    """Stall-budget migration under correlated node failures."""
    rnet, rarr, rch = ref.SCENARIOS["edge-mesh-node-chaos"].build_churn(seed=0, n_jobs=4)
    pnet, parr, pch = port.SCENARIOS["edge-mesh-node-chaos"].build_churn(seed=0, n_jobs=4)
    ra = _ref_sched(rnet, "OTFS", stall_budget=1.0).run(ref.EventTrace(rarr, churn=rch))
    rb = _port_sched(pnet, "OTFS", stall_budget=1.0).run(port.EventTrace(parr, churn=pch))
    assert rb.churn_events > 0
    _assert_same(ra, rb)


def test_fleets_match_reference_lockstep():
    """Port lockstep and async fleets (8 lanes, drift churn on every 4th
    lane) against the reference lockstep fleet, record for record."""
    reng = ref.JRBAEngine(k=K, n_iters=N_ITERS, solver="sparse")
    rres = ref_fleet.FleetRuntime(reng, mode="lockstep").run(
        ref_fleet.build_async_fleet(reng, 8, n_jobs=2)
    )
    for mode in ("lockstep", "async"):
        peng = port.JRBAEngine(k=K, n_iters=N_ITERS, device=CPU)
        pres = port_fleet.FleetRuntime(peng, mode=mode).run(
            port_fleet.build_async_fleet(peng, 8, n_jobs=2)
        )
        assert pres.unfinished == rres.unfinished
        assert max_record_dev(rres.results, pres.results) == 0.0, mode
        for a, b in zip(rres.results, pres.results):
            _assert_same(a, b)
        assert peng.stats.batched_solves > 0


def test_chaos_fleet_matches_reference():
    reng = ref.JRBAEngine(k=K, n_iters=N_ITERS, solver="sparse")
    peng = port.JRBAEngine(k=K, n_iters=N_ITERS, device=CPU)
    rres = ref_fleet.FleetRuntime(reng, mode="lockstep").run(
        ref_fleet.build_chaos_fleet(reng, 3, n_jobs=3)
    )
    pres = port_fleet.AsyncFleetRuntime(peng).run(port_fleet.build_chaos_fleet(peng, 3, n_jobs=3))
    assert max_record_dev(rres.results, pres.results) == 0.0
