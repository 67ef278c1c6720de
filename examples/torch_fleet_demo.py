"""Fleet demo on the PyTorch port (the twin of ``examples/fleet_demo.py``):
run every scenario through OTFS/OTFA with one shared engine, show the
batched JRBA path solving a fleet of instances in one call, show
speculative intra-round OTFS batching collapsing a flash crowd's per-job
solves into per-round dispatches, then co-schedule a whole fleet of
simulations through ``FleetRuntime`` with observability on — lockstep
steppers whose per-event solves batch across simulations — printing the
per-job latency percentile table and barrier-stall attribution, and writing
the per-round telemetry trace to ``fleet_trace.jsonl`` plus a
Perfetto-loadable span trace to ``fleet_trace.chrome.json``, both under
``--out-dir``. The async section then re-runs a mixed-churn fleet under
``AsyncFleetRuntime`` (continuous batching, no barrier) and prints both
runtimes' events/sec, the recovered stall fraction, and the
records-identical check.

  PYTHONPATH=src python examples/torch_fleet_demo.py [--device cpu] [--out-dir DIR]

Runs on the card unless ``--device cpu`` is given: every engine there
solves through the JRBA CUDA kernel (``solver="auto"``), and the churn
section's "sparse" run is that kernel (the sparse relaxation), held against
the dense formulation. Each section returns what it prints.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (  # noqa: E402
    SCENARIOS,
    EventTrace,
    JRBAEngine,
    OnlineScheduler,
    jrba,
    random_edge_network,
    random_flow_sets,
)
from repro_torch.fleet import (  # noqa: E402
    AsyncFleetRuntime,
    FleetRuntime,
    build_async_fleet,
    build_scenario_fleet,
)
from repro_torch.obs import Tracer  # noqa: E402

OUT_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                                       "build", "torch_fleet_demo"))


def scenario_tour(device: str = "cuda") -> dict:
    """Returns ``{(scenario, policy): SimResult}`` and the engine."""
    print("=== Scenario suite: OTFS vs OTFA on every topology ===")
    engine = JRBAEngine(k=3, n_iters=150, device=device)  # shared: buckets built once
    print(f"{'scenario':18s} {'policy':6s} {'tput':>6s} {'wait':>7s} {'events':>6s}")
    results = {}
    for name, sc in sorted(SCENARIOS.items()):
        for policy in ("OTFS", "OTFA"):
            net, arrivals = sc.build(seed=0, n_jobs=6)
            sched = OnlineScheduler(net, policy, k_paths=3, jrba_iters=150, engine=engine)
            res = sched.run(arrivals)
            results[name, policy] = res
            print(
                f"{name:18s} {policy:6s} {res.avg_throughput:6.2f} "
                f"{res.avg_waiting_time:7.3f} {res.n_events:6d}"
            )
    s = engine.stats
    print(
        f"engine: {s.single_solves} solves over {s.cache_misses} compiled "
        f"shape buckets ({s.cache_hits} cache hits, {s.solve_seconds:.2f}s in solver)"
    )
    return {"results": results, "engine": engine}


def batched_fleet(device: str = "cuda") -> dict:
    """Returns the sequential and batched ``JRBAResult`` lists, their
    largest span deviation and both wall-clocks."""
    print("\n=== Batched JRBA: 32 independent instances, one compiled call ===")
    # the JAX example's instance set (that of benchmarks/fleet.py)
    net = random_edge_network(12, mean_bandwidth=5.0, rng=np.random.RandomState(0))
    sets = random_flow_sets(net, 32, 6, seed=1000)
    engine = JRBAEngine(k=3, n_iters=300, device=device)
    engine.solve_many(net, sets)  # warm-up
    for fs in sets:
        jrba(net, fs, k=3, n_iters=300, device=device)

    t0 = time.perf_counter()
    seq = [jrba(net, fs, k=3, n_iters=300, device=device) for fs in sets]
    t_seq = time.perf_counter() - t0
    t0 = time.perf_counter()
    bat = engine.solve_many(net, sets)
    t_bat = time.perf_counter() - t0
    dev = max(abs(a.span - b.span) / a.span for a, b in zip(seq, bat))
    print(f"sequential: {t_seq * 1e3:7.1f} ms")
    print(f"batched:    {t_bat * 1e3:7.1f} ms  ({t_seq / t_bat:.1f}x, max dev {dev:.2e})")
    return {"seq": seq, "bat": bat, "dev": dev, "t_seq": t_seq, "t_bat": t_bat}


def speculative_rounds(scenario: str = "edge-mesh-flash", n_jobs: int = 16,
                       device: str = "cuda") -> dict:
    """Returns the sequential and speculative ``SimResult``s and whether
    their records are identical."""
    print(f"\n=== Speculative intra-round OTFS batching: {scenario} ===")

    def run(speculate):
        engine = JRBAEngine(k=3, n_iters=150, device=device)
        net, arrivals = SCENARIOS[scenario].build(seed=0, n_jobs=n_jobs)
        sched = OnlineScheduler(
            net, "OTFS", k_paths=3, jrba_iters=150, engine=engine, speculate=speculate
        )
        sched.run(arrivals)  # warm path caches
        net, arrivals = SCENARIOS[scenario].build(seed=0, n_jobs=n_jobs)
        sched = OnlineScheduler(
            net, "OTFS", k_paths=3, jrba_iters=150, engine=engine, speculate=speculate
        )
        t0 = time.perf_counter()
        res = sched.run(arrivals)
        return time.perf_counter() - t0, res

    t_seq, seq = run(False)
    t_spec, spec = run(True)
    same = [a.finish_time for a in seq.records] == [b.finish_time for b in spec.records]
    print(f"sequential OTFS:  {t_seq * 1e3:6.0f} ms  {seq.n_dispatches} dispatches")
    print(
        f"speculative OTFS: {t_spec * 1e3:6.0f} ms  {spec.n_dispatches} dispatches "
        f"({t_seq / t_spec:.2f}x wall, {seq.n_dispatches / spec.n_dispatches:.2f}x collapse)"
    )
    print(
        f"speculation: {spec.spec_accepted} accepted / {spec.spec_repaired} repaired "
        f"(accept rate {spec.spec_accept_rate:.0%}); records identical: {same}"
    )
    return {"seq": seq, "spec": spec, "same": same}


def cosched_fleet(n_sims: int = 12, n_jobs: int = 3, device: str = "cuda",
                  out_dir: str = OUT_DIR) -> dict:
    """Returns the back-to-back ``SimResult``s, the fleet's
    ``FleetResult``, the largest span deviation and the trace paths."""
    print(f"\n=== Co-scheduled fleet: {n_sims} lockstep simulations ===")

    def build(engine):
        return build_scenario_fleet(engine, n_sims, n_jobs=n_jobs)

    seq_engine = JRBAEngine(k=3, n_iters=200, device=device)
    for s in build(seq_engine):  # warm caches
        s.scheduler.run(s.arrivals)
    t0 = time.perf_counter()
    solo = [s.scheduler.run(s.arrivals) for s in build(seq_engine)]
    t_seq = time.perf_counter() - t0

    fleet_engine = JRBAEngine(k=3, n_iters=200, device=device)
    runtime = FleetRuntime(fleet_engine, tracer=Tracer(), observe=True)
    runtime.run(build(fleet_engine))  # warm
    fleet = runtime.run(build(fleet_engine))

    dev = max(
        abs(a.avg_scheduled_span - b.avg_scheduled_span) / a.avg_scheduled_span
        for a, b in zip(solo, fleet.results)
        if np.isfinite(a.avg_scheduled_span) and a.avg_scheduled_span > 0
    )
    t = fleet.telemetry
    print(f"back-to-back: {t_seq * 1e3:7.0f} ms")
    print(
        f"co-scheduled: {fleet.wall_seconds * 1e3:7.0f} ms "
        f"({t_seq / fleet.wall_seconds:.2f}x, max span dev {dev:.2e})"
    )
    print(
        f"batching: {t.mean_batch_occupancy:.2f} instances/compiled call over "
        f"{len(t.rounds)} dispatch rounds, cache hit rate {t.cache_hit_rate:.0%}"
    )

    lat = t.summary["latency"]
    print("job arrival->scheduled latency (seconds):")
    print(f"  {'scenario':24s} {'n':>4s} {'p50':>10s} {'p95':>10s} {'p99':>10s}")
    rows = {"overall": lat["events"]["overall"], **lat["events"]["by_scenario"]}
    for name, snap in rows.items():
        if snap.get("count"):
            print(
                f"  {name:24s} {snap['count']:4d} {snap['p50']:10.2e} "
                f"{snap['p95']:10.2e} {snap['p99']:10.2e}"
            )
    barrier = lat["barrier"]
    print(
        f"barrier: {barrier['stall_fraction']:.0%} of lane wall-clock spent "
        f"stalled ({barrier['stall_seconds']:.3f}s stall vs "
        f"{barrier['own_solve_seconds']:.3f}s own solve)"
    )

    os.makedirs(out_dir, exist_ok=True)
    jsonl = os.path.join(out_dir, "fleet_trace.jsonl")
    chrome = os.path.join(out_dir, "fleet_trace.chrome.json")
    t.to_jsonl(jsonl)
    runtime.tracer.to_chrome(chrome)
    print(f"per-round trace -> {jsonl}")
    print(f"span trace -> {chrome} (open at ui.perfetto.dev)")
    return {"solo": solo, "fleet": fleet, "dev": dev, "traces": (jsonl, chrome)}


def async_fleet(n_sims: int = 24, n_jobs: int = 2, device: str = "cuda") -> dict:
    """Returns the lockstep and async ``FleetResult``s and whether their
    records are identical."""
    print(f"\n=== Async continuous batching: {n_sims} mixed-churn lanes ===")
    # every 4th lane carries a capacity-drift churn trace; the async
    # dispatcher replaces the lockstep barrier with per-shape-bucket queues
    # (REPRO_FLEET_RUNTIME=async flips any FleetRuntime() the same way)

    def build(engine):
        return build_async_fleet(engine, n_sims, n_jobs=n_jobs, churn_every=4)

    lock_engine = JRBAEngine(k=2, n_iters=60, device=device)
    lock_rt = FleetRuntime(lock_engine, mode="lockstep")
    lock_rt.run(build(lock_engine))  # warm caches
    lock = lock_rt.run(build(lock_engine))

    async_engine = JRBAEngine(k=2, n_iters=60, device=device)
    async_rt = AsyncFleetRuntime(async_engine, batch_target=8, deadline_s=0.002)
    async_rt.run(build(async_engine))  # warm
    asyn = async_rt.run(build(async_engine))

    same = all(
        [r.finish_time for r in a.records] == [r.finish_time for r in b.records]
        for a, b in zip(lock.results, asyn.results)
    )
    print(f"lockstep: {lock.total_events / lock.wall_seconds:7.0f} events/s")
    print(f"async:    {asyn.total_events / asyn.wall_seconds:7.0f} events/s")
    lock_stall = lock.telemetry.summary["latency"]["barrier"]["stall_seconds"]
    async_stall = asyn.telemetry.summary["latency"]["barrier"]["stall_seconds"]
    recovered = 1.0 - async_stall / lock_stall if lock_stall else 0.0
    queue = asyn.telemetry.summary["latency"]["queue"]
    print(
        f"stall: {lock_stall:.3f}s behind the barrier -> {async_stall:.3f}s "
        f"in queue ({recovered:+.0%} recovered)"
    )
    print(
        f"dispatcher: {queue['dispatches']} fires ({queue['fired_by']}), "
        f"occupancy {asyn.telemetry.mean_batch_occupancy:.2f}"
    )
    print(f"records identical to lockstep: {same}")
    return {"lock": lock, "async": asyn, "same": same}


def churn_storm(scenario: str = "wan-mesh-churn", n_jobs: int = 6,
                device: str = "cuda") -> dict:
    """Returns the dense and sparse (on the card: the kernel) ``SimResult``s
    and whether their records are identical."""
    print(f"\n=== Network churn: {scenario} (drift + failures + MMPP dips) ===")
    runs = {}
    for solver in ("dense", "auto"):
        net, arrivals, churn = SCENARIOS[scenario].build_churn(seed=0, n_jobs=n_jobs)
        sched = OnlineScheduler(net, "OTFS", k_paths=3, jrba_iters=150, solver=solver,
                                device=device)
        runs[solver] = sched.run(EventTrace(arrivals, churn=churn))
    res = runs["auto"]
    same = [a.finish_time for a in runs["dense"].records] == [
        b.finish_time for b in res.records
    ]
    print(
        f"{res.churn_events} churn events -> {res.churn_resolves} re-solves, "
        f"{res.churn_reroutes} re-routes, {res.churn_stalls} stalls"
    )
    print(
        f"all jobs finished: {res.unfinished == 0}; "
        f"dense/sparse records identical: {same}"
    )
    return {"dense": runs["dense"], "sparse": res, "same": same}


def churn_speculation(scenario: str = "edge-mesh-flash-churn", n_jobs: int = 12,
                      device: str = "cuda") -> dict:
    """Returns the sequential and speculative ``SimResult``s and whether
    their records are identical."""
    print(f"\n=== Churn-resilient speculation: {scenario} ===")

    def run(speculate, scoped):
        net, arrivals, churn = SCENARIOS[scenario].build_churn(seed=0, n_jobs=n_jobs)
        sched = OnlineScheduler(
            net,
            "OTFS",
            k_paths=2,
            jrba_iters=40,
            speculate=speculate,
            scoped_churn=scoped,
            device=device,
        )
        return sched.run(EventTrace(arrivals, churn=churn))

    seq = run(False, False)  # pre-scoping reference: wholesale drops, per-job solves
    spec = run(True, True)
    same = [a.finish_time for a in seq.records] == [b.finish_time for b in spec.records]
    print(
        f"{spec.churn_events} churn events: {spec.churn_spec_survived} speculations "
        f"survived, {spec.churn_spec_dropped} dropped (footprint-scoped)"
    )
    print(
        f"batched churn re-solves: {spec.churn_spec_accepted} accepted / "
        f"{spec.churn_spec_repaired} repaired; dispatches "
        f"{seq.n_dispatches} -> {spec.n_dispatches}"
        + (
            f", wide-step collapse {spec.churn_dispatch_collapse:.2f}x"
            if spec.churn_wide_dispatches
            else ""
        )
    )
    print(f"records identical to sequential: {same}")
    return {"seq": seq, "spec": spec, "same": same}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=OUT_DIR, help="where the two trace files go")
    args = ap.parse_args(argv)
    dev = args.device
    return {
        "scenario_tour": scenario_tour(dev),
        "batched_fleet": batched_fleet(dev),
        "speculative_rounds": speculative_rounds(device=dev),
        "cosched_fleet": cosched_fleet(device=dev, out_dir=args.out_dir),
        "async_fleet": async_fleet(device=dev),
        "churn_storm": churn_storm(device=dev),
        "churn_speculation": churn_speculation(device=dev),
    }


if __name__ == "__main__":
    main()
