"""Fleet co-scheduling runtime: N independent online-scheduling simulations
whose per-event JRBA solves batch into single solver calls.

A single :class:`~repro_torch.core.OnlineScheduler` run solves its JRBA instances
one at a time — each solve is a tiny tensor program whose dispatch overhead
dwarfs its FLOPs, so the batched solver sits idle exactly where fleet
traffic needs it. The runtime exploits that the simulations are *mutually
independent* (each owns its topology and arrival trace): it drives every
simulation's resumable stepper (:meth:`OnlineScheduler.step`) to its next
pending :class:`~repro_torch.core.RoundRequest` (one or more solves — speculative
OTFS rounds carry one per waiting job) and batches the pending solves
through the extended :meth:`JRBAEngine.solve_many` (which batches across
networks by shape bucket). Simulated clocks advance independently — no state
is shared, so any grouping of the solves yields bit-identical records.

Two drivers implement that contract (``FleetRuntime(mode=...)``, or the
``REPRO_FLEET_RUNTIME`` env var; both produce identical per-lane records):

* ``"lockstep"`` — advance every live lane to its next round, flatten all
  rounds through ONE ``solve_many``, resume everyone, repeat. Maximal
  batching, but a global barrier: the slowest lane stalls the whole fleet
  each round (PR 7's ``latency.barrier`` block measures exactly how much).
* ``"async"`` — continuous batching, the serving-engine decode-batcher
  pattern: lanes run as independent steppers whose solves land in per-shape-
  bucket queues, and a dispatcher fires one ``solve_many`` per bucket
  whenever the bucket fills (``batch_target``) or its oldest entry's wait
  exceeds a deadline (``deadline_s``). No barrier — a lane resumes the
  moment its own round completes, so O(1000) lanes keep the engine saturated
  without convoying behind the stragglers.

This is the orchestrator-level analogue of Oakestra's root/cluster split and
KCES's cloud-edge pooling: one control plane multiplexing many edge
clusters' scheduling decisions through shared compute.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Generator

import numpy as np

from ..core.graph import JobGraph
from ..core.jrba import JRBAEngine
from ..core.online import (
    EventTrace,
    OnlineScheduler,
    RoundRequest,
    SimResult,
    SolveRequest,
)
from ..core.scenarios import SCENARIOS, ChurnStep, capacity_drift_trace
from ..obs.metrics import MetricsRegistry, StreamingHistogram
from ..obs.trace import NULL_TRACER, Tracer
from .telemetry import DispatchRecord, FleetTelemetry, RoundRecord

__all__ = [
    "FLEET_RUNTIMES",
    "FLEET_SCENARIOS",
    "AsyncFleetRuntime",
    "FleetSim",
    "FleetResult",
    "FleetRuntime",
    "build_async_fleet",
    "build_chaos_fleet",
    "build_scenario_fleet",
]

Arrivals = list[tuple[float, JobGraph, float]]

# default families for fleet experiments: all have seed-independent link
# counts, so lanes from the same family share (Nf, K, L) shape buckets and
# actually batch (wan-mesh's L varies per seed — every lane would sit in a
# private bucket and misrepresent co-scheduling)
FLEET_SCENARIOS = ("edge-mesh", "edge-cloud", "fat-tree", "hetero-low")

# the two fleet drivers; selected per-runtime via FleetRuntime(mode=...) or
# fleet-wide via the REPRO_FLEET_RUNTIME environment variable
FLEET_RUNTIMES = ("lockstep", "async")


@dataclasses.dataclass
class FleetSim:
    """One lane of the fleet: a scheduler plus its arrival trace. ``name``
    groups lanes in telemetry (e.g. the scenario that generated them);
    ``network_events`` is an optional churn trace for dynamic-network lanes
    (see ``core.scenarios``)."""

    scheduler: OnlineScheduler
    arrivals: Arrivals
    name: str = ""
    max_time: float = 1e6
    network_events: list[ChurnStep] | None = None

    @property
    def events(self) -> EventTrace:
        """The lane's input timeline in the form :meth:`OnlineScheduler.step`
        takes (arrivals + churn merged into one :class:`EventTrace`)."""
        return EventTrace(self.arrivals, churn=self.network_events)


def build_scenario_fleet(
    engine: JRBAEngine,
    n_sims: int,
    *,
    n_jobs: int = 4,
    names: tuple[str, ...] = FLEET_SCENARIOS,
    seed0: int = 0,
) -> list[FleetSim]:
    """One :class:`FleetSim` per lane: lane ``i`` runs scenario
    ``names[i % len(names)]`` with seed ``seed0 + i``, alternating OTFA/OTFS,
    all schedulers sharing ``engine``. Shared by the ``cosched`` benchmark,
    the demo, and the equivalence tests — call it once per run so every lane
    owns a fresh topology and no mutable network state leaks between a fleet
    pass and its back-to-back baseline."""
    sims = []
    for i in range(n_sims):
        name = names[i % len(names)]
        policy = "OTFS" if i % 2 else "OTFA"
        net, arrivals = SCENARIOS[name].build(seed=seed0 + i, n_jobs=n_jobs)
        sched = OnlineScheduler(
            net, policy, k_paths=engine.k, jrba_iters=engine.n_iters, engine=engine
        )
        sims.append(FleetSim(sched, arrivals, name=f"{name}/{policy}"))
    return sims


def build_async_fleet(
    engine: JRBAEngine,
    n_sims: int,
    *,
    n_jobs: int = 4,
    names: tuple[str, ...] = FLEET_SCENARIOS,
    seed0: int = 0,
    churn_every: int = 4,
) -> list[FleetSim]:
    """:func:`build_scenario_fleet` with every ``churn_every``-th lane
    carrying a capacity-drift churn trace over its arrival horizon — the
    mixed-churn fleet the async benchmark runs at O(1000) lanes. Drift-only
    churn keeps each lane's link count (hence its shape bucket) fixed while
    still forcing mid-flight re-solves, so churn lanes keep batching with
    their static siblings instead of fragmenting into per-lane compiled
    shapes the way topology churn (wan-mesh style, seed-dependent L) would.
    ``churn_every=0`` disables churn entirely."""
    sims = build_scenario_fleet(
        engine, n_sims, n_jobs=n_jobs, names=names, seed0=seed0
    )
    for i, s in enumerate(sims):
        if not churn_every or i % churn_every:
            continue
        # a private stream per lane, offset out of the scenario seed range so
        # churn draws never correlate with topology/arrival draws
        rng = np.random.RandomState(90_000 + seed0 + i)
        t_end = max((t for t, _, _ in s.arrivals), default=0.0) * 1.25 + 10.0
        s.network_events = capacity_drift_trace(s.scheduler.net, rng, t_end=t_end)
    return sims


def build_chaos_fleet(
    engine: JRBAEngine,
    n_sims: int,
    *,
    n_jobs: int = 4,
    name: str = "edge-mesh-node-chaos",
    seed0: int = 0,
    stall_budget: float | None = 1.0,
    speculate: bool = True,
) -> list[FleetSim]:
    """Node-failure lanes for the migration benchmark and tests: every lane
    runs the ``edge-mesh-node-chaos`` scenario (permanent correlated node
    blasts, sources pinned to a protected tier — see ``core.scenarios``)
    under OTFS, each carrying the scenario's own churn trace.
    ``stall_budget`` enables stall-budget migration on every lane; pass
    ``None`` for the migration-off reference (stranded jobs expected) and
    ``speculate=False`` for the sequential migration reference that batched
    re-solves must match record-for-record."""
    sims = []
    for i in range(n_sims):
        net, arrivals, churn = SCENARIOS[name].build_churn(
            seed=seed0 + i, n_jobs=n_jobs
        )
        sched = OnlineScheduler(
            net,
            "OTFS",
            k_paths=engine.k,
            jrba_iters=engine.n_iters,
            stall_budget=stall_budget,
            engine=engine,
            speculate=speculate,
        )
        sims.append(
            FleetSim(sched, arrivals, name=f"{name}/OTFS", network_events=churn)
        )
    return sims


@dataclasses.dataclass
class _Lane:
    """Runtime state of one simulation stepper."""

    sim: FleetSim
    gen: Generator[RoundRequest, tuple, SimResult]
    idx: int = 0  # position in the fleet (indexes the per-lane stall arrays)
    pending: RoundRequest | None = None
    result: SimResult | None = None


@dataclasses.dataclass
class _InFlight:
    """One lane round in the async dispatcher: its solves fan out across
    shape-bucket queues and may complete from different dispatches in any
    order; the lane resumes only when ``remaining`` hits zero, receiving the
    aligned ``results`` and its summed share of every dispatch it rode."""

    lane: _Lane
    solves: list[SolveRequest]
    results: list
    remaining: int
    enqueue_ts: float  # wall clock when the round was enqueued
    own_seconds: float = 0.0  # this round's amortized share of its dispatches


@dataclasses.dataclass
class _QueueEntry:
    """One solve waiting in a shape-bucket queue."""

    inflight: _InFlight
    pos: int  # index into inflight.solves / .results
    seq: int  # global enqueue order (cross-bucket age tie-break)
    ts: float  # wall clock at enqueue (deadline + queue-wait measurement)


def _round_has_real_solves(req: RoundRequest) -> bool:
    """Does this lane's pending round carry at least one flow that builds a
    real JRBA program (distinct endpoints, positive volume)? Mirrors the
    engine's ``build`` filter, so a False round contributes nothing to the
    shared dispatch."""
    return any(
        f.src != f.dst and f.volume > 0 for s in req.solves for f in s.flows
    )


@dataclasses.dataclass
class FleetResult:
    """Per-simulation results (aligned with the ``sims`` argument) plus the
    co-scheduling telemetry."""

    results: list[SimResult]
    telemetry: FleetTelemetry
    wall_seconds: float

    @property
    def total_events(self) -> int:
        return sum(r.n_events for r in self.results)

    @property
    def unfinished(self) -> int:
        return sum(r.unfinished for r in self.results)


class FleetRuntime:
    """Multi-simulation driver over one shared :class:`JRBAEngine`, in one of
    two modes (see the module docstring): ``"lockstep"`` barrier rounds or
    ``"async"`` continuous batching. ``mode=None`` reads the
    ``REPRO_FLEET_RUNTIME`` environment variable (default ``"lockstep"``), so
    a CI leg can flip a whole test suite's fleets without touching call
    sites; an explicit ``mode=`` always wins.

    **Lockstep.** Every round: collect each live simulation's pending round
    (one or more solves — speculative OTFS rounds batch all their waiting
    jobs), flatten them all through ``solve_many`` (same-shape instances
    share one batched solver call; solver wall-clock is amortized per solve
    for per-sim ``sched_overhead`` accounting), resume each stepper with its
    slice of results, and record a :class:`RoundRecord`. Simulations drop out
    as they finish; the engine's batch-dimension padding keeps the draining
    fleet on O(log N) batch shapes.

    **Async.** Each lane's pending solves enter per-shape-bucket FIFO queues
    (keyed by :meth:`JRBAEngine.bucket_key`, stamped on the
    :class:`SolveRequest` by the stepper). The dispatcher repeatedly picks a
    bucket — one whose head has waited ≥ ``deadline_s`` (oldest head first),
    else one holding ≥ ``batch_target`` entries (fullest first), else the
    bucket with the oldest head (so a lone odd-shaped lane is never
    starved) — takes up to ``batch_target`` entries, and runs them through
    one ``solve_many``. A lane resumes as soon as its own round completes and
    immediately enqueues its next one, recorded as a
    :class:`DispatchRecord` per fire. Everything is cooperative and
    single-threaded: determinism needs no locks, and per-lane records are
    bit-identical to the lockstep driver because the engine's per-program
    results are composition-independent (the invariant every batching layer
    of this codebase holds).

    **Stall attribution** (always on — pure arithmetic). Each lane round's
    *own* share of a shared dispatch is ``dispatch_seconds * n_i / n_total``
    and the rest of the time it spent waiting on co-batched work is *stall*:
    under lockstep that wait is the barrier (``own + stall`` sums exactly to
    the dispatch wall-clock of the rounds the lane was live in), under async
    it is queue wait (``own + stall == answer - enqueue`` per round). The
    summary's ``latency.barrier`` block reports per-lane totals and the
    fleet-wide stall fraction for both modes — the async driver's reason to
    exist is pushing that fraction toward zero — and async adds a
    ``latency.queue`` block (fire causes, wait percentiles).

    **Tracing / metrics.** Pass ``tracer=repro_torch.obs.Tracer()`` (and/or
    ``observe=True``) to record per-event spans on one track per lane plus a
    shared engine track, per-lane barrier (or per-entry ``queue/wait``)
    intervals, and per-job arrival→scheduled latency histograms (merged per
    scenario into ``latency.events``). The runtime re-points each lane
    scheduler's ``tracer``/``metrics``/``trace_track`` and the engine's
    ``tracer``; with neither flag the schedulers keep their null objects and
    the run is byte-identical to an unobserved one (the fleet benchmark's
    ``latency`` section measures the enabled overhead at <5%).
    """

    def __init__(
        self,
        engine: JRBAEngine | None = None,
        *,
        mode: str | None = None,
        tracer: Tracer | None = None,
        observe: bool = False,
        batch_target: int = 32,
        deadline_s: float = 0.002,
    ) -> None:
        if mode is None:
            mode = os.environ.get("REPRO_FLEET_RUNTIME", "lockstep")
        if mode not in FLEET_RUNTIMES:
            raise ValueError(
                f"unknown fleet runtime {mode!r}; one of {FLEET_RUNTIMES} "
                "(check REPRO_FLEET_RUNTIME if mode= was not passed)"
            )
        self.mode = mode
        self.engine = engine
        self.tracer = tracer
        self.observe = observe
        # async knobs (inert under lockstep): fire a bucket at batch_target
        # entries, or as soon as its oldest entry has waited deadline_s.
        # deadline_s=0 degenerates to strict FIFO (every head is instantly
        # overdue); deadline_s=inf to pure fill-then-flush — both exercised
        # by the dispatcher unit tests.
        self.batch_target = batch_target
        self.deadline_s = deadline_s

    def run(self, sims: list[FleetSim]) -> FleetResult:
        if not sims:
            raise ValueError("empty fleet")
        engine = self.engine or sims[0].scheduler.engine
        for s in sims:
            if (s.scheduler.k_paths, s.scheduler.jrba_iters) != (engine.k, engine.n_iters):
                raise ValueError(
                    f"fleet sim {s.name!r} has engine hyperparameters "
                    f"(k={s.scheduler.k_paths}, n_iters={s.scheduler.jrba_iters}) "
                    f"!= shared engine (k={engine.k}, n_iters={engine.n_iters}); "
                    "co-scheduled solves would diverge from standalone runs"
                )
        telemetry = FleetTelemetry()
        tracer = self.tracer if self.tracer is not None else NULL_TRACER
        observing = self.observe or tracer.enabled
        lane_metrics: list[MetricsRegistry] | None = None
        if observing:
            # one timeline track + one metrics registry per lane, engine
            # spans on a shared track; wiring happens before the steppers
            # are created so step() binds the observed objects
            lane_metrics = [MetricsRegistry() for _ in sims]
            for i, s in enumerate(sims):
                s.scheduler.tracer = tracer
                s.scheduler.trace_track = f"lane{i}:{s.name or 'sim'}"
                s.scheduler.metrics = lane_metrics[i]
            engine.tracer = tracer
        # snapshot so telemetry reports THIS run's cache behaviour even when
        # the engine was warmed by earlier runs (the benchmark's
        # warm-then-measure pattern)
        hits0, misses0 = engine.stats.cache_hits, engine.stats.cache_misses
        solver0 = dataclasses.asdict(engine.stats)
        t_start = time.perf_counter()
        lanes = [
            _Lane(sim=s, gen=s.scheduler.step(s.events, max_time=s.max_time), idx=i)
            for i, s in enumerate(sims)
        ]
        for lane in lanes:  # prime: advance to the first solve (or completion)
            self._advance(lane, None)
        if self.mode == "async":
            (
                lane_own,
                lane_stall,
                lane_wall,
                total_dispatch,
                queue_block,
                n_requests,
            ) = self._drive_async(lanes, engine, telemetry, tracer, hits0, misses0)
        else:
            lane_own, lane_stall, lane_wall, total_dispatch = self._drive_lockstep(
                lanes, engine, telemetry, tracer, hits0, misses0
            )
            queue_block, n_requests = None, None
        wall = time.perf_counter() - t_start
        results = [ln.result for ln in lanes]
        stats1 = dataclasses.asdict(engine.stats)
        # engine phase breakdown for THIS run: where the flat solve time
        # actually went (host build, cache replay, device dispatch, rounding)
        solver_phases = {
            key: stats1[key] - solver0[key]
            for key in (
                "build_seconds",
                "cache_seconds",
                "dispatch_seconds",
                "finalize_seconds",
            )
        }
        total_stall = sum(lane_stall)
        total_lane_wall = sum(lane_wall)
        events_block = None
        if lane_metrics is not None:
            overall = StreamingHistogram()
            by_scenario: dict[str, StreamingHistogram] = {}
            for s, reg in zip(sims, lane_metrics):
                h = reg.histograms.get("event_latency_s")
                if h is None:
                    continue
                overall.merge(h)
                by_scenario.setdefault(s.name or "sim", StreamingHistogram()).merge(h)
            events_block = {
                "overall": overall.snapshot(),
                "by_scenario": {
                    k: v.snapshot() for k, v in sorted(by_scenario.items())
                },
            }
        latency = {
            # shared-dispatch wait attribution, both modes (see class
            # docstring): stall is barrier wait under lockstep, queue wait
            # under async — same shape so stall recovery is a direct diff
            "barrier": {
                "dispatch_seconds": total_dispatch,
                "own_solve_seconds": sum(lane_own),
                "stall_seconds": total_stall,
                # fraction of total lane wait that was stall: 0 for a single
                # lockstep lane, -> (n-1)/n when every lane waits a full
                # dispatch on everyone else
                "stall_fraction": (
                    total_stall / total_lane_wall if total_lane_wall else 0.0
                ),
                "per_lane": [
                    {
                        "lane": i,
                        "name": s.name or "sim",
                        "own_seconds": lane_own[i],
                        "stall_seconds": lane_stall[i],
                        "wall_seconds": lane_wall[i],
                        "stall_fraction": (
                            lane_stall[i] / lane_wall[i] if lane_wall[i] else 0.0
                        ),
                    }
                    for i, s in enumerate(sims)
                ],
            },
            # async dispatcher internals (fire causes, queue-wait
            # percentiles, knobs); None under lockstep
            "queue": queue_block,
            # per-job arrival->scheduled wall latency, merged per scenario;
            # None unless the run observed (tracer enabled or observe=True)
            "events": events_block,
            "solver_phases": solver_phases,
        }
        telemetry.finalize(
            names=[s.name for s in sims],
            results=results,
            wall_seconds=wall,
            solver={
                "mode": engine.solver,
                **{
                    key: stats1[key] - solver0[key]
                    for key in (
                        "solver_steps",
                        "solver_step_budget",
                        "fast_path_solves",
                        "prog_cache_hits",
                        "prog_cache_misses",
                    )
                },
                "phases": solver_phases,
            },
            latency=latency,
            runtime=self.mode,
            n_requests=n_requests,
        )
        return FleetResult(results=results, telemetry=telemetry, wall_seconds=wall)

    # -- lockstep driver ------------------------------------------------------
    def _drive_lockstep(
        self,
        lanes: list[_Lane],
        engine: JRBAEngine,
        telemetry: FleetTelemetry,
        tracer: Tracer,
        hits0: int,
        misses0: int,
    ) -> tuple[list[float], list[float], list[float], float]:
        # per-lane barrier accounting (always on — pure arithmetic): own
        # solve share, attributed stall, and the dispatch wall-clock of the
        # rounds the lane was live in (own + stall == wall per lane)
        lane_own = [0.0] * len(lanes)
        lane_stall = [0.0] * len(lanes)
        lane_wall = [0.0] * len(lanes)
        total_dispatch = 0.0
        round_idx = 0
        while True:
            live = [ln for ln in lanes if ln.result is None]
            if not live:
                break
            # a lane's round may carry several solves (speculative OTFS
            # batches all waiting jobs); flatten every live lane's round into
            # one engine call and split the aligned results back per lane
            solves = [s for ln in live for s in ln.pending.solves]
            stats = engine.stats
            calls0, inst0, solve0 = (
                stats.batched_solves,
                stats.batched_instances,
                stats.solve_seconds,
            )
            n_requests = sum(1 for ln in live if _round_has_real_solves(ln.pending))
            t_disp0 = tracer.now() if tracer.enabled else 0.0
            t0 = time.perf_counter()
            outs = engine.solve_many(
                [s.net for s in solves],
                [s.flows for s in solves],
                capacities=[s.capacity for s in solves],
                water_filling=[s.water_filling for s in solves],
            )
            dispatch_seconds = time.perf_counter() - t0
            total_dispatch += dispatch_seconds
            per_solve = dispatch_seconds / len(solves) if solves else 0.0
            stall_round = 0.0
            off = 0
            for lane in live:
                n = len(lane.pending.solves)
                # barrier attribution: this lane's own share of the batched
                # dispatch is its solve fraction; everything else it spent
                # waiting on the other lanes' solves behind the barrier
                own = per_solve * n
                stall = dispatch_seconds - own
                lane_own[lane.idx] += own
                lane_stall[lane.idx] += stall
                lane_wall[lane.idx] += dispatch_seconds
                stall_round += stall
                if tracer.enabled and dispatch_seconds > 0.0:
                    trk = lane.sim.scheduler.trace_track
                    tracer.complete(
                        "lane/own_solve",
                        track=trk,
                        cat="barrier",
                        ts=t_disp0,
                        dur=own,
                        round=round_idx,
                        n_solves=n,
                    )
                    tracer.complete(
                        "lane/barrier_stall",
                        track=trk,
                        cat="barrier",
                        ts=t_disp0 + own,
                        dur=stall,
                        round=round_idx,
                    )
                self._advance(lane, (outs[off : off + n], own))
                off += n
            batch_calls = stats.batched_solves - calls0
            telemetry.record_round(
                RoundRecord(
                    round=round_idx,
                    n_live=len(live),
                    n_requests=n_requests,
                    n_solves=len(solves),
                    batch_calls=batch_calls,
                    batch_occupancy=(
                        (stats.batched_instances - inst0) / batch_calls
                        if batch_calls
                        else 0.0
                    ),
                    solve_seconds=stats.solve_seconds - solve0,
                    dispatch_seconds=dispatch_seconds,
                    stall_seconds=stall_round,
                    cache_hits=stats.cache_hits - hits0,
                    cache_misses=stats.cache_misses - misses0,
                )
            )
            round_idx += 1
        return lane_own, lane_stall, lane_wall, total_dispatch

    # -- async driver ---------------------------------------------------------
    def _drive_async(
        self,
        lanes: list[_Lane],
        engine: JRBAEngine,
        telemetry: FleetTelemetry,
        tracer: Tracer,
        hits0: int,
        misses0: int,
    ) -> tuple[list[float], list[float], list[float], float, dict, int]:
        lane_own = [0.0] * len(lanes)
        lane_stall = [0.0] * len(lanes)
        lane_wall = [0.0] * len(lanes)
        total_dispatch = 0.0
        # per-shape-bucket FIFO queues; a deque is dropped from the dict the
        # moment it drains so the scheduling rules only ever scan live buckets
        queues: dict[tuple, collections.deque[_QueueEntry]] = {}
        # rounds whose every part is done, waiting to resume their lane (in
        # lane order per dispatch — the one ordering decision the dispatcher
        # makes that the engine's composition independence doesn't cover)
        ready: collections.deque[_InFlight] = collections.deque()
        fired_by = {"fill": 0, "deadline": 0, "flush": 0}
        wait_hist = StreamingHistogram()
        seq = 0
        n_requests = 0
        dispatch_idx = 0

        def enqueue(lane: _Lane) -> None:
            """Fan the lane's pending round out across the bucket queues;
            empty-bucket solves (programs the engine would never see) are
            answered None on the spot. An all-empty round is ready
            immediately."""
            nonlocal seq, n_requests
            req = lane.pending
            now = time.perf_counter()
            inflight = _InFlight(
                lane=lane,
                solves=req.solves,
                results=[None] * len(req.solves),
                remaining=len(req.solves),
                enqueue_ts=now,
            )
            real = False
            for pos, s in enumerate(req.solves):
                key = s.bucket if s.bucket is not None else ("unbucketed",)
                if key == ("empty",):
                    inflight.remaining -= 1  # result stays None, zero cost
                    continue
                real = True
                queues.setdefault(key, collections.deque()).append(
                    _QueueEntry(inflight, pos, seq, now)
                )
                seq += 1
            n_requests += real
            if inflight.remaining == 0:
                ready.append(inflight)

        def drain_ready() -> None:
            """Resume every completed round's lane; a resumed lane either
            finishes or enqueues its next round (which may itself be ready —
            the loop, not recursion, absorbs arbitrarily long chains of
            empty rounds)."""
            while ready:
                inflight = ready.popleft()
                lane = inflight.lane
                wall = time.perf_counter() - inflight.enqueue_ts
                lane_wall[lane.idx] += wall
                lane_own[lane.idx] += inflight.own_seconds
                # no clamp: own <= wall by construction (every dispatch this
                # round rode ran inside its enqueue->answer window), so
                # own + stall == wall holds exactly, as under lockstep
                lane_stall[lane.idx] += wall - inflight.own_seconds
                self._advance(lane, (inflight.results, inflight.own_seconds))
                if lane.result is None:
                    enqueue(lane)

        for lane in lanes:
            if lane.result is None:
                enqueue(lane)
        drain_ready()
        while queues:
            now = time.perf_counter()
            # scheduling rules, in priority order: (1) a bucket whose head
            # has waited past the deadline fires first — oldest head wins, so
            # the latency bound is honored across buckets; (2) a full bucket
            # fires for throughput — fullest first, oldest head breaking
            # ties; (3) otherwise nothing is urgent or full, so flush the
            # oldest head rather than idle (no timers exist to wait on — the
            # driver is the only source of progress). Rule 3 is also the
            # no-starvation guarantee: a lone odd-shaped lane's bucket never
            # fills, but its head becomes the oldest once its elders drain.
            overdue = [
                k for k, q in queues.items() if now - q[0].ts >= self.deadline_s
            ]
            if overdue:
                key = min(overdue, key=lambda k: queues[k][0].seq)
                cause = "deadline"
            else:
                full = [k for k, q in queues.items() if len(q) >= self.batch_target]
                if full:
                    key = max(full, key=lambda k: (len(queues[k]), -queues[k][0].seq))
                    cause = "fill"
                else:
                    key = min(queues, key=lambda k: queues[k][0].seq)
                    cause = "flush"
            depth = sum(len(q) for q in queues.values())
            q = queues[key]
            take = [q.popleft() for _ in range(min(self.batch_target, len(q)))]
            if not q:
                del queues[key]
            fired_by[cause] += 1
            solves = [e.inflight.solves[e.pos] for e in take]
            stats = engine.stats
            calls0, inst0, solve0 = (
                stats.batched_solves,
                stats.batched_instances,
                stats.solve_seconds,
            )
            t0 = time.perf_counter()
            outs = engine.solve_many(
                [s.net for s in solves],
                [s.flows for s in solves],
                capacities=[s.capacity for s in solves],
                water_filling=[s.water_filling for s in solves],
            )
            dispatch_seconds = time.perf_counter() - t0
            total_dispatch += dispatch_seconds
            per_solve = dispatch_seconds / len(take)
            waits = []
            done: list[_InFlight] = []
            for e, out in zip(take, outs):
                inflight = e.inflight
                inflight.results[e.pos] = out
                inflight.own_seconds += per_solve
                inflight.remaining -= 1
                w = t0 - e.ts
                waits.append(w)
                wait_hist.observe(w)
                if tracer.enabled:
                    # drawn on the shared engine track, ending where the
                    # dispatch began: the wait this entry spent queued
                    tracer.complete(
                        "queue/wait",
                        track=engine.trace_track,
                        cat="queue",
                        ts=tracer.now() - dispatch_seconds - w,
                        dur=w,
                        bucket=str(key),
                        lane=inflight.lane.idx,
                        dispatch=dispatch_idx,
                    )
                if inflight.remaining == 0:
                    done.append(inflight)
            batch_calls = stats.batched_solves - calls0
            telemetry.record_dispatch(
                DispatchRecord(
                    dispatch=dispatch_idx,
                    bucket=str(key),
                    fired_by=cause,
                    n_solves=len(take),
                    # reprolint: allow[DT302] -- cardinality count of live
                    # steppers; the set is only len()'d, never iterated or
                    # keyed into, so id() reuse/order can't leak into records
                    n_lanes=len({id(e.inflight) for e in take}),
                    queue_depth=depth,
                    batch_calls=batch_calls,
                    batch_occupancy=(
                        (stats.batched_instances - inst0) / batch_calls
                        if batch_calls
                        else 0.0
                    ),
                    solve_seconds=stats.solve_seconds - solve0,
                    dispatch_seconds=dispatch_seconds,
                    queue_wait_mean=sum(waits) / len(waits),
                    queue_wait_max=max(waits),
                    cache_hits=stats.cache_hits - hits0,
                    cache_misses=stats.cache_misses - misses0,
                )
            )
            dispatch_idx += 1
            # resume completed rounds in lane order (deterministic regardless
            # of queue interleaving), each enqueueing its next round before
            # the dispatcher picks again
            for inflight in sorted(done, key=lambda i: i.lane.idx):
                ready.append(inflight)
            drain_ready()
        queue_block = {
            "dispatches": dispatch_idx,
            "fired_by": dict(fired_by),
            "batch_target": self.batch_target,
            "deadline_s": self.deadline_s,
            # per-entry enqueue->fire wait distribution (the deadline rule's
            # subject); p99 here is the dispatcher's latency SLO readout
            "wait": wait_hist.snapshot(),
        }
        return lane_own, lane_stall, lane_wall, total_dispatch, queue_block, n_requests

    @staticmethod
    def _advance(lane: _Lane, reply: tuple | None) -> None:
        """Resume a stepper until its next solve request or completion."""
        try:
            lane.pending = lane.gen.send(reply)
        except StopIteration as stop:
            lane.pending, lane.result = None, stop.value


class AsyncFleetRuntime(FleetRuntime):
    """:class:`FleetRuntime` pinned to the async continuous-batching driver,
    regardless of ``REPRO_FLEET_RUNTIME`` — for call sites that specifically
    want the queue semantics (the async benchmark section, the dispatcher
    unit tests) rather than the environment's default."""

    def __init__(
        self,
        engine: JRBAEngine | None = None,
        *,
        tracer: Tracer | None = None,
        observe: bool = False,
        batch_target: int = 32,
        deadline_s: float = 0.002,
    ) -> None:
        super().__init__(
            engine,
            mode="async",
            tracer=tracer,
            observe=observe,
            batch_target=batch_target,
            deadline_s=deadline_s,
        )
