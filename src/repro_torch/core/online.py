"""Online scheduling — paper Algorithms 3 (OTFS) and 4 (OTFA) — plus an
event-driven multi-job simulator used to reproduce the paper's evaluation
(Fig. 11) and to drive the TPU-placement examples.

Policies:
  * ``LR`` / ``BR``  — Kubernetes whole-job placement; shortest-path routing,
    per-link equal bandwidth share (recomputed whenever the flow set changes,
    TCP-fair style).
  * ``TP``           — Algo 1 partitioning; shortest path + equal share.
  * ``OTFS``         — Algo 3: per-job Algo 1 + JRBA on *residual* capacity.
  * ``OTFA``         — Algo 4: Algo 1 for new jobs, then JRBA re-run over all
    running + new flows on *full* capacity.
  * ``…+WF``         — beyond-paper water-filling top-up (DESIGN.md §4).

The simulator is host-side Python (it is a control plane); the JRBA inner
solve is the PyTorch relaxation in ``core/jrba.py`` (a CUDA kernel on the card). Scheduling-algorithm
wall-clock is measured and reported (``SimResult.sched_overhead``) — the
paper's waiting-time experiments attribute queue delay to exactly this.

Besides arrivals and completions the event loop understands a third event
kind, ``"network"``: a churn step (``core.scenarios.ChurnStep``) that drifts
link capacities and fails/recovers links or nodes mid-simulation. Inputs
arrive as one :class:`EventTrace` (arrivals + churn merged into a single
time-ordered stream). The handler invalidates exactly the state a step
touched — engine caches and speculations are pruned by *footprint* (the
touched-link mask from ``apply_churn_step`` intersected with each entry's
recorded link dependencies) rather than dropped wholesale — then re-routes
and re-solves the running jobs the step affected (OTFS: speculate-then-
repair in one batched dispatch; OTFA: the usual all-flows refresh; LR/BR/TP:
equal-share recompute), and runs a scheduling round so recoveries re-admit
queued jobs.

With a ``stall_budget`` (OTFS only) the simulator additionally runs the
**migration subsystem**: a running job that a churn step leaves stalled
(zero bandwidth, infinite span) is proactively *migrated* instead of waiting
indefinitely for a recovery that — under permanent failures — never comes.
A node failure under a job's placement triggers the first migration check
immediately; any other stall is checked once it has lasted ``stall_budget``
simulated seconds (a fourth event kind, ``"migrate"``). Each check re-runs
Algorithm 1 for the job over the *surviving* nodes (dead — fully isolated —
nodes are banned from placement), solves JRBA on the live residual, and
charges a data-transfer penalty: bytes already materialized on the dead or
degraded placement must move to the new one at current avg-bandwidth,
extending the remaining span. The migration commits only when the migrated
completion (penalty + remaining x new span) beats the projected
wait-for-recovery completion (the current check's backoff window + remaining
x pre-stall span); otherwise the job keeps its stall-and-wait behaviour and
the next check backs off exponentially — so a permanently dead placement
eventually loses to any feasible migration (the liveness property the
hypothesis suite asserts), while a transient dip keeps waiting. Migration
re-solves ride the same speculate-then-repair batched dispatch path as churn
re-solves: one ``solve_many`` per blast, records bit-identical to the
sequential reference.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Generator, Sequence

import numpy as np

from .allocation import (
    Allocation,
    allocate_greedy,
    allocate_whole_job_br,
    allocate_whole_job_lr,
    equal_share_bandwidth,
    job_span,
)
from .graph import Flow, JobGraph, NetworkGraph
from .jrba import JRBAEngine, JRBAResult, link_load_fits
from .paths import avg_path_bandwidth, path_links
from .scenarios import ChurnStep, apply_churn_step
from ..obs.metrics import NULL_METRICS
from ..obs.trace import NULL_TRACER

__all__ = [
    "EventTrace",
    "JobRecord",
    "RoundRequest",
    "SimResult",
    "SolveRequest",
    "OnlineScheduler",
    "POLICIES",
]

POLICIES = ("LR", "BR", "TP", "OTFS", "OTFA", "OTFS+WF", "OTFA+WF")

Arrival = tuple[float, "JobGraph", float]  # (time, job, total_units)


@dataclasses.dataclass
class EventTrace:
    """The full input timeline of one simulation: job arrivals plus the
    optional churn trace, merged by :meth:`OnlineScheduler.step` into one
    time-ordered event stream. A plain arrival list is still accepted
    everywhere an ``EventTrace`` is (it coerces to a churn-free trace).
    Future externally-driven event kinds extend this container rather than
    adding parallel kwargs (internally-generated events — completions,
    migration checks — never appear here)."""

    arrivals: list[Arrival]
    churn: Sequence[ChurnStep] | None = None


def _coerce_events(events: EventTrace | list[Arrival]) -> EventTrace:
    """Normalize ``run``/``step`` input to an :class:`EventTrace`."""
    if isinstance(events, EventTrace):
        return events
    return EventTrace(list(events))


@dataclasses.dataclass
class JobRecord:
    job_id: int
    job: JobGraph
    submit_time: float
    total_units: float  # stream units to process (e.g. frames)
    schedule_time: float = -1.0
    finish_time: float = -1.0
    alloc: Allocation | None = None
    flows: list[Flow] = dataclasses.field(default_factory=list)
    routes: list[list[int]] = dataclasses.field(default_factory=list)
    bandwidths: np.ndarray | None = None
    span: float = float("inf")  # current t_p
    remaining_units: float = 0.0
    last_update: float = 0.0
    initial_span: float = float("inf")
    done: bool = False
    # migration bookkeeping (OTFS with a stall_budget): when the current
    # stall began, the healthy span it interrupted (the wait-for-recovery
    # projection resumes at this rate), the time of the next scheduled
    # migration check (-1 = none pending; a "migrate" event is stale unless
    # it matches, exactly like finish_time for finish events), how many
    # checks this stall has burned (drives the exponential backoff), and how
    # many times the job actually moved
    stall_since: float = -1.0
    prestall_span: float = float("inf")
    migrate_time: float = -1.0
    migrate_checks: int = 0
    migrations: int = 0

    @property
    def scheduled(self) -> bool:
        return self.schedule_time >= 0

    @property
    def waiting_time(self) -> float:
        return self.schedule_time - self.submit_time if self.scheduled else float("inf")

    @property
    def effective_throughput(self) -> float:
        if self.finish_time <= self.schedule_time:
            return 0.0
        return self.total_units / (self.finish_time - self.schedule_time)


@dataclasses.dataclass
class SimResult:
    records: list[JobRecord]
    sched_overhead: float  # total wall-clock spent inside scheduling calls
    unfinished: int
    n_events: int = 0  # simulator events processed (arrivals + completions + churn)
    # stepper-protocol traffic: a dispatch is one RoundRequest yielded to the
    # driver; a solve is one JRBA program inside it. Sequential OTFS has
    # n_dispatches == n_solves; speculative intra-round batching collapses
    # many solves into few dispatches (the per-event latency lever).
    n_dispatches: int = 0
    n_solves: int = 0
    spec_rounds: int = 0  # scheduling rounds where speculation was consulted
    spec_accepted: int = 0  # speculative solutions reused verbatim
    spec_repaired: int = 0  # speculative solutions discarded and re-solved
    # network-churn traffic: "network" events applied, running OTFS jobs
    # re-solved because a churn step touched their footprint, re-solves whose
    # route set actually changed, and re-solves that left the job stalled
    # (unroutable until a later recovery step)
    churn_events: int = 0
    churn_resolves: int = 0
    churn_reroutes: int = 0
    churn_stalls: int = 0
    # footprint-scoped invalidation accounting: queued-job speculations that
    # outlived a churn step because the step's touched-link mask missed their
    # footprint, vs. ones the step killed; and the speculate-then-repair
    # outcome of batched churn re-solves (accepted = round-start solution
    # committed verbatim, repaired = conflict forced an exact re-solve)
    churn_spec_survived: int = 0
    churn_spec_dropped: int = 0
    churn_spec_accepted: int = 0
    churn_spec_repaired: int = 0
    # dispatch-collapse accounting on WIDE churn steps (>= 4 affected running
    # jobs): total affected jobs re-solved across wide steps, and the
    # RoundRequest dispatches those re-solves actually cost. Sequential
    # re-solving pins the ratio at 1.0; batched speculation pushes it toward
    # len(affected) per step.
    churn_wide_jobs: int = 0
    churn_wide_dispatches: int = 0
    # migration traffic (zero unless the scheduler was built with a
    # stall_budget): candidate evaluations, commits, decision rejections
    # (waiting projected cheaper), infeasible attempts (no surviving
    # placement or unroutable flows), non-pinned tasks actually relocated,
    # total data-transfer penalty charged (simulated seconds), and the
    # speculate-then-repair outcome of batched migration re-solves
    migration_checks: int = 0
    migrations: int = 0
    migration_rejected: int = 0
    migration_infeasible: int = 0
    migration_moved_tasks: int = 0
    migration_penalty_seconds: float = 0.0
    migration_spec_accepted: int = 0
    migration_spec_repaired: int = 0

    @property
    def migration_commit_rate(self) -> float:
        """Committed moves per migration check (0.0 when migration never
        ran)."""
        return self.migrations / self.migration_checks if self.migration_checks else 0.0

    @property
    def spec_accept_rate(self) -> float:
        tried = self.spec_accepted + self.spec_repaired
        return self.spec_accepted / tried if tried else 0.0

    @property
    def churn_spec_accept_rate(self) -> float:
        tried = self.churn_spec_accepted + self.churn_spec_repaired
        return self.churn_spec_accepted / tried if tried else 0.0

    @property
    def churn_dispatch_collapse(self) -> float:
        """Jobs re-solved per dispatch on wide churn steps (>= 1; higher is
        better; 0.0 when no wide step occurred)."""
        if not self.churn_wide_dispatches:
            return 0.0
        return self.churn_wide_jobs / self.churn_wide_dispatches

    @property
    def n_scheduled(self) -> int:
        return sum(1 for r in self.records if r.scheduled)

    @property
    def avg_throughput(self) -> float:
        done = [r.effective_throughput for r in self.records if r.finish_time > 0]
        return float(np.mean(done)) if done else 0.0

    @property
    def avg_waiting_time(self) -> float:
        """Queue delay + amortized scheduling wall-clock (the paper's metric
        is dominated by the latter when resources are plentiful)."""
        sched = [r for r in self.records if r.scheduled]
        if not sched:
            return float("inf")
        queue = float(np.mean([r.waiting_time for r in sched]))
        return queue + self.sched_overhead / len(sched)

    @property
    def avg_scheduled_span(self) -> float:
        s = [r.initial_span for r in self.records if r.scheduled]
        return float(np.mean(s)) if s else float("inf")


@dataclasses.dataclass
class SolveRequest:
    """One JRBA program the simulation needs solved.

    ``bucket`` is the engine's dispatch-grouping key for this program
    (:meth:`JRBAEngine.bucket_key`), stamped by the stepper at yield time so
    an async driver can queue the request under its shape bucket without
    touching the engine or the program. ``("empty",)`` marks a program the
    solver never sees (the driver may answer it ``None`` from any dispatch);
    ``None`` means the stepper predates bucketing and the driver must group
    however it likes."""

    net: NetworkGraph
    flows: list[Flow]
    capacity: np.ndarray  # residual (OTFS) or full (OTFA) link capacity
    water_filling: bool = False
    bucket: tuple | None = None


@dataclasses.dataclass
class RoundRequest:
    """The pending solves of one suspension point of
    :meth:`OnlineScheduler.step`.

    The stepper suspends wherever the event loop needs JRBA solutions and
    yields one of these; the driver answers via
    ``gen.send((results, seconds))`` where ``results`` aligns with ``solves``
    (``None`` entries for empty programs) and ``seconds`` is the solver
    wall-clock to attribute to this simulation's ``sched_overhead``.

    Most suspension points carry a single solve (an OTFA refresh, a
    sequential-OTFS admission, a repair re-solve); a speculative OTFS round
    carries one solve per waiting job, all against the same residual
    snapshot. :meth:`OnlineScheduler.run` answers requests inline through the
    scheduler's own engine (``solve`` for singletons, ``solve_many``
    otherwise); ``repro_torch.fleet.FleetRuntime`` instead flattens every live
    simulation's round into a single batched :meth:`JRBAEngine.solve_many`
    call.

    The stepper does NOT care how the driver groups the work: the async
    fleet runtime splits one round's solves across shape-bucket queues and
    answers only once every part has completed — possibly from different
    ``solve_many`` dispatches, completed in any order, with ``seconds``
    summing this round's share of each dispatch it rode. The reply contract
    is only that ``results`` aligns index-for-index with ``solves`` and that
    each result is what :meth:`JRBAEngine.solve` would return for that
    request — the engine's per-lane outputs are composition-independent, so
    any grouping yields bit-identical records."""

    solves: list[SolveRequest]


RoundReply = tuple[list[JRBAResult | None], float]  # (solutions, wall-clock)


@dataclasses.dataclass
class _Speculation:
    """Per-job artifact of a speculative OTFS round, consumed by the repair
    pass: the allocation (with its memory effect, so repair can replay it
    without re-running Algorithm 1) and the solution obtained against the
    round-start residual snapshot."""

    alloc: Allocation
    flows: list[Flow]
    mem_before: np.ndarray  # net.mem_avail when this job's allocation ran
    mem_after: np.ndarray  # net.mem_avail after it (== before if infeasible)
    result: JRBAResult | None = None
    capacity0: np.ndarray | None = None  # residual snapshot it solved against
    # link ids whose capacity the allocation read through avg_path_bandwidth
    # (the pinned-path trace): together with result.candidate_links this is
    # the speculation's full churn footprint — a capacity change strictly
    # outside it provably cannot alter either the Algorithm-1 replay or the
    # recorded JRBA solution
    alloc_footprint: frozenset[int] = frozenset()

    def footprint_hit(self, touched: np.ndarray) -> bool:
        """Does a churn step's touched-link mask intersect this speculation's
        recorded dependency footprint?"""
        if any(touched[l] for l in self.alloc_footprint):
            return True
        return self.result is not None and bool(
            np.any(self.result.candidate_links & touched)
        )


def _same_flows(a: list[Flow], b: list[Flow]) -> bool:
    """Value equality on the fields that shape a JRBA program (job_id is
    constant within one job's candidates)."""
    return len(a) == len(b) and all(
        (fa.src, fa.dst, fa.volume, fa.edge) == (fb.src, fb.dst, fb.volume, fb.edge)
        for fa, fb in zip(a, b)
    )


class OnlineScheduler:
    """Event-driven simulator: arrivals and completions trigger scheduling
    rounds (the paper schedules periodically; event-driven rounds are the
    zero-period limit and keep the simulation deterministic)."""

    def __init__(
        self,
        net: NetworkGraph,
        policy: str = "OTFA",
        *,
        k_paths: int = 4,
        jrba_iters: int = 300,
        max_acceptable_span: float = 1e4,
        stall_budget: float | None = None,
        engine: JRBAEngine | None = None,
        speculate: bool = True,
        scoped_churn: bool = True,
        solver: str = "auto",
        device: str = "cuda",
        tracer=None,
        metrics=None,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.net = net
        self.policy = policy
        self.base = policy.split("+")[0]
        self.max_acceptable_span = max_acceptable_span
        self.water_fill = policy.endswith("+WF")
        # migration SLO (OTFS only): a running job stalled by churn is
        # considered for proactive migration — a node failure under its
        # placement triggers the first check immediately, any other stall is
        # checked after stall_budget simulated seconds, and rejected checks
        # back off exponentially (each expired window doubles the projected
        # further wait for recovery, so a permanently dead placement
        # eventually loses to any feasible migration). None disables
        # migration entirely — stall-and-wait, bit-identical to before.
        if stall_budget is not None:
            if not (np.isfinite(stall_budget) and stall_budget > 0):
                raise ValueError("stall_budget must be a positive finite duration")
            if self.base != "OTFS":
                raise ValueError(
                    "migration (stall_budget=) requires an OTFS policy; "
                    f"got {policy!r}"
                )
        self.stall_budget = stall_budget
        # OTFS only: solve all waiting jobs of a round in one batched call
        # against the round-start residual, then repair conflicts per job.
        # Admission outcomes are exactly the sequential ones (see
        # schedule_round); False forces one solve per waiting job.
        self.speculate = speculate
        # footprint-scoped churn invalidation: a churn step prunes only the
        # speculations and engine cache entries whose recorded link footprint
        # the step's touched mask intersects (and prunes nothing on pure
        # capacity drift outside every footprint). False restores the
        # reference behaviour — every effective step drops all speculations
        # and any topology change fully invalidates the engine — which is
        # what the scoped path must reproduce record-for-record.
        self.scoped_churn = scoped_churn
        # shared engines keep compiled shape buckets + path caches warm across
        # schedulers (a fleet of simulations pays compile cost once); a passed
        # engine is authoritative, so k_paths/jrba_iters (and the solver
        # formulation and `device` — both only apply when the engine is built
        # here) re-derive from it rather than silently diverging
        self.engine = engine or JRBAEngine(
            k=k_paths, n_iters=jrba_iters, solver=solver, device=device
        )
        self.k_paths = self.engine.k
        self.jrba_iters = self.engine.n_iters
        # observability (repro_torch.obs): a span Tracer and a MetricsRegistry,
        # defaulting to the shared null objects so the event loop pays one
        # attribute load + branch when tracing is off. The fleet runtime
        # re-points these (and trace_track, the tracer timeline this
        # scheduler's spans land on — one track per lane) before running.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_METRICS
        self.trace_track = "sim"

    # -- per-policy allocation ----------------------------------------------
    def _allocate(self, job: JobGraph, job_id: int) -> tuple[Allocation, list[Flow]]:
        if self.base == "LR":
            return allocate_whole_job_lr(self.net, job, job_id=job_id)
        if self.base == "BR":
            return allocate_whole_job_br(self.net, job, job_id=job_id)
        if self.stall_budget is None:
            return allocate_greedy(self.net, job, job_id=job_id)  # TP / OTFS / OTFA
        # migration enabled: never place work on a dead (fully isolated)
        # node. Algorithm 1's bandwidth terms already steer comm-connected
        # tasks away from dead hardware (avg bandwidth 0 -> t_comm inf), but
        # a task with no placed predecessor sees t_comm 0 everywhere and
        # could seed a placement on a dead node; banning through the memory
        # check closes that hole without touching the allocator. Dead nodes
        # are never debited, so restoring their entries afterwards is exact.
        net = self.net
        dead = [n for n in range(net.n_nodes) if not net.neighbors(n)]
        if not dead:
            return allocate_greedy(net, job, job_id=job_id)
        saved = net.mem_avail[dead].copy()
        net.mem_avail[dead] = -np.inf
        try:
            return allocate_greedy(net, job, job_id=job_id)
        finally:
            net.mem_avail[dead] = saved

    def _allocate_traced(
        self, job: JobGraph, job_id: int
    ) -> tuple[Allocation, list[Flow], frozenset[int]]:
        """Run :meth:`_allocate` with the avg-bandwidth trace hook armed,
        returning the link ids whose live capacity the allocator read (the
        pinned shortest-path links of every ``avg_path_bandwidth`` query it
        made). That set is the allocation's exact capacity dependency: churn
        strictly outside it leaves a replayed allocation bit-identical."""
        trace: set[int] = set()
        self.net._avg_bw_trace = trace
        try:
            alloc, flows = self._allocate(job, job_id)
        finally:
            self.net._avg_bw_trace = None
        return alloc, flows, frozenset(trace)

    # -- simulation -----------------------------------------------------------
    def run(
        self,
        events: EventTrace | list[Arrival],
        *,
        max_time: float = 1e6,
    ) -> SimResult:
        """Drive :meth:`step` to completion, answering every
        :class:`RoundRequest` inline through the scheduler's own engine.
        Singleton rounds go through the scalar ``solve`` path — byte-for-byte
        the pre-stepper behaviour — while speculative multi-solve rounds go
        through one ``solve_many`` dispatch (the intra-round batching win).

        ``events`` is an :class:`EventTrace` (or a bare arrival list, which
        coerces to a churn-free trace)."""
        stepper = self.step(_coerce_events(events), max_time=max_time)
        try:
            req = next(stepper)
            while True:
                t0 = time.perf_counter()
                if len(req.solves) == 1:
                    s = req.solves[0]
                    results = [
                        self.engine.solve(
                            s.net,
                            s.flows,
                            capacity=s.capacity,
                            water_filling=s.water_filling,
                        )
                    ]
                else:
                    results = self.engine.solve_many(
                        [s.net for s in req.solves],
                        [s.flows for s in req.solves],
                        capacities=[s.capacity for s in req.solves],
                        water_filling=[s.water_filling for s in req.solves],
                    )
                req = stepper.send((results, time.perf_counter() - t0))
        except StopIteration as stop:
            return stop.value

    def step(
        self,
        events: EventTrace | list[Arrival],
        *,
        max_time: float = 1e6,
    ) -> Generator[RoundRequest, RoundReply, SimResult]:
        """Resumable event loop: a generator that yields a
        :class:`RoundRequest` at every point the simulation needs JRBA
        solutions and expects ``(list[JRBAResult | None], solve_seconds)``
        back via ``send``. Returns the :class:`SimResult` as the generator's
        value (``StopIteration.value``). This is the unit the fleet runtime
        co-schedules: N steppers advanced in lockstep flatten their rounds'
        solves through one batched solver call.

        ``events`` is an :class:`EventTrace`; its ``churn`` is a churn trace
        (see ``core.scenarios``): each :class:`ChurnStep` becomes a third
        event kind ``"network"`` that mutates the network in place, prunes
        candidate-path caches and speculations by footprint (or wholesale
        when a recovery adds links, or under ``scoped_churn=False``),
        re-routes + re-solves affected running jobs, and runs a scheduling
        round (recoveries re-admit jobs the degraded network rejected). The
        topology is restored to its construction state first, so re-running
        the same (net, trace) pair is reproducible. A bare arrival list
        coerces to a churn-free trace.

        With a ``stall_budget``, stalled jobs additionally generate
        ``"migrate"`` events — the proactive-migration checks described in
        the module docstring."""
        trace = _coerce_events(events)
        arrivals = trace.arrivals
        net = self.net
        churn_steps = list(trace.churn or [])
        if churn_steps:
            net.restore_topology()
        net.reset_residual()
        records = [
            JobRecord(i, job, t, units, remaining_units=units)
            for i, (t, job, units) in enumerate(sorted(arrivals, key=lambda a: a[0]))
        ]
        q_wait: list[JobRecord] = []
        q_run: list[JobRecord] = []
        events: list[tuple[float, int, str, int]] = []  # (time, seq, kind, job/step id)
        seq = 0
        for r in records:
            heapq.heappush(events, (r.submit_time, seq, "arrive", r.job_id))
            seq += 1
        for i, cs in enumerate(churn_steps):
            heapq.heappush(events, (cs.time, seq, "network", i))
            seq += 1
        # observability locals: bound at first next(), i.e. after the fleet
        # runtime has re-pointed tracer/metrics/trace_track on this scheduler
        tracer = self.tracer
        track = self.trace_track
        metrics = self.metrics
        observing = tracer.enabled or metrics.enabled
        arrive_wall: dict[int, float] = {}  # job_id -> wall clock at arrival event
        sched_overhead = 0.0
        n_dispatches = n_solves = 0
        spec_rounds = spec_accepted = spec_repaired = 0
        churn_events = churn_resolves = churn_reroutes = churn_stalls = 0
        churn_spec_survived = churn_spec_dropped = 0
        churn_spec_accepted = churn_spec_repaired = 0
        churn_wide_jobs = churn_wide_dispatches = 0
        migration_checks = migrations = 0
        migration_rejected = migration_infeasible = 0
        migration_moved_tasks = 0
        migration_penalty_seconds = 0.0
        migration_spec_accepted = migration_spec_repaired = 0
        migrate_on = self.stall_budget is not None  # __init__ pinned base=OTFS

        def solve_round(reqs: list[SolveRequest]):
            """Sub-generator wrapping every driver suspension: yields one
            :class:`RoundRequest`, books the protocol counters and the solver
            wall-clock, and returns the aligned result list."""
            nonlocal sched_overhead, n_dispatches, n_solves
            for s in reqs:
                s.bucket = self.engine.bucket_key(s.net, s.flows)
            results, dt = yield RoundRequest(reqs)
            sched_overhead += dt
            n_dispatches += 1
            n_solves += len(reqs)
            if tracer.enabled:
                # dt is the wall-clock the driver attributed to this dispatch
                # (a fleet driver reports this lane's share of the batched
                # call), drawn as an interval ending now
                tracer.complete(
                    "sched/solve",
                    track=track,
                    cat="solve",
                    ts=tracer.now() - dt,
                    dur=dt,
                    n_solves=len(reqs),
                )
            return results

        def advance_running(now: float) -> None:
            for r in q_run:
                if r.span > 0 and np.isfinite(r.span):
                    r.remaining_units -= (now - r.last_update) / r.span
                r.last_update = now

        def set_finish_event(r: JobRecord, now: float) -> None:
            nonlocal seq
            if r.span <= 0 or not np.isfinite(r.span):
                # no progress is possible at this span: any already-queued
                # finish event is stale, so finish_time must stop matching it
                # (a churn outage would otherwise let the pre-outage event
                # fire and complete the job at full speed)
                r.finish_time = float("inf")
                return
            r.finish_time = now + max(r.remaining_units, 0.0) * r.span
            heapq.heappush(events, (r.finish_time, seq, "finish", r.job_id))
            seq += 1

        def rebuild_residual_from_running(
            exclude: list[JobRecord] | None = None,
        ) -> None:
            net.residual = net.capacity.copy()
            for r in q_run:
                if r.bandwidths is None or (exclude is not None and r in exclude):
                    continue
                for route, b in zip(r.routes, r.bandwidths):
                    for l in path_links(net, route):
                        net.residual[l] = max(net.residual[l] - b, 0.0)

        def schedule_migrate(r: JobRecord, now: float) -> None:
            """Queue this job's next migration check. Check k fires
            ``stall_budget * 2**k`` after the previous one — the exponential
            backoff that both bounds the event count for an unmigratable job
            (log, not linear, in the horizon) and makes the wait-for-recovery
            projection grow until any feasible migration wins."""
            nonlocal seq
            r.migrate_time = now + self.stall_budget * (2.0**r.migrate_checks)
            heapq.heappush(events, (r.migrate_time, seq, "migrate", r.job_id))
            seq += 1

        def commit_reroute(r: JobRecord, res: JRBAResult, now: float) -> None:
            """Commit one churn re-solve: accept the new routes/bandwidths if
            the span clears the admission bar, else stall the job (zero
            bandwidth, infinite span, memory held) until a later recovery or
            finish event re-solves it — or, with a stall_budget, until a
            migration check moves it off the dead placement."""
            nonlocal churn_reroutes, churn_stalls
            old_routes = r.routes
            old_span = r.span
            span = job_span(net, r.alloc, r.flows, res.bandwidth)
            if np.isfinite(span) and span <= self.max_acceptable_span:
                r.bandwidths, r.routes, r.span = res.bandwidth, res.routes, span
                if r.routes != old_routes:
                    churn_reroutes += 1
                net.residual = np.maximum(net.residual - res.link_load, 0.0)
                # recovered on its own placement: the SLO clock stops and any
                # pending migration check goes stale (migrate_time mismatch)
                r.stall_since = -1.0
                r.migrate_time = -1.0
                r.migrate_checks = 0
                set_finish_event(r, now)
            else:
                # same acceptability bar as admission: committing a
                # degenerate span would pin near-zero progress (and its
                # link claim) past the simulation horizon
                churn_stalls += 1
                r.bandwidths = np.zeros(len(r.flows))
                r.routes = res.routes
                r.span = float("inf")
                if np.isfinite(old_span):
                    # fresh stall: remember the healthy span (wait-for-
                    # recovery projects resuming at this rate) and start the
                    # SLO clock. A re-stall of an already-stalled job keeps
                    # the original clock and its pending check.
                    r.prestall_span = old_span
                    r.stall_since = now
                    r.migrate_checks = 0
                    if migrate_on:
                        schedule_migrate(r, now)
                set_finish_event(r, now)  # invalidates any queued event

        def churn_reroute(affected: list[JobRecord], now: float):
            """OTFS response to a churn step: rebuild the residual from the
            unaffected running jobs' committed loads on the NEW capacities,
            then re-solve each affected job on that residual in admission
            order (earliest ``schedule_time`` first — deterministic, and the
            job that has held its allocation longest keeps first claim). A
            re-solve re-routes over fresh candidate paths (the engine's path
            cache was pruned if the topology changed) and re-commits the new
            link load; a job whose flows can no longer be usefully routed
            — endpoints partitioned by failures, or only a degenerate near-
            zero-bandwidth route left on an exhausted residual — stalls with
            zero bandwidth and an infinite span, holding its memory but no
            links, until a later recovery or finish event re-solves it.

            With ``speculate`` a multi-job step collapses the N sequential
            dispatches into (ideally) one: every affected job is solved
            against the step-start residual snapshot in a single batched
            dispatch, then committed in admission order with the same accept
            check the scheduling round uses — a solution is kept verbatim iff
            the live residual still clamp-equals its snapshot on the
            program's candidate links (the solver's exact dependency set) and
            its link load fits. A conflicting job re-solves on the live
            residual, riding one dispatch with a re-speculation of every
            remaining stale job, so conflicts degrade gracefully instead of
            going sequential. The committed records are provably the
            sequential ones."""
            nonlocal churn_resolves, churn_spec_accepted, churn_spec_repaired
            nonlocal churn_wide_jobs, churn_wide_dispatches
            rebuild_residual_from_running(exclude=affected)
            order = sorted(affected, key=lambda j: (j.schedule_time, j.job_id))
            wide = len(order) >= 4
            dispatches0 = n_dispatches
            if not (self.speculate and self.base == "OTFS" and len(order) > 1):
                # sequential reference path: one dispatch per affected job
                for r in order:
                    (res,) = yield from solve_round(
                        [SolveRequest(net, r.flows, net.residual.copy(), self.water_fill)]
                    )
                    churn_resolves += 1
                    commit_reroute(r, res, now)
                if wide:
                    churn_wide_jobs += len(order)
                    churn_wide_dispatches += n_dispatches - dispatches0
                return
            cap0 = net.residual.copy()
            results = yield from solve_round(
                [SolveRequest(net, r.flows, cap0, self.water_fill) for r in order]
            )
            spec: dict[int, tuple[JRBAResult, np.ndarray]] = {
                r.job_id: (res, cap0) for r, res in zip(order, results)
            }

            def entry_exact(entry: tuple[JRBAResult, np.ndarray]) -> bool:
                # the spec_exact clamp-equality criterion on the churn
                # snapshots: build_program clamps capacity at 1e-9, so a
                # residual that clamp-equals the snapshot on the candidate
                # links yields a bit-identical program (hence a bit-identical
                # solution). No link_load_fits guard here — the sequential
                # churn path commits its re-solves unconditionally (clamped
                # residual subtraction), so an unconverged solution that
                # slightly overcommits would be re-produced verbatim by the
                # repair solve and committed anyway; the guard would only
                # burn a dispatch to arrive at the same record.
                res, cap = entry
                mask = res.candidate_links
                return bool(
                    np.array_equal(
                        np.maximum(net.residual[mask], 1e-9),
                        np.maximum(cap[mask], 1e-9),
                    )
                )

            for i, r in enumerate(order):
                res = spec[r.job_id][0]
                if entry_exact(spec[r.job_id]):
                    churn_spec_accepted += 1
                    tracer.instant("churn/spec_accept", track=track, cat="churn", job=r.job_id)
                else:
                    # conflict: an earlier commit moved the residual on this
                    # job's candidate links. Re-solve it on the live residual
                    # and re-speculate EVERY remaining stale job against the
                    # same snapshot in the one dispatch — churn re-solves
                    # always commit (unlike admissions), so the overlap
                    # filter schedule_round uses would only delay the
                    # inevitable re-solve here.
                    capR = net.residual.copy()
                    rest = [
                        rr for rr in order[i + 1 :] if not entry_exact(spec[rr.job_id])
                    ]
                    repair = yield from solve_round(
                        [SolveRequest(net, r.flows, capR, self.water_fill)]
                        + [SolveRequest(net, rr.flows, capR, self.water_fill) for rr in rest]
                    )
                    res = repair[0]
                    for rr, rr_res in zip(rest, repair[1:]):
                        spec[rr.job_id] = (rr_res, capR)
                    churn_spec_repaired += 1
                    tracer.instant("churn/spec_repair", track=track, cat="churn", job=r.job_id)
                churn_resolves += 1
                commit_reroute(r, res, now)
            if wide:
                churn_wide_jobs += len(order)
                churn_wide_dispatches += n_dispatches - dispatches0

        def trial_alloc(r: JobRecord):
            """Re-run Algorithm 1 for a stalled job as if its current
            placement were released: credit the old allocation's memory back
            (pinned tasks skipped, symmetric with admission/finish), allocate
            over the survivors (``_allocate`` bans dead nodes when migration
            is on), and return ``(alloc, flows, mem_after)`` where
            ``mem_after`` is the memory state a commit would install.
            ``net.mem_avail`` is restored before returning — the trial has no
            side effect until :func:`commit_migration` replays it."""
            mem_entry = net.mem_avail.copy()
            for i, task in enumerate(r.job.tasks):
                if task.pinned_node is None:
                    net.mem_avail[int(r.alloc.assignment[i])] += task.mem
            alloc, flows, _footprint = self._allocate_traced(r.job, r.job_id)
            mem_after = net.mem_avail.copy() if alloc.feasible else None
            net.mem_avail = mem_entry
            return alloc, flows, mem_after

        def transfer_penalty(r: JobRecord, new_assignment: np.ndarray) -> float:
            """Seconds to move the bytes already materialized on the old
            placement to the new one at current avg-bandwidth. For each job
            edge (u, v, vol) whose consumer task v relocates, the stream
            state absorbed so far is ``done_units * vol``; it moves from v's
            old node — or, when that node can't reach the destination (dead,
            or trapped in a partitioned island), is re-streamed by producer u
            from its new home, the surviving upstream copy — over the current
            topology's average-bandwidth path. The upstream chain bottoms out
            at the pinned source, which a feasible new placement can always
            reach (Algorithm 1 just routed from it), so a partition strands
            data, never the job. Transfers run concurrently, so the penalty
            is the slowest single transfer; a destination unreachable even
            from the upstream copy makes the migration infeasible (``inf``)."""
            done = max(r.total_units - max(r.remaining_units, 0.0), 0.0)
            if done <= 0.0:
                return 0.0
            old = r.alloc.assignment
            worst = 0.0
            for u, v, vol in r.job.edges:
                src, dst = int(old[v]), int(new_assignment[v])
                if src == dst or vol <= 0.0:
                    continue
                bw = avg_path_bandwidth(net, src, dst) if net.neighbors(src) else 0.0
                if bw <= 0.0:  # unreachable old copy: upstream re-streams
                    src = int(new_assignment[u])
                    if src == dst:
                        continue  # colocated with the surviving copy — free
                    bw = avg_path_bandwidth(net, src, dst)
                    if bw <= 0.0:
                        return float("inf")
                if np.isfinite(bw):
                    worst = max(worst, done * vol / bw)
            return worst

        def mark_unmigratable(r: JobRecord, now: float) -> None:
            """No surviving placement (or unroutable/unreachable): the job
            keeps stalling; back off and re-check — capacity freed by later
            finishes or churn can make a future check feasible."""
            nonlocal migration_infeasible
            migration_infeasible += 1
            r.migrate_checks += 1
            schedule_migrate(r, now)
            tracer.instant("migrate/infeasible", track=track, cat="migrate", job=r.job_id)

        def commit_migration(r, alloc, flows, mem_after, res, now: float) -> bool:
            """The migrate-or-wait decision, then the commit. Migrating
            projects ``penalty + remaining * new_span`` seconds to
            completion; waiting projects riding out the current backoff
            window and then resuming at the pre-stall span. Commit iff
            migrating wins; otherwise keep stall-and-wait and let the next
            (doubled) window re-ask. Returns True iff the job moved."""
            nonlocal migrations, migration_rejected
            nonlocal migration_moved_tasks, migration_penalty_seconds
            bandwidths = np.zeros(0) if res is None else res.bandwidth
            span = job_span(net, alloc, flows, bandwidths)
            penalty = transfer_penalty(r, alloc.assignment)
            if (
                not np.isfinite(span)
                or span > self.max_acceptable_span
                or not np.isfinite(penalty)
            ):
                mark_unmigratable(r, now)
                return False
            rem = max(r.remaining_units, 0.0)
            window = self.stall_budget * (2.0**r.migrate_checks)
            migrated_proj = penalty + rem * span
            wait_proj = window + (rem * r.prestall_span if rem > 0.0 else 0.0)
            if migrated_proj > wait_proj:
                migration_rejected += 1
                r.migrate_checks += 1
                schedule_migrate(r, now)
                tracer.instant(
                    "migrate/reject",
                    track=track,
                    cat="migrate",
                    job=r.job_id,
                    migrated_proj=migrated_proj,
                    wait_proj=wait_proj,
                )
                return False
            moved = sum(
                1
                for i, task in enumerate(r.job.tasks)
                if task.pinned_node is None
                and int(alloc.assignment[i]) != int(r.alloc.assignment[i])
            )
            net.mem_avail = mem_after.copy()
            r.alloc, r.flows = alloc, flows
            r.routes = [] if res is None else res.routes
            r.bandwidths = bandwidths
            r.span = span
            if res is not None:
                net.residual = np.maximum(net.residual - res.link_load, 0.0)
            if penalty > 0.0 and span > 0.0:
                # the transfer extends the remaining span: express it as
                # extra stream units at the new rate so advance_running and
                # the finish event stay consistent
                # (finish = now + penalty + remaining * span)
                r.remaining_units += penalty / span
            r.stall_since = -1.0
            r.migrate_time = -1.0
            r.migrate_checks = 0
            r.migrations += 1
            migrations += 1
            migration_moved_tasks += moved
            migration_penalty_seconds += penalty
            tracer.instant(
                "migrate/commit",
                track=track,
                cat="migrate",
                job=r.job_id,
                moved=moved,
                penalty=penalty,
            )
            set_finish_event(r, now)
            return True

        def migration_round(cands: list[JobRecord], now: float):
            """Evaluate migration for stalled candidates in admission order,
            riding the same speculate-then-repair batched dispatch shape as
            :func:`churn_reroute`: every candidate's Algorithm-1 re-run is
            trialled against the round-start memory and its JRBA program
            solved against the round-start residual in ONE batched dispatch;
            commits then proceed in admission order, keeping a speculative
            entry verbatim iff the live memory still equals its snapshot
            (the Algorithm-1 replay is deterministic in it) and the live
            residual clamp-equals the snapshot on the solution's candidate
            links. A conflicted candidate re-trials on the live state,
            riding one dispatch with a re-speculation of every remaining
            stale candidate. ``speculate=False`` forces the sequential
            reference path — one trial + one dispatch per candidate — whose
            records the batched path provably reproduces."""
            nonlocal migration_checks, migration_spec_accepted, migration_spec_repaired
            order = sorted(cands, key=lambda j: (j.schedule_time, j.job_id))
            if not order:
                return
            migration_checks += len(order)
            # stalled jobs hold no links, but make the residual authoritative
            # before pricing the survivors' spare capacity
            rebuild_residual_from_running()
            if not (self.speculate and len(order) > 1):
                for r in order:
                    alloc, flows, mem_after = trial_alloc(r)
                    if not alloc.feasible:
                        mark_unmigratable(r, now)
                        continue
                    res = None
                    if flows:
                        (res,) = yield from solve_round(
                            [SolveRequest(net, flows, net.residual.copy(), self.water_fill)]
                        )
                    commit_migration(r, alloc, flows, mem_after, res, now)
                return
            mem0 = net.mem_avail.copy()
            cap0 = net.residual.copy()
            # per-candidate speculative entry:
            # [alloc, flows, mem_after, result, capacity0, mem_before]
            spec: dict[int, list] = {}
            for r in order:
                net.mem_avail = mem0.copy()
                alloc, flows, mem_after = trial_alloc(r)
                spec[r.job_id] = [alloc, flows, mem_after, None, cap0, mem0]
            net.mem_avail = mem0
            live = [r for r in order if spec[r.job_id][0].feasible and spec[r.job_id][1]]
            if live:
                results = yield from solve_round(
                    [
                        SolveRequest(net, spec[r.job_id][1], cap0, self.water_fill)
                        for r in live
                    ]
                )
                for r, res in zip(live, results):
                    spec[r.job_id][3] = res

            def entry_exact(e: list) -> bool:
                # same two-part exactness check the admission repair pass
                # uses, with the memory half made explicit: the trial ran
                # against e[5], so an untouched mem_avail replays Algorithm 1
                # bit-identically, and a residual that clamp-equals the
                # snapshot on the solution's candidate links replays the
                # solve bit-identically (build_program clamps at 1e-9)
                if not np.array_equal(net.mem_avail, e[5]):
                    return False
                if e[3] is None:
                    return e[0].feasible is False or not e[1]
                mask = e[3].candidate_links
                return bool(
                    np.array_equal(
                        np.maximum(net.residual[mask], 1e-9),
                        np.maximum(e[4][mask], 1e-9),
                    )
                )

            for i, r in enumerate(order):
                e = spec[r.job_id]
                if entry_exact(e):
                    migration_spec_accepted += 1
                    tracer.instant(
                        "migrate/spec_accept", track=track, cat="migrate", job=r.job_id
                    )
                else:
                    # conflict: an earlier commit moved the memory state or
                    # the residual under this candidate. Re-trial on the live
                    # state, and re-speculate every remaining stale candidate
                    # in the same dispatch so one conflict doesn't degrade
                    # the round to sequential.
                    migration_spec_repaired += 1
                    tracer.instant(
                        "migrate/spec_repair", track=track, cat="migrate", job=r.job_id
                    )
                    memR = net.mem_avail.copy()
                    capR = net.residual.copy()
                    stale = [r] + [
                        rr for rr in order[i + 1 :] if not entry_exact(spec[rr.job_id])
                    ]
                    for rr in stale:
                        net.mem_avail = memR.copy()
                        alloc, flows, mem_after = trial_alloc(rr)
                        spec[rr.job_id][:] = [alloc, flows, mem_after, None, capR, memR]
                    net.mem_avail = memR
                    batch = [
                        rr
                        for rr in stale
                        if spec[rr.job_id][0].feasible and spec[rr.job_id][1]
                    ]
                    if batch:
                        results = yield from solve_round(
                            [
                                SolveRequest(
                                    net, spec[rr.job_id][1], capR, self.water_fill
                                )
                                for rr in batch
                            ]
                        )
                        for rr, rres in zip(batch, results):
                            spec[rr.job_id][3] = rres
                    e = spec[r.job_id]
                alloc, flows, mem_after, res = e[0], e[1], e[2], e[3]
                if not alloc.feasible:
                    mark_unmigratable(r, now)
                    continue
                commit_migration(r, alloc, flows, mem_after, res, now)

        def refresh_equal_share(now: float) -> None:
            """LR/BR/TP: global equal-share refresh of all active flows."""
            offsets, all_flows = [], []
            for r in q_run:
                offsets.append(len(all_flows))
                all_flows.extend(r.flows)
            if q_run:
                routes, bands = (
                    equal_share_bandwidth(net, all_flows) if all_flows else ([], np.zeros(0))
                )
                for r, off in zip(q_run, offsets):
                    r.routes = routes[off : off + len(r.flows)]
                    r.bandwidths = bands[off : off + len(r.flows)]
                    r.span = job_span(net, r.alloc, r.flows, r.bandwidths)
                    set_finish_event(r, now)

        def refresh_otfa(now: float):
            """OTFA (Algo 4 lines 13-15): JRBA over all flows, full capacity.
            A sub-generator: the solve itself is yielded to the driver."""
            all_flows = [f for r in q_run for f in r.flows]
            if not all_flows:
                for r in q_run:
                    if not np.isfinite(r.finish_time) or r.finish_time < 0:
                        r.span = job_span(net, r.alloc, r.flows, np.zeros(0))
                        set_finish_event(r, now)
                return
            (res,) = yield from solve_round(
                [SolveRequest(net, all_flows, net.capacity, self.water_fill)]
            )
            # ``res.flows`` is the order-preserving subsequence of
            # ``all_flows`` that survived the solver's colocated/zero-volume
            # filter, so results align positionally — each record owns the
            # contiguous slice its flows occupied in ``all_flows``. (An
            # ``id()``-keyed lookup here would be reuse-hazardous and
            # order-opaque — the determinism lint forbids it.)
            per_flow: list[tuple[float, list[int]]] = [(0.0, [])] * len(all_flows)
            j = 0
            for i, f in enumerate(all_flows):
                if j < len(res.flows) and res.flows[j] is f:
                    per_flow[i] = (res.bandwidth[j], res.routes[j])
                    j += 1
            off = 0
            for r in q_run:
                chunk = per_flow[off : off + len(r.flows)]
                off += len(r.flows)
                r.bandwidths = np.array([b for b, _ in chunk])
                r.routes = [route for _, route in chunk]
                r.span = job_span(net, r.alloc, r.flows, r.bandwidths)
                set_finish_event(r, now)
            net.residual = np.maximum(net.capacity - res.link_load, 0.0)

        spec_memo: dict[int, _Speculation] = {}  # job_id -> live speculation

        def speculate_round(pending: list[JobRecord]):
            """Speculative half of intra-round batching: make sure every
            waiting job has a live speculation — an Algorithm-1 allocation
            (with its memory effect recorded, so the repair pass can replay it
            without re-running the allocator) plus a JRBA solution against the
            round-start residual snapshot — solving all MISSING or STALE
            programs in one batched dispatch. Speculations persist across
            scheduling rounds: a queued job re-solves only when the residual
            moved on its candidate footprint or the memory state shifted under
            its allocation, so a deep waiting queue stops costing one solve
            per job per round. The repair pass in :func:`schedule_round`
            re-validates every speculation at use time, in priority order.

            Each job allocates against the ROUND-START memory: in the
            queue-building regime speculation targets, earlier queued jobs are
            mostly span-rejected (their memory is restored), so the sequential
            memory state at each job IS mem0 — assuming earlier admissions
            instead would cascade allocation divergence down the whole round
            after the first rejection."""
            nonlocal sched_overhead, spec_rounds
            spec_rounds += 1
            mem0 = net.mem_avail.copy()
            cap0 = net.residual.copy()
            fresh: list[_Speculation] = []
            t0 = time.perf_counter()
            for r in pending:
                old = spec_memo.get(r.job_id)
                if (
                    old is not None
                    and np.array_equal(mem0, old.mem_before)
                    and (not old.alloc.feasible or spec_exact(old))
                ):
                    continue  # carried over from an earlier round, still exact
                net.mem_avail = mem0.copy()
                alloc, flows, footprint = self._allocate_traced(r.job, r.job_id)
                sp = _Speculation(
                    alloc, flows, mem0, net.mem_avail.copy(), alloc_footprint=footprint
                )
                spec_memo[r.job_id] = sp
                if not sp.alloc.feasible:
                    continue
                if (
                    old is not None
                    and old.alloc.feasible
                    and _same_flows(flows, old.flows)
                    and spec_exact(old)
                ):
                    # the memory state moved but the re-allocation landed on
                    # the same flows and the old solve's footprint is still
                    # clean: the old solution remains bitwise exact
                    sp.result, sp.capacity0 = old.result, old.capacity0
                    continue
                fresh.append(sp)
            sched_overhead += time.perf_counter() - t0
            net.mem_avail = mem0
            if fresh:
                results = yield from solve_round(
                    [SolveRequest(net, sp.flows, cap0, self.water_fill) for sp in fresh]
                )
                for sp, res in zip(fresh, results):
                    sp.result, sp.capacity0 = res, cap0

        def spec_exact(sp: _Speculation) -> bool:
            """Accept check of the repair pass: is the speculative solution
            exactly what a fresh solve on the CURRENT residual would return?
            The solver's output depends on capacity only over the program's
            candidate links (zero-usage links contribute exact zeros to the
            congestion vector), so a residual unchanged on that footprint
            makes the stale program equivalent to the fresh one. The
            ``link_load_fits`` guard is redundant under that check but keeps
            a bad speculation from ever overcommitting a link.

            Caveat: "equivalent program" guarantees identical results through
            the SAME solver entry point; accepted speculations may come from
            the batched path while a speculate=False run uses the
            scalar path. The two agree whenever argmax rounding (after the
            best-response sweeps) lands on the same vertex — which holds on
            scheduler workloads and is asserted by the round_batch benchmark
            on pinned seeds — but a degenerate near-tie could in principle
            round differently between the two solver paths."""
            if sp.result is None:
                return True  # empty program: consumed nothing, can't go stale
            mask = sp.result.candidate_links
            # compare the CLAMPED values: build_program feeds the solver
            # np.maximum(capacity, 1e-9), so two residuals that clamp equal
            # produce bit-identical program tensors
            if not np.array_equal(
                np.maximum(net.residual[mask], 1e-9),
                np.maximum(sp.capacity0[mask], 1e-9),
            ):
                return False
            return link_load_fits(sp.result.link_load, net.residual)

        def schedule_round(now: float):
            """Sub-generator: job admissions and the OTFA refresh, yielded to
            the driver. OTFS admissions consume residual capacity, so the
            paper runs one JRBA per waiting job sequentially; with
            ``speculate`` the round instead solves every waiting job against
            the same residual snapshot in one batched dispatch, then repairs
            in Algo-3 priority order — a job whose footprint the earlier
            admissions never touched keeps its speculative solution (bitwise
            the sequential outcome), anything else is re-solved exactly."""
            nonlocal sched_overhead, spec_accepted, spec_repaired
            q_wait.sort(key=lambda r: -(now - r.submit_time))  # Algo 3/4 line 9
            pending = list(q_wait)
            if self.speculate and self.base == "OTFS" and pending:
                yield from speculate_round(pending)
            newly: list[JobRecord] = []
            for i, r in enumerate(pending):
                mem_snapshot = net.mem_avail.copy()
                sp = spec_memo.get(r.job_id)
                if sp is not None and np.array_equal(net.mem_avail, sp.mem_before):
                    # memory state matches the speculative pass; Algorithm 1
                    # is deterministic in it, so replay the recorded result
                    alloc, flows, footprint = sp.alloc, sp.flows, sp.alloc_footprint
                    net.mem_avail = sp.mem_after.copy()
                    flows_ok = True
                else:
                    t0 = time.perf_counter()
                    if self.speculate and self.base == "OTFS":
                        alloc, flows, footprint = self._allocate_traced(r.job, r.job_id)
                    else:
                        alloc, flows = self._allocate(r.job, r.job_id)
                        footprint = frozenset()
                    sched_overhead += time.perf_counter() - t0
                    flows_ok = sp is not None and _same_flows(flows, sp.flows)
                if not alloc.feasible:
                    continue
                if self.base == "OTFS":
                    if sp is not None and flows_ok and spec_exact(sp):
                        res = sp.result
                        spec_accepted += 1
                        tracer.instant("spec/accept", track=track, cat="spec", job=r.job_id)
                    else:
                        # conflict (or no speculation): the exact re-solve for
                        # THIS job rides one dispatch with a re-speculation of
                        # stale queued jobs against the fresh residual, so one
                        # conflict doesn't degrade the round to sequential.
                        # Still-clean speculations keep their results, and
                        # stale ones overlapping THIS job's candidate
                        # footprint are left alone — if this job is admitted
                        # its load would invalidate them right back, so
                        # pre-solving them is wasted compute either way.
                        capR = net.residual.copy()
                        rest: list[_Speculation] = []
                        if spec_memo:
                            trigger = self.engine.candidate_links(net, flows)
                            rest = [
                                sr
                                for rr in pending[i + 1 :]
                                if (sr := spec_memo.get(rr.job_id)) is not None
                                and sr.alloc.feasible
                                and not spec_exact(sr)
                                and sr.result is not None
                                and not np.any(sr.result.candidate_links & trigger)
                            ]
                        results = yield from solve_round(
                            [SolveRequest(net, flows, capR, self.water_fill)]
                            + [
                                SolveRequest(net, sr.flows, capR, self.water_fill)
                                for sr in rest
                            ]
                        )
                        res = results[0]
                        for sr, rr_res in zip(rest, results[1:]):
                            sr.result, sr.capacity0 = rr_res, capR
                        if sp is not None and sp.alloc.feasible:
                            spec_repaired += 1
                            tracer.instant("spec/repair", track=track, cat="spec", job=r.job_id)
                        if self.speculate:
                            # memoize the fresh exact solve: if the span check
                            # below rejects this job, the next round can carry
                            # it over instead of re-solving from scratch
                            spec_memo[r.job_id] = _Speculation(
                                alloc,
                                flows,
                                mem_snapshot,
                                net.mem_avail.copy(),
                                res,
                                capR,
                                alloc_footprint=footprint,
                            )
                    bandwidths = np.zeros(0) if res is None else res.bandwidth
                    span = job_span(net, alloc, flows, bandwidths)
                    if not np.isfinite(span) or span > self.max_acceptable_span:
                        # residual bandwidth (near-)exhausted on every candidate
                        # path: the job waits in the queue (paper Sec. VI-B2)
                        net.mem_avail = mem_snapshot
                        continue
                    r.bandwidths = bandwidths
                    r.routes = [] if res is None else res.routes
                    if res is not None:
                        net.residual = np.maximum(net.residual - res.link_load, 0.0)
                    r.span = span
                r.alloc, r.flows = alloc, flows
                r.schedule_time = now
                r.last_update = now
                if observing:
                    # per-job arrival->scheduled wall latency: measured from
                    # the moment the arrival event was handled to this
                    # admission decision (in a fleet this includes barrier
                    # waits — that is the point: it is the latency an edge
                    # client would see from this control plane)
                    t_arr = arrive_wall.pop(r.job_id, None)
                    if t_arr is not None:
                        lat = time.perf_counter() - t_arr
                        metrics.observe("event_latency_s", lat)
                        tracer.complete(
                            "job/arrival_to_scheduled",
                            track=track,
                            cat="job",
                            ts=tracer.now() - lat,
                            dur=lat,
                            job=r.job_id,
                            submit=r.submit_time,
                            scheduled=now,
                        )
                q_wait.remove(r)
                spec_memo.pop(r.job_id, None)
                newly.append(r)
                q_run.append(r)
                if self.base == "OTFS":
                    r.initial_span = r.span
                    set_finish_event(r, now)
            if self.base in ("LR", "BR", "TP") and newly:
                refresh_equal_share(now)
            elif self.base == "OTFA" and newly:
                yield from refresh_otfa(now)
            for r in newly:
                r.initial_span = r.span

        by_id = {r.job_id: r for r in records}
        n_events = 0
        while events:
            now, _, kind, jid = heapq.heappop(events)
            if now > max_time:
                break
            n_events += 1
            # per-event span: every continue below must tracer.end() first
            # (the trace-integrity test asserts B/E balance per track)
            tracer.begin("event/" + kind, track=track, cat="event", t=now, id=jid)
            metrics.inc("events/" + kind)
            if kind == "network":
                advance_running(now)
                effect = apply_churn_step(net, churn_steps[jid])
                touched, topo_changed = effect.touched, effect.topo_changed
                churn_events += 1
                if not topo_changed and not np.any(touched):
                    tracer.end("event/" + kind, track=track)
                    continue  # every op was a no-op; nothing to refresh
                if not self.scoped_churn or effect.links_added:
                    # reference mode — or a recovery added links, which can
                    # create shorter paths between ANY node pair: every
                    # cached enumeration and speculation is suspect, so drop
                    # them all (recover_link already cleared the avg-bw path
                    # memo wholesale for the same reason)
                    if topo_changed:
                        self.engine.invalidate(net)
                    churn_spec_dropped += len(spec_memo)
                    spec_memo.clear()
                else:
                    # footprint-scoped invalidation: failures only ever
                    # REMOVE paths, so pruning exactly the engine entries
                    # whose link footprint crosses a touched link preserves
                    # every surviving Yen enumeration; pure capacity drift
                    # keeps even those (the program-cache hit path refreshes
                    # capacity, and the avg-bw memo pins paths and reads
                    # capacity live). A speculation survives iff the step
                    # missed both its allocation's avg-bw footprint (so the
                    # Algorithm-1 replay stays exact) and its solution's
                    # candidate links (so the recorded solve stays exact —
                    # residual-level staleness is still caught at use time
                    # by spec_exact).
                    if topo_changed:
                        self.engine.invalidate(net, links=touched)
                    stale_ids = [
                        job_id
                        for job_id, sp in spec_memo.items()
                        if sp.footprint_hit(touched)
                    ]
                    for job_id in stale_ids:
                        del spec_memo[job_id]
                    churn_spec_dropped += len(stale_ids)
                    churn_spec_survived += len(spec_memo)
                if self.base == "OTFS":
                    affected = []
                    for r in q_run:
                        if not r.flows:
                            continue  # no network footprint — churn-immune
                        # candidate footprint on the POST-mutation paths: a
                        # failure not on any candidate path cannot change the
                        # enumeration, and a recovery that matters shows up
                        # in the fresh footprint. Checked last: the cheap
                        # stalled/route checks short-circuit the (possibly
                        # fresh) Yen enumeration for jobs that re-solve (and
                        # re-enumerate) anyway
                        if (
                            not np.isfinite(r.span)
                            or any(
                                touched[l]
                                for route in r.routes
                                for l in path_links(net, route)
                            )
                            or bool(
                                np.any(self.engine.candidate_links(net, r.flows) & touched)
                            )
                        ):
                            affected.append(r)
                    with tracer.span(
                        "churn/reroute", track=track, cat="churn", n_affected=len(affected), t=now
                    ):
                        yield from churn_reroute(affected, now)
                    if migrate_on and effect.failed_nodes:
                        # node failure under a running job's placement: the
                        # first migration check fires immediately (the
                        # re-solve above just stalled these jobs — their
                        # placement sits on dead hardware and a recovery may
                        # never come); capacity-collapse stalls instead wait
                        # out the stall budget
                        blast = set(effect.failed_nodes)
                        cands = [
                            r
                            for r in q_run
                            if r.flows
                            and not np.isfinite(r.span)
                            and any(int(a) in blast for a in r.alloc.assignment)
                        ]
                        if cands:
                            with tracer.span(
                                "migrate/round",
                                track=track,
                                cat="migrate",
                                n_candidates=len(cands),
                                t=now,
                            ):
                                yield from migration_round(cands, now)
                elif self.base == "OTFA":
                    if q_run:
                        yield from refresh_otfa(now)
                else:  # LR/BR/TP re-route + re-share over the mutated net
                    refresh_equal_share(now)
                with tracer.span("sched/round", track=track, cat="round", t=now):
                    yield from schedule_round(now)
                tracer.end("event/" + kind, track=track)
                continue
            r = by_id[jid]
            if kind == "migrate":
                # a stall-budget check coming due. Stale unless the job is
                # still running, still stalled, and this is its CURRENT
                # scheduled check (commit/un-stall/backoff all re-stamp
                # migrate_time, exactly like finish_time for finish events).
                if (
                    r not in q_run
                    or np.isfinite(r.span)
                    or not math.isclose(r.migrate_time, now, rel_tol=1e-9, abs_tol=1e-9)
                ):
                    tracer.end("event/" + kind, track=track)
                    continue
                advance_running(now)
                # batch every candidate whose check falls due at this instant
                # — jobs stalled by one blast share a deadline, and one
                # migration_round turns them into one solve_many dispatch
                due = [
                    j
                    for j in q_run
                    if j.flows
                    and not np.isfinite(j.span)
                    and j.migrate_time >= 0.0
                    and math.isclose(j.migrate_time, now, rel_tol=1e-9, abs_tol=1e-9)
                ]
                with tracer.span(
                    "migrate/round", track=track, cat="migrate", n_candidates=len(due), t=now
                ):
                    yield from migration_round(due, now)
                # a commit released the old placement's memory — queued jobs
                # may fit now
                with tracer.span("sched/round", track=track, cat="round", t=now):
                    yield from schedule_round(now)
                tracer.end("event/" + kind, track=track)
                continue
            if kind == "finish":
                # relative tolerance: event times are O(now), so an absolute
                # epsilon would misclassify fp-noise-level differences once
                # simulated time grows large (late-submitted jobs at t ~ 1e9)
                if r not in q_run or not math.isclose(
                    r.finish_time, now, rel_tol=1e-9, abs_tol=1e-9
                ):
                    tracer.end("event/" + kind, track=track)
                    continue  # stale event (span changed after this was queued)
                advance_running(now)
                q_run.remove(r)
                r.remaining_units = 0.0
                r.done = True
                tracer.instant("job/finish", track=track, cat="job", job=r.job_id, finish=now)
                # Algo 3/4 lines 1-5: release compute + bandwidth. Pinned
                # tasks are skipped symmetrically with admission (the
                # allocators never debit them), so a full simulation
                # conserves mem_avail exactly (regression-tested)
                for i, task in enumerate(r.job.tasks):
                    if task.pinned_node is None:
                        net.mem_avail[int(r.alloc.assignment[i])] += task.mem
                if self.base in ("LR", "BR", "TP"):
                    refresh_equal_share(now)
                elif self.base == "OTFA":
                    yield from refresh_otfa(now)
                else:  # OTFS
                    stalled = [j for j in q_run if j.flows and not np.isfinite(j.span)]
                    if stalled:
                        # the freed bandwidth may un-stall a churn-starved
                        # job (churn_reroute rebuilds the residual itself);
                        # without churn no running job is ever stalled
                        with tracer.span(
                            "churn/reroute",
                            track=track,
                            cat="churn",
                            n_affected=len(stalled),
                            t=now,
                        ):
                            yield from churn_reroute(stalled, now)
                    else:
                        rebuild_residual_from_running()
            else:  # arrival
                advance_running(now)
                if observing:
                    arrive_wall[r.job_id] = time.perf_counter()
                q_wait.append(r)
            with tracer.span("sched/round", track=track, cat="round", t=now):
                yield from schedule_round(now)
            tracer.end("event/" + kind, track=track)
        unfinished = sum(1 for r in records if not r.done)
        return SimResult(
            records,
            sched_overhead,
            unfinished,
            n_events,
            n_dispatches=n_dispatches,
            n_solves=n_solves,
            spec_rounds=spec_rounds,
            spec_accepted=spec_accepted,
            spec_repaired=spec_repaired,
            churn_events=churn_events,
            churn_resolves=churn_resolves,
            churn_reroutes=churn_reroutes,
            churn_stalls=churn_stalls,
            churn_spec_survived=churn_spec_survived,
            churn_spec_dropped=churn_spec_dropped,
            churn_spec_accepted=churn_spec_accepted,
            churn_spec_repaired=churn_spec_repaired,
            churn_wide_jobs=churn_wide_jobs,
            churn_wide_dispatches=churn_wide_dispatches,
            migration_checks=migration_checks,
            migrations=migrations,
            migration_rejected=migration_rejected,
            migration_infeasible=migration_infeasible,
            migration_moved_tasks=migration_moved_tasks,
            migration_penalty_seconds=migration_penalty_seconds,
            migration_spec_accepted=migration_spec_accepted,
            migration_spec_repaired=migration_spec_repaired,
        )
