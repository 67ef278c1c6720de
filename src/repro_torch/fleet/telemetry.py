"""Fleet telemetry: per-dispatch metrics and a JSON-lines trace.

The lockstep runtime records one :class:`RoundRecord` per barrier round; the
async continuous-batching runtime records one :class:`DispatchRecord` per
queue fire (which bucket, why it fired, how long its entries waited). Both
capture how well cross-simulation batching worked (compiled batch calls,
occupancy), what the solver cost, and where the compile cache stands
(`EngineStats` hits/misses). On completion a summary aggregates simulator
throughput (events/sec) and per-scenario job throughput — uniformly over
whichever record kind the run produced. ``to_jsonl`` dumps the whole trace —
one record per line plus a terminal summary line — for offline analysis.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

# strict RFC-8259 serialization now lives in repro_torch.obs.trace, shared with
# the Chrome trace exporter; this module keeps the historical private name
from ..obs.trace import dumps_strict as _dumps_strict

if TYPE_CHECKING:  # pragma: no cover - import cycle guard for type hints only
    from ..core.online import SimResult

__all__ = ["DispatchRecord", "RoundRecord", "FleetTelemetry"]


@dataclasses.dataclass
class RoundRecord:
    """One lockstep dispatch round of the fleet runtime."""

    round: int
    n_live: int  # simulations still running when the round started
    # lanes whose round carried at least one *real* solve (a flow with
    # distinct endpoints and positive volume). Idle-lane rounds — empty
    # solve lists or colocated-only flows that build no program — are the
    # n_live - n_requests gap, so traces distinguish a genuinely busy round
    # from one lane dragging a mostly-idle fleet through the barrier
    n_requests: int
    # individual JRBA programs flattened out of the collected rounds; above
    # n_requests means speculative intra-round batching contributed extra
    # same-round solves to the shared dispatch
    n_solves: int
    batch_calls: int  # compiled batch dispatches this round (shape groups)
    # batched instances per compiled call — >1 means real batching. Can be
    # less than n_requests / batch_calls: empty-program requests (idle lanes
    # with no real flows) never join a batch
    batch_occupancy: float
    solve_seconds: float  # solver time inside the engine this round
    dispatch_seconds: float  # wall-clock of the whole solve_many call
    # summed per-lane barrier stall of this round: each live lane waited
    # dispatch_seconds - its own n/n_total share of the batched call, i.e.
    # (n_live - 1) * dispatch_seconds in total (see FleetRuntime.run for the
    # per-lane attribution the latency summary reports)
    stall_seconds: float
    # cumulative EngineStats counters for THIS run: deltas from the engine's
    # state when FleetRuntime.run began, so a pre-warmed engine doesn't
    # contaminate the measured run's hit rate
    cache_hits: int
    cache_misses: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DispatchRecord:
    """One continuous-batching dispatch of the async fleet runtime: the
    queue fire that took up to ``batch_target`` entries from one shape
    bucket and ran them through a single ``solve_many`` call."""

    dispatch: int
    bucket: str  # the shape-bucket key fired (str of the engine's bucket_key)
    # why the dispatcher fired this bucket: "fill" (reached batch_target),
    # "deadline" (its head waited past deadline_s), or "flush" (nothing full
    # or expired — drain the oldest head so the fleet always makes progress)
    fired_by: str
    n_solves: int  # entries taken from the bucket (== programs dispatched)
    n_lanes: int  # distinct lanes those entries belong to
    # total entries queued across ALL buckets when this dispatch fired —
    # backlog pressure at fire time (n_solves of them were drained)
    queue_depth: int
    batch_calls: int  # compiled batch dispatches (shape groups) in the call
    batch_occupancy: float  # batched instances per compiled call
    solve_seconds: float  # solver time inside the engine this dispatch
    dispatch_seconds: float  # wall-clock of the whole solve_many call
    # queue wait of the entries this dispatch drained: enqueue -> fire, the
    # latency the deadline rule bounds (the per-entry distribution feeds the
    # summary's latency.queue.wait percentiles)
    queue_wait_mean: float
    queue_wait_max: float
    # cumulative EngineStats counters for THIS run (deltas from run start,
    # same convention as RoundRecord)
    cache_hits: int
    cache_misses: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FleetTelemetry:
    """Accumulates :class:`RoundRecord` (lockstep) or :class:`DispatchRecord`
    (async) rows plus a completion summary. One run produces one kind; the
    derived metrics aggregate over both lists so callers never branch."""

    def __init__(self) -> None:
        self.rounds: list[RoundRecord] = []
        self.dispatches: list[DispatchRecord] = []
        self.summary: dict = {}

    # -- recording -----------------------------------------------------------
    def record_round(self, record: RoundRecord) -> None:
        self.rounds.append(record)

    def record_dispatch(self, record: DispatchRecord) -> None:
        self.dispatches.append(record)

    def finalize(
        self,
        *,
        names: list[str],
        results: "list[SimResult]",
        wall_seconds: float,
        solver: dict | None = None,
        latency: dict | None = None,
        runtime: str = "lockstep",
        n_requests: int | None = None,
    ) -> dict:
        """Aggregate per-scenario throughput and fleet-level rates. ``names``
        groups simulations (several fleet lanes may share one scenario name).
        ``latency`` is the runtime-built observability block (barrier-stall
        attribution, event-latency percentiles, solver phase split) and is
        surfaced verbatim; None when the caller has no latency data.
        ``runtime`` tags which driver produced the records; ``n_requests``
        is the lane-round count for drivers without round records (the async
        runtime counts rounds at enqueue time), None to derive it from
        ``self.rounds``."""
        total_events = sum(r.n_events for r in results)
        recs = [*self.rounds, *self.dispatches]
        by_name: dict[str, list] = {}
        for name, res in zip(names, results):
            by_name.setdefault(name or "sim", []).append(res)
        spec_accepted = sum(r.spec_accepted for r in results)
        spec_repaired = sum(r.spec_repaired for r in results)
        churn_events = sum(r.churn_events for r in results)
        migration_checks = sum(r.migration_checks for r in results)
        self.summary = {
            "runtime": runtime,
            "n_sims": len(results),
            "n_rounds": len(self.rounds),
            "n_dispatches": len(self.dispatches),
            "n_requests": (
                n_requests
                if n_requests is not None
                else sum(r.n_requests for r in self.rounds)
            ),
            "n_solves": sum(r.n_solves for r in recs),
            "batch_calls": sum(r.batch_calls for r in recs),
            "mean_batch_occupancy": self.mean_batch_occupancy,
            "cache_hit_rate": self.cache_hit_rate,
            "solve_seconds": sum(r.solve_seconds for r in recs),
            "wall_seconds": wall_seconds,
            "events": total_events,
            "events_per_s": total_events / wall_seconds if wall_seconds else None,
            "unfinished": sum(r.unfinished for r in results),
            # intra-round speculation across the whole fleet: accepted solves
            # were reused verbatim, repaired ones fell back to an exact
            # re-solve (see OnlineScheduler.schedule_round)
            "speculation": {
                "rounds": sum(r.spec_rounds for r in results),
                "accepted": spec_accepted,
                "repaired": spec_repaired,
                "accept_rate": (
                    spec_accepted / (spec_accepted + spec_repaired)
                    if spec_accepted + spec_repaired
                    else None
                ),
            },
            # network churn across the fleet: "network" events applied,
            # running jobs re-solved because a churn step touched their
            # footprint, re-solves that changed the route set, and re-solves
            # that left a job stalled until a later recovery; spec_survived /
            # spec_dropped count queued-job speculations that outlived vs
            # died at churn steps (footprint-scoped invalidation), and
            # spec_accepted / spec_repaired the speculate-then-repair outcome
            # of batched churn re-solves. None when no lane carried a churn
            # trace.
            "churn": (
                {
                    "events": churn_events,
                    "resolves": sum(r.churn_resolves for r in results),
                    "reroutes": sum(r.churn_reroutes for r in results),
                    "stalls": sum(r.churn_stalls for r in results),
                    "spec_survived": sum(r.churn_spec_survived for r in results),
                    "spec_dropped": sum(r.churn_spec_dropped for r in results),
                    "spec_accepted": sum(r.churn_spec_accepted for r in results),
                    "spec_repaired": sum(r.churn_spec_repaired for r in results),
                }
                if churn_events
                else None
            ),
            # stall-budget migration across the fleet: checks are stall-budget
            # expiries (plus immediate node-failure triggers) that re-ran
            # Algorithm 1 over the surviving nodes; migrations committed when
            # the penalized migrated span beat the wait-for-recovery
            # projection, rejected kept stall-and-wait, infeasible found no
            # surviving placement; moved_tasks / penalty_seconds size the
            # data-transfer cost, and spec_accepted / spec_repaired the
            # speculate-then-repair outcome of batched migration re-solves.
            # None when no lane ran with a stall budget (or nothing stalled).
            "migration": (
                {
                    "checks": migration_checks,
                    "migrations": sum(r.migrations for r in results),
                    "rejected": sum(r.migration_rejected for r in results),
                    "infeasible": sum(r.migration_infeasible for r in results),
                    "moved_tasks": sum(r.migration_moved_tasks for r in results),
                    "penalty_seconds": float(
                        sum(r.migration_penalty_seconds for r in results)
                    ),
                    "spec_accepted": sum(r.migration_spec_accepted for r in results),
                    "spec_repaired": sum(r.migration_spec_repaired for r in results),
                }
                if migration_checks
                else None
            ),
            # solver-formulation telemetry for THIS run (mode, relaxation
            # steps actually run vs the fixed dense budget, analytic
            # single-flow fast paths, program-tensor cache traffic) — see
            # EngineStats; None when the runtime didn't supply it
            "solver": solver,
            # observability block (see FleetRuntime.run): per-lane barrier
            # stall vs own-solve attribution, per-scenario event-latency
            # percentiles (None unless the run observed), and the engine's
            # phase breakdown of where solve wall-clock went
            "latency": latency,
            "scenarios": {
                name: {
                    "sims": len(group),
                    "jobs_scheduled": sum(r.n_scheduled for r in group),
                    "avg_throughput": float(np.mean([r.avg_throughput for r in group])),
                    "avg_scheduled_span": float(
                        np.mean([r.avg_scheduled_span for r in group])
                    ),
                    "events": sum(r.n_events for r in group),
                }
                for name, group in sorted(by_name.items())
            },
        }
        return self.summary

    # -- derived metrics ------------------------------------------------------
    @property
    def mean_batch_occupancy(self) -> float:
        """Instances per compiled batch call, over the whole run. The whole
        point of co-scheduling: >1 means independent simulations actually
        shared compiled solves."""
        recs = [*self.rounds, *self.dispatches]
        calls = sum(r.batch_calls for r in recs)
        instances = sum(r.batch_occupancy * r.batch_calls for r in recs)
        return instances / calls if calls else 0.0

    @property
    def cache_hit_rate(self) -> float:
        # cache counters are cumulative per record, so the last record of
        # whichever kind the run produced carries the run totals
        recs = self.rounds or self.dispatches
        if not recs:
            return 0.0
        last = recs[-1]
        total = last.cache_hits + last.cache_misses
        return last.cache_hits / total if total else 0.0

    # -- export ---------------------------------------------------------------
    def to_jsonl(self, path: str) -> None:
        """One ``{"type": "round", ...}`` line per lockstep round (or one
        ``{"type": "dispatch", ...}`` line per async queue fire), then a
        final ``{"type": "summary", ...}`` line.

        Strict RFC 8259 output: summary metrics can be non-finite (e.g. an
        all-idle lane's ``avg_scheduled_span`` is ``inf``), and bare
        ``json.dumps`` would emit the non-standard ``Infinity``/``NaN``
        tokens, producing a trace strict parsers reject. Non-finite values
        are mapped to ``null`` and ``allow_nan=False`` guarantees none slip
        through."""
        with open(path, "w") as f:
            for r in self.rounds:
                f.write(_dumps_strict({"type": "round", **r.as_dict()}) + "\n")
            for d in self.dispatches:
                f.write(_dumps_strict({"type": "dispatch", **d.as_dict()}) + "\n")
            f.write(_dumps_strict({"type": "summary", **self.summary}) + "\n")
