"""Fleet co-scheduling: run many independent online-scheduling simulations
and batch their JRBA solves through one shared engine — in lockstep
rounds or via the async continuous-batching dispatcher (``FleetRuntime(mode=
...)`` / ``REPRO_FLEET_RUNTIME``; identical per-lane records either way).

Entry point: build one :class:`FleetSim` per simulation (all schedulers
sharing one :class:`~repro_torch.core.JRBAEngine`), then ``FleetRuntime().run(sims)``.
See ``examples/fleet_demo.py`` and the ``cosched`` / ``fleet_async`` sections
of ``benchmarks/fleet.py``.
"""
from .runtime import (
    FLEET_RUNTIMES,
    FLEET_SCENARIOS,
    AsyncFleetRuntime,
    FleetResult,
    FleetRuntime,
    FleetSim,
    build_async_fleet,
    build_chaos_fleet,
    build_scenario_fleet,
)
from .telemetry import DispatchRecord, FleetTelemetry, RoundRecord

__all__ = [
    "FLEET_RUNTIMES",
    "FLEET_SCENARIOS",
    "AsyncFleetRuntime",
    "DispatchRecord",
    "FleetResult",
    "FleetRuntime",
    "FleetSim",
    "FleetTelemetry",
    "RoundRecord",
    "build_async_fleet",
    "build_chaos_fleet",
    "build_scenario_fleet",
]
