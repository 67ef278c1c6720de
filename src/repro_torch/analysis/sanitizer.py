"""Runtime mutation sanitizer — the dynamic twin of the CC1xx lint pass, for
the port's :class:`~repro_torch.core.graph.NetworkGraph` and
:class:`~repro_torch.core.jrba.JRBAEngine` (the JAX package's
``repro.analysis.sanitizer``, carried over).

The static pass proves every *source-visible* ``NetworkGraph`` mutator bumps
its epoch; this module audits the same contract at runtime, where
monkeypatches, subclasses, and code the linter never saw can still break it.
Armed, every graph is wrapped in a mutation audit and every engine build
checked against a topology fingerprint, so an epoch bug surfaces as a loud
:class:`SanitizerError` at the mutation site instead of a silently stale
solve three calls later.

Two audits:

* **Graph mutators** (:func:`audit_graph`) — each churn-API call is
  snapshotted before/after. If live capacity state moved without a
  ``capacity_version`` bump, or adjacency/liveness moved without a
  ``topology_version`` bump, the wrapper raises. Host-cache coherence is
  checked as a *property*, not a mechanism: after a failure no pinned
  avg-bandwidth path may cross a newly dead link, and after a recovery the
  path memo must be empty (a new edge can shorten any pair's path). The
  wrappers resolve the underlying method through ``type(net)`` at call time,
  so a class-level monkeypatch that forgets the bump is still audited.
* **Engine staleness** (:func:`audit_engine`) — ``JRBAEngine.build`` is
  wrapped to fingerprint the adjacency per network. Seeing the same
  ``topology_version`` with a *different* adjacency means some mutation
  dodged the epoch — the engine's ``_check_topology`` guard is blind to it
  and would serve programs cached under the stale epoch; the wrapper raises
  before that can happen.

:func:`install` hooks both constructors so every instance created afterwards
is audited. The port's scheduler tests arm it under ``REPRO_SANITIZE=1``
(``tests/_torch_sanitize.py``), and ``chip_smoke.py`` runs its 32-lane
kernel-vs-plain fleet comparison with it installed. :data:`AUDITED` counts
the audited mutations and builds. Overhead is a few array copies per
*mutation* (not per solve).
"""
from __future__ import annotations

import importlib
import os
from typing import Callable

__all__ = [
    "AUDITED",
    "SanitizerError",
    "audit_engine",
    "audit_graph",
    "enabled",
    "install",
    "reset_counts",
]

# the churn API — every public NetworkGraph method that may move capacity,
# adjacency, or liveness state (node ops delegate to link ops but are wrapped
# too: the audit must hold across the composite call, not only its pieces)
GRAPH_MUTATORS = (
    "set_link_capacity",
    "fail_link",
    "recover_link",
    "fail_node",
    "recover_node",
    "restore_topology",
)


# audited calls since the last reset_counts(): churn-API mutations and
# engine builds
AUDITED = {"mutations": 0, "builds": 0}


def reset_counts() -> None:
    AUDITED.update(mutations=0, builds=0)


class SanitizerError(AssertionError):
    """A mutation broke the epoch/cache-coherence contract."""


def enabled(env: dict | None = None) -> bool:
    """True when ``REPRO_SANITIZE`` is set to a truthy value."""
    env = os.environ if env is None else env
    return env.get("REPRO_SANITIZE", "").strip() not in ("", "0", "false", "no")


def _snapshot(net) -> dict:
    return {
        "capacity": net.capacity.copy(),
        "bandwidth": dict(net.bandwidth),
        "adj": {u: set(vs) for u, vs in net._adj.items()},
        "alive": net.link_alive.copy(),
        "cap_v": net.capacity_version,
        "topo_v": net.topology_version,
    }


def _audit_mutation(net, name: str, before: dict) -> None:
    after = _snapshot(net)
    cap_moved = (
        (before["capacity"] != after["capacity"]).any()
        or before["bandwidth"] != after["bandwidth"]
    )
    topo_moved = before["adj"] != after["adj"] or (before["alive"] != after["alive"]).any()
    if cap_moved and after["cap_v"] <= before["cap_v"]:
        raise SanitizerError(
            f"{name}() moved live capacity without bumping capacity_version "
            f"(still {after['cap_v']}) — epoch-keyed memos will serve stale values"
        )
    if topo_moved and after["topo_v"] <= before["topo_v"]:
        raise SanitizerError(
            f"{name}() changed adjacency/liveness without bumping topology_version "
            f"(still {after['topo_v']}) — engine caches will serve stale programs"
        )
    cache = getattr(net, "_avg_bw_cache", None)
    if not cache or not topo_moved:
        return
    died = [l for l, was in enumerate(before["alive"]) if was and not after["alive"][l]]
    for pair, links in cache.items():
        if links and any(l in links for l in died):
            raise SanitizerError(
                f"{name}() killed link(s) {died} but the avg-bandwidth memo still "
                f"pins a path for {pair} crossing one — _prune_host_caches was skipped"
            )
    gained = any(after["adj"][u] - before["adj"][u] for u in after["adj"])
    if gained and cache:
        raise SanitizerError(
            f"{name}() added adjacency edges but the avg-bandwidth path memo is "
            "non-empty — a new edge can shorten any pair; _drop_host_caches was skipped"
        )


def audit_graph(net) -> None:
    """Install per-instance mutation audits on ``net`` (idempotent).

    Each wrapper resolves the mutator through ``type(net)`` at call time —
    a monkeypatched class method without the epoch bump is still caught."""
    if getattr(net, "_repro_sanitized", False):
        return
    for name in GRAPH_MUTATORS:
        if not callable(getattr(type(net), name, None)):
            continue

        def wrapper(*args, _name=name, _net=net, **kwargs):
            before = _snapshot(_net)
            result = getattr(type(_net), _name)(_net, *args, **kwargs)
            _audit_mutation(_net, _name, before)
            AUDITED["mutations"] += 1
            return result

        wrapper.__name__ = name
        setattr(net, name, wrapper)
    net._repro_sanitized = True


def _adjacency_fingerprint(net) -> tuple:
    return tuple(sorted((u, tuple(sorted(vs))) for u, vs in net._adj.items()))


def audit_engine(engine) -> None:
    """Wrap ``engine.build`` to refuse serving under a dodged topology epoch
    (same ``topology_version``, different adjacency)."""
    if getattr(engine, "_repro_sanitized", False):
        return
    seen: dict[int, tuple[int, tuple]] = {}

    def build(net, *args, _engine=engine, **kwargs):
        fp = _adjacency_fingerprint(net)
        prior = seen.get(id(net))  # reprolint: allow[DT302] -- audit-only
        # bookkeeping keyed per live object; never feeds scheduling order
        if prior is not None and prior[0] == net.topology_version and prior[1] != fp:
            raise SanitizerError(
                "JRBAEngine.build: adjacency changed while topology_version stayed "
                f"at {net.topology_version} — some mutation dodged the epoch; cached "
                "paths/programs for this network are stale and would be served"
            )
        out = getattr(type(_engine), "build")(_engine, net, *args, **kwargs)
        seen[id(net)] = (net.topology_version, fp)  # reprolint: allow[DT302] -- see above
        AUDITED["builds"] += 1
        return out

    engine.build = build
    engine._repro_sanitized = True


def install() -> Callable[[], None]:
    """Hook ``NetworkGraph.__init__`` and ``JRBAEngine.__init__`` so every
    instance constructed afterwards is audited. Returns an uninstaller."""
    from ..core import graph as graph_mod

    graph_init = graph_mod.NetworkGraph.__init__

    def patched_graph_init(self, *args, **kwargs):
        graph_init(self, *args, **kwargs)
        audit_graph(self)

    graph_mod.NetworkGraph.__init__ = patched_graph_init

    undo = [lambda: setattr(graph_mod.NetworkGraph, "__init__", graph_init)]
    # import_module: repro_torch.core re-exports a *function* named jrba, so
    # ``from ..core import jrba`` would grab that instead of the module
    jrba_mod = importlib.import_module("repro_torch.core.jrba")
    engine_init = jrba_mod.JRBAEngine.__init__

    def patched_engine_init(self, *args, **kwargs):
        engine_init(self, *args, **kwargs)
        audit_engine(self)

    jrba_mod.JRBAEngine.__init__ = patched_engine_init
    undo.append(lambda: setattr(jrba_mod.JRBAEngine, "__init__", engine_init))

    def uninstall() -> None:
        for fn in undo:
            fn()

    return uninstall
