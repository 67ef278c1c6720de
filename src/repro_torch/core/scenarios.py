"""Scenario generator suite — diverse topologies/workloads beyond Fig. 2/9.

The paper evaluates on one physical 10-node testbed plus random meshes
(Sec. VI-A4). Fleet-scale evaluation needs structurally different networks —
related schedulers (Oakestra's multi-cluster hierarchy, KCES's cloud-edge
workflows) stress exactly the regimes a flat mesh never produces:

  * ``hierarchical_edge_cloud`` — weak leaves behind aggregation switches and
    a fat cloud: thin access links, strong incentive to partition.
  * ``wan_mesh`` — Waxman geometric graph: long multi-hop routes, bandwidth
    decaying with distance (multi-site federations over WAN).
  * ``fat_tree`` — k-ary data-center fabric with compute only at the hosts;
    switches are transit-only (zero memory keeps the allocator off them).
  * ``heterogeneous_mesh`` — log-normal node-power spread; ``spread`` sweeps
    from near-homogeneous to three-orders-of-magnitude heterogeneity.

Each registry entry pairs a topology factory with an arrival process (steady
Poisson or Markov-modulated bursts) so benchmarks and tests can iterate
``SCENARIOS`` without per-scenario glue.

The module also generates **churn traces** — timestamped network mutations
(per-link capacity drift as a bounded random walk, link/node failure +
recovery cycles, MMPP-correlated bandwidth dips, correlated blast-radius
group outages) consumed by the online simulator's ``"network"`` event kind.
By default every failure op has its matching recovery op emitted (even past
``t_end``), so a trace returns the network to a fully-connected state and
stalled jobs can finish; ``permanent=True`` deliberately suppresses the
recovery ops, producing traces that never heal — the chaos input the
migration subsystem (``OnlineScheduler(stall_budget=...)``) exists for.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

from .graph import Flow, JobGraph, NetworkGraph, random_edge_network
from .workloads import poisson_arrivals, poisson_burst_arrivals

__all__ = [
    "ChurnEffect",
    "ChurnOp",
    "ChurnStep",
    "Scenario",
    "SCENARIOS",
    "apply_churn_step",
    "capacity_drift_trace",
    "churn_trace",
    "compute_nodes",
    "correlated_failure_trace",
    "fat_tree",
    "get_scenario",
    "heterogeneous_mesh",
    "hierarchical_edge_cloud",
    "link_failure_trace",
    "mmpp_dip_trace",
    "node_failure_trace",
    "random_flow_sets",
    "scenario_names",
    "wan_mesh",
]

Arrivals = list[tuple[float, JobGraph, float]]


# ---------------------------------------------------------------------------
# Churn traces: timestamped network mutations
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChurnOp:
    """One network mutation. ``kind`` is one of ``capacity`` (set a live
    link's bandwidth), ``fail``/``recover`` (a link), or ``fail_node``/
    ``recover_node`` (every link incident to a node)."""

    kind: str
    link: tuple[int, int] | None = None
    node: int | None = None
    capacity: float | None = None


@dataclasses.dataclass(frozen=True)
class ChurnStep:
    """All mutations applied at one simulated instant (e.g. one drift tick
    updates many links atomically, so the scheduler re-solves once)."""

    time: float
    ops: tuple[ChurnOp, ...]


class ChurnEffect(NamedTuple):
    """What one :func:`apply_churn_step` call actually did — the input to
    footprint-scoped invalidation. ``touched`` is a bool mask over link ids
    whose capacity or liveness changed; ``topo_changed`` says the adjacency
    (and with it candidate-path enumerations crossing the touched links)
    changed; ``links_added`` says the adjacency *gained* links (a recovery),
    which is the one case scoped invalidation cannot bound — a new link can
    create a shorter path between any pair, so caches must drop wholesale.

    ``failed_nodes`` / ``recovered_nodes`` surface the node ids of effective
    node-level ops (``fail_node``/``recover_node`` that actually changed at
    least one link), so consumers can scope node-level reactions — e.g. the
    migration subsystem's "a node under a running job just died" trigger —
    without re-diffing the graph against the touched-link mask."""

    touched: np.ndarray
    topo_changed: bool
    links_added: bool
    failed_nodes: tuple[int, ...] = ()
    recovered_nodes: tuple[int, ...] = ()


def apply_churn_step(net: NetworkGraph, step: ChurnStep) -> ChurnEffect:
    """Apply one step to ``net`` in place. Returns a :class:`ChurnEffect`
    describing which links were actually touched and how. No-op ops (failing
    a dead link, drifting to the same value) touch nothing."""
    touched = np.zeros(len(net.links), dtype=bool)
    topo_changed = False
    links_added = False
    failed_nodes: list[int] = []
    recovered_nodes: list[int] = []
    for op in step.ops:
        if op.kind == "capacity":
            u, v = op.link
            l = net.link_id(u, v)
            old = float(net.capacity[l])
            net.set_link_capacity(u, v, op.capacity)
            if net.link_alive[l] and float(net.capacity[l]) != old:
                touched[l] = True
        elif op.kind == "fail":
            u, v = op.link
            if net.fail_link(u, v):
                touched[net.link_id(u, v)] = True
                topo_changed = True
        elif op.kind == "recover":
            u, v = op.link
            if net.recover_link(u, v, capacity=op.capacity):
                touched[net.link_id(u, v)] = True
                topo_changed = True
                links_added = True
        elif op.kind == "fail_node":
            ids = net.fail_node(op.node)
            touched[ids] = True
            topo_changed = topo_changed or bool(ids)
            if ids:
                failed_nodes.append(op.node)
        elif op.kind == "recover_node":
            ids = net.recover_node(op.node)
            touched[ids] = True
            topo_changed = topo_changed or bool(ids)
            links_added = links_added or bool(ids)
            if ids:
                recovered_nodes.append(op.node)
        else:
            raise ValueError(f"unknown churn op kind {op.kind!r}")
    return ChurnEffect(
        touched, topo_changed, links_added, tuple(failed_nodes), tuple(recovered_nodes)
    )


def capacity_drift_trace(
    net: NetworkGraph,
    rng: np.random.RandomState,
    *,
    t_end: float,
    dt: float = 2.0,
    sigma: float = 0.12,
    lo: float = 0.35,
    hi: float = 1.8,
    frac: float = 0.3,
) -> list[ChurnStep]:
    """Per-link bounded multiplicative random walk around the base capacity.

    Every ``dt`` seconds a random ``frac`` of links takes a log-normal step
    (stddev ``sigma``) on its walk state, clipped into ``[lo, hi]`` times the
    construction-time capacity — WAN bandwidth wanders but never collapses to
    zero or runs away."""
    walk = np.ones(len(net.links))
    steps: list[ChurnStep] = []
    t = dt
    while t < t_end:
        picked = np.flatnonzero(rng.uniform(size=len(net.links)) < frac)
        ops = []
        for l in picked:
            walk[l] = float(np.clip(walk[l] * np.exp(sigma * rng.normal()), lo, hi))
            ops.append(
                ChurnOp(
                    "capacity",
                    link=net.links[l],
                    capacity=float(net.base_capacity[l] * walk[l]),
                )
            )
        if ops:
            steps.append(ChurnStep(t, tuple(ops)))
        t += dt
    return steps


def link_failure_trace(
    net: NetworkGraph,
    rng: np.random.RandomState,
    *,
    t_end: float,
    n_links: int = 3,
    mtbf: float = 25.0,
    mttr: float = 5.0,
    permanent: bool = False,
) -> list[ChurnStep]:
    """Exponential fail/recover cycles on ``n_links`` randomly sampled links.

    Each sampled link alternates up (mean ``mtbf``) and down (mean ``mttr``)
    phases; a failure whose up-phase starts before ``t_end`` always emits its
    recovery too, so the trace never leaves the network degraded forever —
    unless ``permanent=True``, which suppresses the guaranteed-heal recovery
    op: each sampled link fails once at its first failure time and stays dead
    (hardware loss, not a reboot)."""
    chosen = rng.choice(len(net.links), size=min(n_links, len(net.links)), replace=False)
    steps: list[ChurnStep] = []
    for l in sorted(int(c) for c in chosen):
        link = net.links[l]
        t = rng.exponential(mtbf)
        while t < t_end:
            down = rng.exponential(mttr)
            steps.append(ChurnStep(t, (ChurnOp("fail", link=link),)))
            if permanent:
                break
            steps.append(ChurnStep(t + down, (ChurnOp("recover", link=link),)))
            t += down + rng.exponential(mtbf)
    return steps


def node_failure_trace(
    net: NetworkGraph,
    rng: np.random.RandomState,
    *,
    t_end: float,
    n_nodes: int = 1,
    mtbf: float = 40.0,
    mttr: float = 6.0,
    permanent: bool = False,
    nodes: list[int] | None = None,
) -> list[ChurnStep]:
    """Whole-node outages (every incident link fails) with guaranteed
    recovery, on ``n_nodes`` randomly sampled nodes (restricted to ``nodes``
    when given, so e.g. pinned-source tiers can be kept out of the blast).
    ``permanent=True`` suppresses the recovery op: each sampled node dies
    once and never comes back — the trace shape that strands stall-and-wait
    jobs and makes migration load-bearing."""
    pool = list(range(net.n_nodes)) if nodes is None else sorted(nodes)
    chosen = rng.choice(len(pool), size=min(n_nodes, len(pool)), replace=False)
    steps: list[ChurnStep] = []
    for node in sorted(pool[int(c)] for c in chosen):
        t = rng.exponential(mtbf)
        while t < t_end:
            down = rng.exponential(mttr)
            steps.append(ChurnStep(t, (ChurnOp("fail_node", node=node),)))
            if permanent:
                break
            steps.append(ChurnStep(t + down, (ChurnOp("recover_node", node=node),)))
            t += down + rng.exponential(mtbf)
    return steps


def correlated_failure_trace(
    net: NetworkGraph,
    rng: np.random.RandomState,
    *,
    t_end: float,
    n_groups: int = 2,
    group_size: int = 3,
    mtbf: float = 30.0,
    mttr: float = 8.0,
    permanent: bool = False,
    nodes: list[int] | None = None,
) -> list[ChurnStep]:
    """Blast-radius failures: disjoint node groups (a rack, a zone, a site
    behind one uplink) die *together* in a single :class:`ChurnStep` — one
    atomic churn event the scheduler reacts to once — and recover together,
    unless ``permanent=True`` (the whole rack is gone for good).

    Groups are sampled without replacement from ``nodes`` (default: all
    nodes), so passing the non-source tier keeps pinned video sources out of
    the blast radius. Independent per-node failure traces never produce this
    correlated pattern, and it is exactly what stresses migration: a single
    step can knock out every replicaful placement choice a job had."""
    pool = list(range(net.n_nodes)) if nodes is None else sorted(nodes)
    n_pick = min(n_groups * group_size, len(pool))
    chosen = [pool[int(c)] for c in rng.choice(len(pool), size=n_pick, replace=False)]
    groups = [
        sorted(chosen[g * group_size : (g + 1) * group_size])
        for g in range(len(chosen) // max(group_size, 1))
    ]
    steps: list[ChurnStep] = []
    for group in groups:
        if not group:
            continue
        t = rng.exponential(mtbf)
        while t < t_end:
            down = rng.exponential(mttr)
            steps.append(
                ChurnStep(t, tuple(ChurnOp("fail_node", node=n) for n in group))
            )
            if permanent:
                break
            steps.append(
                ChurnStep(
                    t + down, tuple(ChurnOp("recover_node", node=n) for n in group)
                )
            )
            t += down + rng.exponential(mtbf)
    return sorted(steps, key=lambda s: s.time)


def mmpp_dip_trace(
    net: NetworkGraph,
    rng: np.random.RandomState,
    *,
    t_end: float,
    dip_frac: float = 0.3,
    dwell_up: float = 15.0,
    dwell_dip: float = 4.0,
    subset_frac: float = 0.35,
) -> list[ChurnStep]:
    """Markov-modulated correlated bandwidth dips: a two-state process picks
    a fixed random link subset (a congested region) whose capacity drops to
    ``dip_frac`` of base while the dip state dwells, then restores — the
    cross-link-correlated congestion pattern independent per-link walks never
    produce."""
    n_sub = max(1, int(round(subset_frac * len(net.links))))
    subset = sorted(int(c) for c in rng.choice(len(net.links), size=n_sub, replace=False))
    steps: list[ChurnStep] = []
    t = rng.exponential(dwell_up)
    while t < t_end:
        down = rng.exponential(dwell_dip)
        dip_ops = tuple(
            ChurnOp("capacity", link=net.links[l], capacity=float(net.base_capacity[l] * dip_frac))
            for l in subset
        )
        lift_ops = tuple(
            ChurnOp("capacity", link=net.links[l], capacity=float(net.base_capacity[l]))
            for l in subset
        )
        steps.append(ChurnStep(t, dip_ops))
        steps.append(ChurnStep(t + down, lift_ops))
        t += down + rng.exponential(dwell_up)
    return steps


def churn_trace(
    net: NetworkGraph,
    rng: np.random.RandomState,
    *,
    t_end: float,
    drift: bool = True,
    failures: bool = True,
    node_failures: bool = True,
    dips: bool = True,
) -> list[ChurnStep]:
    """The default combined trace: drift + link/node failures + MMPP dips,
    merged in time order (ties keep generator order, so application is
    deterministic). Processes draw from one shared ``rng`` sequentially, so
    a given (net, seed) always produces the same trace."""
    steps: list[ChurnStep] = []
    if drift:
        steps += capacity_drift_trace(net, rng, t_end=t_end)
    if failures:
        steps += link_failure_trace(net, rng, t_end=t_end)
    if node_failures:
        steps += node_failure_trace(net, rng, t_end=t_end)
    if dips:
        steps += mmpp_dip_trace(net, rng, t_end=t_end)
    return sorted(steps, key=lambda s: s.time)


def compute_nodes(net: NetworkGraph, *, min_mem: float = 0.5) -> list[int]:
    """Nodes that can actually host tasks (and thus pin video sources) —
    transit switches in fabric topologies have no memory."""
    return [i for i in range(net.n_nodes) if net.mem_max[i] >= min_mem]


def random_flow_sets(
    net: NetworkGraph,
    n_instances: int,
    n_flows: int,
    *,
    seed: int = 0,
    volume_range: tuple[float, float] = (0.5, 4.0),
) -> list[list[Flow]]:
    """N independent random flow sets on one topology — the canonical input
    for fleet-style batched-JRBA experiments (shared by benchmarks/tests)."""
    sets: list[list[Flow]] = []
    for s in range(n_instances):
        rng = np.random.RandomState(seed + 100 * s)
        flows = []
        for i in range(n_flows):
            u, v = rng.choice(net.n_nodes, size=2, replace=False)
            flows.append(Flow(int(u), int(v), float(rng.uniform(*volume_range)), job_id=i))
        sets.append(flows)
    return sets


# ---------------------------------------------------------------------------
# Topology generators
# ---------------------------------------------------------------------------
def hierarchical_edge_cloud(
    n_edge: int = 12,
    n_agg: int = 3,
    n_cloud: int = 1,
    *,
    edge_bw: float = 1.0,
    agg_bw: float = 4.0,
    core_bw: float = 12.0,
    rng: np.random.RandomState | None = None,
) -> NetworkGraph:
    """Three-tier edge -> aggregation -> cloud tree (plus an aggregation ring
    for path diversity). Node ids: edges, then aggs, then clouds."""
    rng = rng or np.random.RandomState(0)
    power = [float(rng.choice([10.0, 20.0, 40.0])) for _ in range(n_edge)]
    mem = [float(rng.choice([1.0, 2.0, 4.0])) for _ in range(n_edge)]
    power += [80.0] * n_agg + [400.0] * n_cloud
    mem += [8.0] * n_agg + [64.0] * n_cloud
    agg0, cloud0 = n_edge, n_edge + n_agg
    links: list[tuple[int, int, float]] = []
    for e in range(n_edge):
        links.append((e, agg0 + e % n_agg, edge_bw * float(rng.uniform(0.7, 1.3))))
    for a in range(n_agg):
        if n_agg > 1:
            links.append((agg0 + a, agg0 + (a + 1) % n_agg, agg_bw))
        for c in range(n_cloud):
            links.append((agg0 + a, cloud0 + c, core_bw))
    # the ring wraps onto itself for n_agg == 2; dedup handled by NetworkGraph
    return NetworkGraph(power, mem, links)


def wan_mesh(
    n_nodes: int = 16,
    *,
    alpha: float = 0.4,
    beta: float = 0.3,
    mean_bandwidth: float = 2.0,
    rng: np.random.RandomState | None = None,
) -> NetworkGraph:
    """Waxman random geometric graph: P(link) = alpha * exp(-d / (beta * D)).
    Bandwidth decays with distance (long WAN hauls are thin). A nearest-
    neighbour chain guarantees connectivity."""
    rng = rng or np.random.RandomState(0)
    xy = rng.uniform(0.0, 1.0, size=(n_nodes, 2))
    dmax = float(np.sqrt(2.0))
    links: dict[tuple[int, int], float] = {}

    def bw(d: float) -> float:
        return mean_bandwidth * (1.5 - d / dmax) * float(rng.uniform(0.8, 1.2))

    for i in range(1, n_nodes):  # chain each node to its nearest predecessor
        d = np.linalg.norm(xy[:i] - xy[i], axis=1)
        j = int(np.argmin(d))
        links[(j, i)] = bw(float(d[j]))
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            d = float(np.linalg.norm(xy[i] - xy[j]))
            if rng.uniform() < alpha * np.exp(-d / (beta * dmax)):
                links.setdefault((i, j), bw(d))
    klass = rng.randint(4, size=n_nodes)
    power = [(10.0, 40.0, 80.0, 200.0)[k] for k in klass]
    mem = [(2.0, 4.0, 8.0, 64.0)[k] for k in klass]
    return NetworkGraph(power, mem, [(u, v, b) for (u, v), b in links.items()])


def fat_tree(
    k: int = 4,
    *,
    host_bw: float = 1.0,
    agg_bw: float = 2.0,
    core_bw: float = 4.0,
    host_power: float = 40.0,
    host_mem: float = 8.0,
) -> NetworkGraph:
    """k-ary fat-tree (k even): k pods of k/2 edge + k/2 aggregation
    switches, (k/2)^2 core switches, k^3/4 hosts. Only hosts have memory, so
    tasks land on hosts and switches stay pure transit (their tiny-but-
    positive power avoids divide-by-zero in placement scoring)."""
    if k % 2:
        raise ValueError("fat-tree arity k must be even")
    half = k // 2
    n_hosts = k * half * half
    n_edge = n_agg = k * half
    n_core = half * half
    host0, edge0, agg0, core0 = 0, n_hosts, n_hosts + n_edge, n_hosts + n_edge + n_agg
    power = [host_power] * n_hosts + [1e-3] * (n_edge + n_agg + n_core)
    mem = [host_mem] * n_hosts + [0.0] * (n_edge + n_agg + n_core)
    links: list[tuple[int, int, float]] = []
    for pod in range(k):
        for e in range(half):
            edge_sw = edge0 + pod * half + e
            for h in range(half):
                links.append((host0 + (pod * half + e) * half + h, edge_sw, host_bw))
            for a in range(half):
                links.append((edge_sw, agg0 + pod * half + a, agg_bw))
        for a in range(half):
            for c in range(half):
                links.append((agg0 + pod * half + a, core0 + a * half + c, core_bw))
    return NetworkGraph(power, mem, links)


def heterogeneous_mesh(
    n_nodes: int = 16,
    *,
    spread: float = 1.0,
    mean_power: float = 50.0,
    mean_bandwidth: float = 1.5,
    rng: np.random.RandomState | None = None,
) -> NetworkGraph:
    """Random mesh with log-normal node power: ``spread`` is the sigma of
    log-power, sweeping near-homogeneous (0.1) to extreme (2.0) fleets."""
    rng = rng or np.random.RandomState(0)
    base = random_edge_network(n_nodes, mean_bandwidth=mean_bandwidth, rng=rng)
    power = mean_power * np.exp(rng.normal(0.0, spread, size=n_nodes))
    mem = np.clip(power / 10.0, 1.0, 64.0)
    links = [(u, v, float(base.capacity[i])) for i, (u, v) in enumerate(base.links)]
    return NetworkGraph(power.tolist(), mem.tolist(), links)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scenario:
    """A reproducible (topology, workload) pair for fleet evaluation, plus an
    optional churn-trace factory for dynamic-network scenarios."""

    name: str
    description: str
    make_net: Callable[[np.random.RandomState], NetworkGraph]
    make_arrivals: Callable[[NetworkGraph, np.random.RandomState, int], Arrivals]
    # (net, rng, t_end) -> churn trace; None for static-network scenarios
    make_churn: Callable[[NetworkGraph, np.random.RandomState, float], list[ChurnStep]] | None = (
        None
    )

    def build(
        self, *, seed: int = 0, n_jobs: int = 8
    ) -> tuple[NetworkGraph, Arrivals]:
        net = self.make_net(np.random.RandomState(seed))
        arrivals = self.make_arrivals(net, np.random.RandomState(seed + 1), n_jobs)
        return net, arrivals

    def build_churn(
        self, *, seed: int = 0, n_jobs: int = 8, churn_margin: float = 1.25
    ) -> tuple[NetworkGraph, Arrivals, list[ChurnStep]]:
        """Like :meth:`build` but also generates the churn trace, spanning
        the arrival horizon times ``churn_margin`` so churn keeps hitting the
        backlog-draining tail of the simulation. Static scenarios return an
        empty trace."""
        net, arrivals = self.build(seed=seed, n_jobs=n_jobs)
        if self.make_churn is None:
            return net, arrivals, []
        t_end = (max(t for t, _, _ in arrivals) if arrivals else 0.0) * churn_margin + 10.0
        churn = self.make_churn(net, np.random.RandomState(seed + 2), t_end)
        return net, arrivals, churn


def _steady(lam: float = 0.5, total_units: float = 12.0):
    def make(net: NetworkGraph, rng: np.random.RandomState, n_jobs: int) -> Arrivals:
        return poisson_arrivals(
            n_jobs,
            net.n_nodes,
            rng,
            lam=lam,
            total_units=total_units,
            source_nodes=compute_nodes(net),
        )

    return make


def _bursty(lam_burst: float = 3.0, total_units: float = 12.0):
    def make(net: NetworkGraph, rng: np.random.RandomState, n_jobs: int) -> Arrivals:
        return poisson_burst_arrivals(
            n_jobs,
            net.n_nodes,
            rng,
            lam_burst=lam_burst,
            total_units=total_units,
            source_nodes=compute_nodes(net),
        )

    return make


def _chaos_source_tier(net: NetworkGraph) -> list[int]:
    """The protected sensor tier of the node-chaos scenario: the first
    quarter of the compute nodes. Cameras (pinned sources) live here and the
    blast-radius trace never touches it — a job whose *source* hardware dies
    is unmigratable by construction (the data feed itself is gone), which is
    a different failure mode than the one this scenario isolates."""
    nodes = compute_nodes(net)
    return nodes[: max(2, len(nodes) // 4)]


def _chaos_arrivals(net: NetworkGraph, rng: np.random.RandomState, n_jobs: int) -> Arrivals:
    return poisson_arrivals(
        n_jobs,
        net.n_nodes,
        rng,
        lam=1.0,
        total_units=40.0,
        source_nodes=_chaos_source_tier(net),
    )


def _chaos_churn(net: NetworkGraph, rng: np.random.RandomState, t_end: float) -> list[ChurnStep]:
    protected = set(_chaos_source_tier(net))
    return correlated_failure_trace(
        net,
        rng,
        t_end=t_end,
        n_groups=2,
        group_size=3,
        mtbf=2.5,
        permanent=True,
        nodes=[n for n in range(net.n_nodes) if n not in protected],
    )


SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in [
        Scenario(
            "edge-mesh",
            "paper Sec. VI random mesh, steady Poisson arrivals",
            lambda rng: random_edge_network(14, mean_bandwidth=1.0, rng=rng),
            _steady(),
        ),
        Scenario(
            "edge-mesh-burst",
            "paper mesh under Markov-modulated flash crowds",
            lambda rng: random_edge_network(14, mean_bandwidth=1.0, rng=rng),
            _bursty(),
        ),
        Scenario(
            "edge-mesh-flash",
            "paper mesh under a sustained MMPP flash crowd: arrivals outpace "
            "completions, so scheduling rounds see deep waiting queues (the "
            "intra-round speculative-batching regime)",
            lambda rng: random_edge_network(14, mean_bandwidth=1.0, rng=rng),
            _bursty(lam_burst=6.0),
        ),
        Scenario(
            "edge-mesh-flash-churn",
            "the adversarial composition for churn-resilient speculation: a "
            "sustained MMPP flash crowd (deep waiting queues, the regime "
            "where intra-round batching pays) on a wide mesh whose links "
            "drift, dip, and fail under the running jobs — every churn step "
            "both re-solves affected running jobs and stresses which queued "
            "speculations the footprint-scoped invalidation can keep. The "
            "mesh is larger (32 nodes, degree ~4) and the per-step churn "
            "sparser than the default trace so that concurrent jobs' link "
            "footprints are only partially overlapping: wide drift steps "
            "touch many jobs at once without every commit invalidating the "
            "next job's speculation (total overlap pins the batched re-solve "
            "at sequential cost; zero overlap measures nothing). Node "
            "failures are left out: whole-node outages stall pinned sources "
            "for long stretches and drown the capacity-churn signal this "
            "scenario exists to measure.",
            lambda rng: random_edge_network(
                32, avg_degree=4.0, mean_bandwidth=1.0, rng=rng
            ),
            _bursty(lam_burst=10.0),
            make_churn=lambda net, rng, t_end: sorted(
                capacity_drift_trace(net, rng, t_end=t_end, frac=0.08)
                + link_failure_trace(net, rng, t_end=t_end)
                + mmpp_dip_trace(net, rng, t_end=t_end, subset_frac=0.1),
                key=lambda s: s.time,
            ),
        ),
        Scenario(
            "edge-mesh-node-chaos",
            "permanent blast-radius node failures under running jobs: a "
            "24-node mesh whose sources pin to a protected sensor tier while "
            "two 3-node compute racks die for good (correlated_failure_trace "
            "with permanent=True, mtbf short enough to land mid-workload). "
            "Without migration every running job placed on a dead rack "
            "stalls forever (unfinished > 0); with a stall budget the "
            "scheduler re-runs Algorithm 1 over the survivors, pays the "
            "data-transfer penalty, and finishes everything — the scenario "
            "the migration bench section gates.",
            lambda rng: random_edge_network(
                24, avg_degree=4.0, mean_bandwidth=1.2, rng=rng
            ),
            _chaos_arrivals,
            make_churn=_chaos_churn,
        ),
        Scenario(
            "edge-cloud",
            "three-tier edge/aggregation/cloud hierarchy",
            lambda rng: hierarchical_edge_cloud(12, 3, 1, rng=rng),
            _steady(),
        ),
        Scenario(
            "wan-mesh",
            "Waxman WAN federation, bursty arrivals",
            lambda rng: wan_mesh(16, rng=rng),
            _bursty(),
        ),
        Scenario(
            "wan-mesh-churn",
            "Waxman WAN federation under network churn: per-link capacity "
            "drift, link/node failure+recovery cycles, and MMPP-correlated "
            "bandwidth dips — the dynamic geo-distributed regime (Oakestra, "
            "KCES) where the scheduler must re-route and re-solve running "
            "jobs as the network moves under them",
            lambda rng: wan_mesh(16, rng=rng),
            _bursty(),
            make_churn=lambda net, rng, t_end: churn_trace(net, rng, t_end=t_end),
        ),
        Scenario(
            "wan-mesh-xl",
            "Oakestra-scale Waxman WAN (64 sites, ~300 links): the large-L "
            "regime where the dense JRBA formulation pays for every link on "
            "every solver step and the sparse active-link compression wins "
            "by an order of magnitude",
            lambda rng: wan_mesh(64, rng=rng),
            _bursty(),
        ),
        Scenario(
            "fat-tree",
            "k=4 data-center fabric, compute at hosts only",
            lambda rng: fat_tree(4),
            _steady(lam=1.0),
        ),
        Scenario(
            "hetero-low",
            "near-homogeneous node power (sigma=0.2)",
            lambda rng: heterogeneous_mesh(16, spread=0.2, rng=rng),
            _steady(),
        ),
        Scenario(
            "hetero-high",
            "extreme node-power spread (sigma=1.5)",
            lambda rng: heterogeneous_mesh(16, spread=1.5, rng=rng),
            _steady(),
        ),
    ]
}


def scenario_names() -> list[str]:
    return sorted(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; one of {scenario_names()}") from None
