"""Graph models for ENTS: job DAGs and the edge network.

The paper (Sec. V-A) models:
  * the network as an undirected graph G=(V, E) with per-node compute power
    ``PS_j``, max/available memory ``R_max/R_avail`` and per-link bandwidth
    ``B_l``;
  * a job as a DAG J=(T, P) with per-task workload ``C_i`` and memory demand
    ``R_req``, per-edge dependent-data volume ``D_ij``, plus a pinned data
    source emitting ``input_size`` units into the entry tasks.

On TPU the same structures describe a pod: nodes are chips/hosts/submeshes,
links are ICI (or DCN) edges, and a "job" is a model stage graph (see
``core/placement.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Task",
    "JobGraph",
    "NetworkGraph",
    "Flow",
    "random_edge_network",
    "torus_network",
]


@dataclasses.dataclass(frozen=True)
class Task:
    """One functional module of a job (paper Fig. 4/5)."""

    name: str
    workload: float  # C_i, abstract compute units (or FLOPs for ML stages)
    mem: float = 0.0  # R_req
    pinned_node: int | None = None  # data sources are pinned (paper: `source`)


@dataclasses.dataclass
class JobGraph:
    """A DAG of dependent tasks. Edges carry dependent-data volume D_ij."""

    tasks: list[Task]
    edges: list[tuple[int, int, float]]  # (u, v, volume)
    name: str = "job"

    def __post_init__(self) -> None:
        n = len(self.tasks)
        for u, v, vol in self.edges:
            if not (0 <= u < n and 0 <= v < n):
                raise ValueError(f"edge ({u},{v}) out of range for {n} tasks")
            if u == v:
                raise ValueError("self-loop in job graph")
            if vol < 0:
                raise ValueError("negative data volume")
        order = self.topological_order()
        if order is None:
            raise ValueError("job graph has a cycle")

    # -- structure ---------------------------------------------------------
    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def predecessors(self, i: int) -> list[tuple[int, float]]:
        """Pd_i with data volumes."""
        return [(u, vol) for u, v, vol in self.edges if v == i]

    def successors(self, i: int) -> list[tuple[int, float]]:
        return [(v, vol) for u, v, vol in self.edges if u == i]

    def topological_order(self) -> list[int] | None:
        n = self.n_tasks
        indeg = [0] * n
        adj: list[list[int]] = [[] for _ in range(n)]
        for u, v, _ in self.edges:
            indeg[v] += 1
            adj[u].append(v)
        stack = [i for i in range(n) if indeg[i] == 0]
        order: list[int] = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in adj[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        return order if len(order) == n else None

    @property
    def total_workload(self) -> float:
        return float(sum(t.workload for t in self.tasks))

    @property
    def total_mem(self) -> float:
        return float(sum(t.mem for t in self.tasks))


@dataclasses.dataclass(frozen=True)
class Flow:
    """A cross-node data flow produced by a task allocation (paper Sec. V-C2).

    ``volume`` is the per-stream-unit data size V_i; ``job_id``/``edge`` keep
    provenance so the online scheduler (OTFA) can re-adjust running flows.
    """

    src: int  # source network node
    dst: int  # destination network node
    volume: float  # V_i
    job_id: int = -1
    edge: tuple[int, int] = (-1, -1)  # (task_u, task_v) in the job graph


class NetworkGraph:
    """Undirected capacitated mesh of heterogeneous nodes.

    Node attributes: ``power`` (PS_j), ``mem_max``/``mem_avail`` (R^j).
    Link attribute: ``bandwidth`` (B_l); residual tracked separately so the
    online scheduler can allocate/release.

    The link *set* is fixed at construction (``links``/``link_index`` and the
    length of ``capacity`` never change — every tensor program and cache in
    the repo is shaped by L), but the network is otherwise mutable: the churn
    API below drifts per-link capacity and fails/recovers links and nodes in
    place. Failures keep the link's array slot (capacity 0, ``link_alive``
    False) and only remove it from the adjacency, so routing stops seeing it
    while solver shapes stay stable. ``topology_version`` bumps on any
    adjacency change — caches of candidate paths (the engine's per-net path
    and program caches) are only valid within one topology epoch.
    """

    def __init__(
        self,
        power: Sequence[float],
        mem: Sequence[float],
        links: Iterable[tuple[int, int, float]],
    ) -> None:
        self.power = np.asarray(power, dtype=np.float64)
        self.mem_max = np.asarray(mem, dtype=np.float64)
        if self.power.shape != self.mem_max.shape:
            raise ValueError("power/mem length mismatch")
        self.mem_avail = self.mem_max.copy()
        self.n_nodes = len(self.power)
        # canonical link key: (min(u,v), max(u,v))
        self.bandwidth: dict[tuple[int, int], float] = {}
        self._adj: dict[int, set[int]] = {i: set() for i in range(self.n_nodes)}
        for u, v, bw in links:
            if u == v:
                raise ValueError("self-link")
            key = (min(u, v), max(u, v))
            self.bandwidth[key] = float(bw)
            self._adj[u].add(v)
            self._adj[v].add(u)
        self.links: list[tuple[int, int]] = sorted(self.bandwidth)
        self.link_index = {l: i for i, l in enumerate(self.links)}
        self.capacity = np.array([self.bandwidth[l] for l in self.links])
        self.residual = self.capacity.copy()
        # churn state: construction-time capacities (the drift anchor and the
        # restore_topology target), per-link liveness, and the capacity each
        # dead link held at failure (what recovery restores by default)
        self.base_capacity = self.capacity.copy()
        self.link_alive = np.ones(len(self.links), dtype=bool)
        self.topology_version = 0
        # bumps on every live-capacity mutation (drift, failure, recovery,
        # restore) — the validity key for derived-value memos like the
        # avg-path-bandwidth cache, which may only serve a stored value
        # computed at the current version
        self.capacity_version = 0
        self._failed_capacity: dict[int, float] = {}

    # -- helpers -----------------------------------------------------------
    def neighbors(self, u: int) -> set[int]:
        return self._adj[u]

    def link_id(self, u: int, v: int) -> int:
        return self.link_index[(min(u, v), max(u, v))]

    def reset_residual(self) -> None:
        self.residual = self.capacity.copy()
        self.mem_avail = self.mem_max.copy()

    def clone_state(self) -> tuple[np.ndarray, np.ndarray]:
        return self.residual.copy(), self.mem_avail.copy()

    def restore_state(self, state: tuple[np.ndarray, np.ndarray]) -> None:
        self.residual, self.mem_avail = state[0].copy(), state[1].copy()

    # -- churn: capacity drift + link/node failure & recovery ----------------
    def _drop_host_caches(self) -> None:
        """Full invalidation of host-side memos keyed on topology (currently
        the avg-path-bandwidth path memo used by Algorithm 1 — it stores
        pinned shortest *paths*, values read through to live capacity).
        Needed when the adjacency gains links: a recovery can create a
        shorter path between any pair, so no pinned path is provably still
        shortest. Capacity drift never calls this — the memo is
        capacity-oblivious by construction."""
        cache = getattr(self, "_avg_bw_cache", None)
        if cache:
            cache.clear()

    def _prune_host_caches(self, link: int) -> None:
        """Footprint-scoped invalidation of host-side memos after ``link``
        failed: drop exactly the (src, dst) pairs whose pinned shortest path
        crossed the dead link. Pairs whose path avoided it provably keep a
        valid pin (removing an off-path link only deletes *other* paths), and
        already-disconnected pairs stay disconnected (a failure cannot
        reconnect anything)."""
        cache = getattr(self, "_avg_bw_cache", None)
        if cache:
            stale = [pair for pair, links in cache.items() if links and link in links]
            for pair in stale:
                del cache[pair]

    def set_link_capacity(self, u: int, v: int, bw: float) -> None:
        """Drift one link's live capacity in place (the link set and L are
        unchanged, so compiled solver shapes and program tensors stay valid —
        only the capacity vector moves). Setting capacity on a dead link
        updates the value recovery will restore instead."""
        if bw < 0:
            raise ValueError("negative link capacity")
        key = (min(u, v), max(u, v))
        l = self.link_index[key]
        if not self.link_alive[l]:
            self._failed_capacity[l] = float(bw)
            return
        self.bandwidth[key] = float(bw)
        self.capacity[l] = bw
        self.capacity_version += 1
        # no host-cache action: the avg-bw memo pins paths, not values, and
        # reads capacity live (re-deriving per-pair values lazily off
        # capacity_version) — drift is visible to the next query for free

    def fail_link(self, u: int, v: int) -> bool:
        """Take a link down: remove it from the adjacency (routing stops
        seeing it) and zero its capacity, keeping its array slot so L-shaped
        tensors stay valid. Returns False if the link was already dead."""
        key = (min(u, v), max(u, v))
        l = self.link_index[key]
        if not self.link_alive[l]:
            return False
        self._failed_capacity[l] = float(self.capacity[l])
        self.link_alive[l] = False
        self.capacity[l] = 0.0
        self.bandwidth[key] = 0.0
        self._adj[u].discard(v)
        self._adj[v].discard(u)
        self.topology_version += 1
        self.capacity_version += 1
        self._prune_host_caches(l)
        return True

    def recover_link(self, u: int, v: int, capacity: float | None = None) -> bool:
        """Bring a dead link back at ``capacity`` (default: its capacity at
        failure, as later drifted by :meth:`set_link_capacity`). Returns
        False if the link was already alive."""
        key = (min(u, v), max(u, v))
        l = self.link_index[key]
        if self.link_alive[l]:
            return False
        bw = self._failed_capacity.pop(l) if capacity is None else float(capacity)
        self.link_alive[l] = True
        self.capacity[l] = bw
        self.bandwidth[key] = bw
        self._adj[u].add(v)
        self._adj[v].add(u)
        self.topology_version += 1
        self.capacity_version += 1
        self._drop_host_caches()
        return True

    def fail_node(self, node: int) -> list[int]:
        """Take a node down by failing every live incident link (the node
        becomes unreachable; its memory bookkeeping is untouched — jobs
        pinned or already placed there simply stall until recovery).
        Returns the failed link ids."""
        failed = []
        for peer in sorted(self._adj[node].copy()):
            if self.fail_link(node, peer):
                failed.append(self.link_id(node, peer))
        return failed

    def recover_node(self, node: int) -> list[int]:
        """Revive every dead link incident to ``node`` (the node's ports come
        back; a link whose far end is itself down stays down only if that
        end's links were failed separately — link state is tracked per link).
        Returns the recovered link ids."""
        recovered = []
        for l, (u, v) in enumerate(self.links):
            if node in (u, v) and not self.link_alive[l]:
                self.recover_link(u, v)
                recovered.append(l)
        return recovered

    def restore_topology(self) -> None:
        """Undo all churn: revive every dead link and reset capacities to
        their construction-time values. Used to make re-runs on a mutated
        network reproducible (``OnlineScheduler.step`` calls this when given
        a churn trace, mirroring ``reset_residual``). Always bumps
        ``topology_version``: candidate-path enumeration tie-breaks on live
        bandwidth, so caches built while capacities were drifted are not the
        pristine-network caches even when every link is already alive."""
        for l, (u, v) in enumerate(self.links):
            if not self.link_alive[l]:
                self._adj[u].add(v)
                self._adj[v].add(u)
        self.topology_version += 1
        self.capacity_version += 1
        self.link_alive[:] = True
        self._failed_capacity.clear()
        self.capacity = self.base_capacity.copy()
        for l, key in enumerate(self.links):
            self.bandwidth[key] = float(self.capacity[l])
        self._drop_host_caches()


def random_edge_network(
    n_nodes: int,
    *,
    avg_degree: float = 3.0,
    mean_bandwidth: float = 1.0,
    bandwidth_var: float = 0.3,
    power_choices: Sequence[float] = (10.0, 40.0, 80.0, 200.0),
    mem_choices: Sequence[float] = (1.0, 4.0, 8.0, 64.0),
    rng: np.random.RandomState | None = None,
) -> NetworkGraph:
    """Paper Sec. VI-A4: random connected mesh, average node degree ~3,
    link bandwidth ~ N(mean, var) (clipped positive), heterogeneous nodes
    drawn from Raspberry-Pi/Jetson/server-like classes (Tab. I)."""
    rng = rng or np.random.RandomState(0)
    # random spanning tree guarantees connectivity
    links: set[tuple[int, int]] = set()
    perm = rng.permutation(n_nodes)
    for i in range(1, n_nodes):
        u = int(perm[i])
        v = int(perm[rng.randint(i)])
        links.add((min(u, v), max(u, v)))
    target = int(avg_degree * n_nodes / 2)
    pairs = list(itertools.combinations(range(n_nodes), 2))
    rng.shuffle(pairs)
    for u, v in pairs:
        if len(links) >= target:
            break
        links.add((u, v))
    bws = np.clip(
        rng.normal(mean_bandwidth, np.sqrt(bandwidth_var), size=len(links)),
        0.1 * mean_bandwidth,
        None,
    )
    klass = rng.randint(len(power_choices), size=n_nodes)
    power = [power_choices[k] for k in klass]
    mem = [mem_choices[k] for k in klass]
    return NetworkGraph(power, mem, [(u, v, b) for (u, v), b in zip(sorted(links), bws)])


def torus_network(
    rows: int,
    cols: int,
    *,
    link_bw: float = 50.0,  # GB/s per ICI link (v5e-like)
    node_power: float = 197.0,  # TFLOP/s bf16 per chip
    node_mem: float = 16.0,  # GB HBM per chip
    pods: int = 1,
    dcn_bw: float = 6.25,  # GB/s per host-pair across DCN (adaptation note in DESIGN.md)
) -> NetworkGraph:
    """TPU-pod adaptation: a 2-D torus of chips per pod; pods bridged by DCN.

    Used by ``core/placement.py`` when ENTS schedules ML stage graphs onto a
    pod. Node ids: pod p, row r, col c -> p*rows*cols + r*cols + c.
    """
    n_per_pod = rows * cols
    links: list[tuple[int, int, float]] = []

    def nid(p: int, r: int, c: int) -> int:
        return p * n_per_pod + r * cols + c

    for p in range(pods):
        for r in range(rows):
            for c in range(cols):
                u = nid(p, r, c)
                if cols > 1:
                    links.append((u, nid(p, r, (c + 1) % cols), link_bw))
                if rows > 1:
                    links.append((u, nid(p, (r + 1) % rows, c), link_bw))
    # wrap-around duplicates for 2-wide dims collapse via canonical keys
    for p in range(pods - 1):
        # one DCN uplink per row (models per-host NICs rather than full bisection)
        for r in range(rows):
            links.append((nid(p, r, 0), nid(p + 1, r, 0), dcn_bw))
    n = pods * n_per_pod
    dedup: dict[tuple[int, int], float] = {}
    for u, v, b in links:
        key = (min(u, v), max(u, v))
        dedup[key] = max(dedup.get(key, 0.0), b)
    return NetworkGraph(
        [node_power] * n,
        [node_mem] * n,
        [(u, v, b) for (u, v), b in dedup.items()],
    )
