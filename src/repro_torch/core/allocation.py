"""Task allocation: paper Algorithm 1 plus the LR / BR / TP baselines.

All allocators return an ``Allocation`` (task -> node) and the induced
cross-node ``Flow`` list. Throughput evaluation for a *fixed* routing and
bandwidth policy lives here too (Eqs. 1-4), so every scheduling policy in the
repo is scored by the same exact model.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import Flow, JobGraph, NetworkGraph
from .paths import avg_path_bandwidth, dijkstra, path_links

__all__ = [
    "Allocation",
    "COLOCATED_BANDWIDTH",
    "allocate_greedy",
    "allocate_whole_job_lr",
    "allocate_whole_job_br",
    "flows_from_assignment",
    "equal_share_bandwidth",
    "job_span",
    "throughput",
]


@dataclasses.dataclass
class Allocation:
    """Task allocation policy T_{i,j} for one job, as an index vector."""

    job: JobGraph
    assignment: np.ndarray  # (n_tasks,) node index per task
    feasible: bool = True


def flows_from_assignment(job: JobGraph, assignment: np.ndarray, job_id: int = -1) -> list[Flow]:
    """Line 15 of Algo 1: dependent tasks on distinct nodes create a flow."""
    flows = []
    for u, v, vol in job.edges:
        su, sv = int(assignment[u]), int(assignment[v])
        if su != sv and vol > 0:
            flows.append(Flow(su, sv, vol, job_id=job_id, edge=(u, v)))
    return flows


# ---------------------------------------------------------------------------
# Algorithm 1 — greedy joint-aware task allocation
# ---------------------------------------------------------------------------
def allocate_greedy(
    net: NetworkGraph, job: JobGraph, *, job_id: int = -1, commit: bool = True
) -> tuple[Allocation, list[Flow]]:
    """Paper Algo 1.

    Tasks are visited in topological order; each goes to the feasible node
    minimizing ``t_comp + t_comm`` where ``t_comm`` uses the average
    bandwidth of the shortest route from each already-placed predecessor
    (fine-grained routing/bandwidth is JRBA's job, Sec. V-C1).
    """
    order = job.topological_order()
    assert order is not None
    assignment = np.full(job.n_tasks, -1, dtype=np.int64)
    mem = net.mem_avail.copy()
    feasible = True
    for i in order:
        task = job.tasks[i]
        if task.pinned_node is not None:
            # pinned tasks (data sources — cameras streaming from their own
            # hardware) don't draw from the schedulable memory pool: the
            # online finish handler deliberately skips them when crediting
            # memory back, so debiting here would leak memory on every
            # pinned job (admission debit must equal finish credit)
            assignment[i] = task.pinned_node
            continue
        best_j, best_t = -1, float("inf")
        for j in range(net.n_nodes):
            if mem[j] < task.mem:
                continue
            t_comp = task.workload / net.power[j]
            t_comm = 0.0
            for p, vol in job.predecessors(i):
                if assignment[p] < 0:
                    continue
                bw = avg_path_bandwidth(net, int(assignment[p]), j)
                if bw == 0.0:
                    t_comm = float("inf")
                    break
                t_comm = max(t_comm, 0.0 if bw == float("inf") else vol / bw)
            t_exec = t_comp + t_comm
            if t_exec < best_t:
                best_t, best_j = t_exec, j
        if best_j < 0:
            feasible = False
            break
        assignment[i] = best_j
        mem[best_j] -= task.mem
    alloc = Allocation(job, assignment, feasible)
    if feasible and commit:
        net.mem_avail = mem
    return alloc, (flows_from_assignment(job, assignment, job_id) if feasible else [])


# ---------------------------------------------------------------------------
# Kubernetes-style whole-job baselines (paper Sec. VI-A2)
# ---------------------------------------------------------------------------
def _whole_job_flows(job: JobGraph, node: int, job_id: int) -> list[Flow]:
    assignment = np.full(job.n_tasks, node, dtype=np.int64)
    for i, t in enumerate(job.tasks):
        if t.pinned_node is not None:
            assignment[i] = t.pinned_node
    return flows_from_assignment(job, assignment, job_id), assignment  # type: ignore[return-value]


def allocate_whole_job_lr(
    net: NetworkGraph, job: JobGraph, *, job_id: int = -1, commit: bool = True
) -> tuple[Allocation, list[Flow]]:
    """LeastRequestedPriority: the whole job goes to the feasible node with
    the least-requested fraction (ties broken toward more absolute free
    memory, i.e. the larger node)."""
    demand = sum(t.mem for t in job.tasks if t.pinned_node is None)
    frac = net.mem_avail / np.maximum(net.mem_max, 1e-9)
    tie = net.mem_avail / max(float(net.mem_avail.max()), 1e-9)
    scores = np.where(net.mem_avail >= demand, frac + 1e-6 * tie, -1.0)
    node = int(np.argmax(scores))
    if scores[node] < 0:
        return Allocation(job, np.full(job.n_tasks, -1), False), []
    flows, assignment = _whole_job_flows(job, node, job_id)
    if commit:
        net.mem_avail[node] -= demand
    return Allocation(job, assignment), flows


def allocate_whole_job_br(
    net: NetworkGraph, job: JobGraph, *, job_id: int = -1, commit: bool = True
) -> tuple[Allocation, list[Flow]]:
    """BalancedResourceAllocation: place the whole job so post-placement
    utilization stays closest to the cluster mean (workload balancing)."""
    demand = sum(t.mem for t in job.tasks if t.pinned_node is None)
    util = 1.0 - net.mem_avail / np.maximum(net.mem_max, 1e-9)
    post = util + demand / np.maximum(net.mem_max, 1e-9)
    target = float(np.mean(util))
    scores = np.where(net.mem_avail >= demand, -np.abs(post - target), -np.inf)
    node = int(np.argmax(scores))
    if not np.isfinite(scores[node]):
        return Allocation(job, np.full(job.n_tasks, -1), False), []
    flows, assignment = _whole_job_flows(job, node, job_id)
    if commit:
        net.mem_avail[node] -= demand
    return Allocation(job, assignment), flows


# ---------------------------------------------------------------------------
# TP baseline routing/bandwidth: shortest path + per-link equal share
# ---------------------------------------------------------------------------
# Finite bandwidth sentinel for flows whose route crosses zero links
# (co-located src == dst): the transfer is node-local and effectively free,
# but an infinite bandwidth would leak into JobRecord.bandwidths and break
# strict-JSON telemetry; any volume divided by this contributes ~0 to a span
COLOCATED_BANDWIDTH = float(np.finfo(np.float64).max)


def equal_share_bandwidth(
    net: NetworkGraph, flows: list[Flow], *, capacity: np.ndarray | None = None
) -> tuple[list[list[int]], np.ndarray]:
    """Default policy (baseline TP, and ENTS Fig. 2(d)): every flow takes the
    shortest route; flows crossing a link share its capacity equally.

    Returns (routes as node-paths, per-flow bandwidth b_i). Co-located flows
    (src == dst — a zero-link route) get the finite ``COLOCATED_BANDWIDTH``
    sentinel rather than ``inf``.
    """
    capacity = net.capacity if capacity is None else capacity
    routes: list[list[int]] = []
    link_users = np.zeros(len(net.links), dtype=np.int64)
    for f in flows:
        path = dijkstra(net, f.src, f.dst)
        if path is None:
            routes.append([])
            continue
        routes.append(path)
        for l in path_links(net, path):
            link_users[l] += 1
    bands = np.zeros(len(flows))
    for i, path in enumerate(routes):
        if not path:
            bands[i] = 0.0
            continue
        shares = [capacity[l] / link_users[l] for l in path_links(net, path)]
        bands[i] = min(shares) if shares else COLOCATED_BANDWIDTH
    return routes, bands


# ---------------------------------------------------------------------------
# Exact throughput model — Eqs. (1)-(4)
# ---------------------------------------------------------------------------
def job_span(
    net: NetworkGraph,
    alloc: Allocation,
    flows: list[Flow],
    bandwidths: np.ndarray,
    *,
    extra_node_load: np.ndarray | None = None,
) -> float:
    """t_p = max(max_u t_comp_u, max_flows V_i/b_i).

    Co-located tasks time-share their node, so per-node compute time sums
    workloads (this is how the paper's Fig. 2 computes 55/200 for the whole
    job on e1). ``extra_node_load`` carries workload already running on each
    node (units of work per stream unit) for the online multi-job setting.
    """
    if not alloc.feasible:
        return float("inf")
    load = np.zeros(net.n_nodes) if extra_node_load is None else extra_node_load.copy()
    for i, task in enumerate(alloc.job.tasks):
        load[int(alloc.assignment[i])] += task.workload
    t = float(np.max(load / net.power)) if len(load) else 0.0
    for f, b in zip(flows, bandwidths):
        t = max(t, float("inf") if b <= 0 else f.volume / b)
    return t


def throughput(
    net: NetworkGraph,
    alloc: Allocation,
    flows: list[Flow],
    bandwidths: np.ndarray,
) -> float:
    tp = job_span(net, alloc, flows, bandwidths)
    return 0.0 if tp in (0.0, float("inf")) else 1.0 / tp
