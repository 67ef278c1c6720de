"""K-shortest loopless path enumeration (Yen's algorithm) over the network.

Candidate routing paths ``P_i^k`` for each flow (paper Sec. V-C2) come from
here. Distances default to hop count with a 1/bandwidth tie-break so that,
among equally short routes, higher-capacity ones are preferred — matching the
paper's preference for uncongested paths while keeping the candidate set
small enough for the JRBA LP tensor.
"""
from __future__ import annotations

import heapq

import numpy as np

from .graph import NetworkGraph

__all__ = [
    "dijkstra",
    "k_shortest_paths",
    "path_link_index",
    "path_links",
    "avg_bw_path_links",
    "avg_path_bandwidth",
]


def _edge_cost(net: NetworkGraph, u: int, v: int, eps: float = 1e-3) -> float:
    # hop-dominant cost; 1/bw break ties toward fat links
    return 1.0 + eps / max(net.bandwidth[(min(u, v), max(u, v))], 1e-9)


def dijkstra(
    net: NetworkGraph,
    src: int,
    dst: int,
    *,
    banned_links: set[tuple[int, int]] | None = None,
    banned_nodes: set[int] | None = None,
) -> list[int] | None:
    """Shortest path src->dst as a node list, or None if disconnected."""
    banned_links = banned_links or set()
    banned_nodes = banned_nodes or set()
    if src in banned_nodes or dst in banned_nodes:
        return None
    dist = {src: 0.0}
    prev: dict[int, int] = {}
    heap = [(0.0, src)]
    seen: set[int] = set()
    while heap:
        d, u = heapq.heappop(heap)
        if u in seen:
            continue
        seen.add(u)
        if u == dst:
            break
        # sorted: neighbors is a set, and decision paths must not iterate
        # unordered collections (DT301). Order-neutral here — each v is a
        # distinct dist key and ties across nodes break on the heap's
        # (cost, node) tuple — but sorting makes that a construction-time
        # guarantee instead of a CPython-int-hashing accident.
        for v in sorted(net.neighbors(u)):
            key = (min(u, v), max(u, v))
            if v in banned_nodes or key in banned_links:
                continue
            nd = d + _edge_cost(net, u, v)
            if nd < dist.get(v, float("inf")):
                dist[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd, v))
    if dst not in seen:
        return None
    path = [dst]
    while path[-1] != src:
        path.append(prev[path[-1]])
    return path[::-1]


def k_shortest_paths(net: NetworkGraph, src: int, dst: int, k: int) -> list[list[int]]:
    """Yen's algorithm: up to k loopless paths, shortest first."""
    if src == dst:
        return [[src]]
    first = dijkstra(net, src, dst)
    if first is None:
        return []
    paths = [first]
    candidates: list[tuple[float, list[int]]] = []
    cand_set: set[tuple[int, ...]] = set()
    while len(paths) < k:
        prev_path = paths[-1]
        for i in range(len(prev_path) - 1):
            spur_node = prev_path[i]
            root = prev_path[: i + 1]
            banned_links: set[tuple[int, int]] = set()
            for p in paths:
                if p[: i + 1] == root and len(p) > i + 1:
                    u, v = p[i], p[i + 1]
                    banned_links.add((min(u, v), max(u, v)))
            banned_nodes = set(root[:-1])
            spur = dijkstra(
                net, spur_node, dst, banned_links=banned_links, banned_nodes=banned_nodes
            )
            if spur is None:
                continue
            total = root[:-1] + spur
            key = tuple(total)
            if key in cand_set or any(tuple(p) == key for p in paths):
                continue
            cost = sum(_edge_cost(net, total[j], total[j + 1]) for j in range(len(total) - 1))
            cand_set.add(key)
            heapq.heappush(candidates, (cost, total))
        if not candidates:
            break
        _, best = heapq.heappop(candidates)
        paths.append(best)
    return paths


def path_links(net: NetworkGraph, path: list[int]) -> list[int]:
    """Node path -> link-id list (empty for colocated src==dst)."""
    return [net.link_id(path[i], path[i + 1]) for i in range(len(path) - 1)]


def path_link_index(
    net: NetworkGraph,
    all_paths: list[list[list[int]]],
    *,
    k: int,
    rows: int,
    pmax: int | None = None,
) -> np.ndarray:
    """Padded path->link index tensor ``(rows, k, pmax)``: entry ``[i, kk, p]``
    is the link id of hop ``p`` of candidate path ``kk`` of flow ``i``. Unused
    slots (short paths, missing candidates, shape-padding rows) hold the
    sentinel ``L = len(net.links)`` — a dummy scatter bin the sparse JRBA
    solver drops, so no separate mask tensor is needed. ``pmax`` defaults to
    the longest candidate path rounded up to a power of two (>= 4), keeping
    the solver kernel on O(log) distinct hop-count shapes."""
    L = len(net.links)
    longest = max((len(p) - 1 for ps in all_paths for p in ps[:k]), default=1)
    if pmax is None:
        pmax = 4
        while pmax < longest:
            pmax *= 2
    elif pmax < longest:
        raise ValueError(f"pmax={pmax} < longest candidate path ({longest} links)")
    idx = np.full((rows, k, pmax), L, dtype=np.int32)
    for i, ps in enumerate(all_paths):
        for kk, path in enumerate(ps[:k]):
            ls = path_links(net, path)
            idx[i, kk, : len(ls)] = ls
    return idx


_MISSING = object()


def avg_bw_path_links(net: NetworkGraph, src: int, dst: int) -> tuple[int, ...] | None:
    """The link-id footprint of one avg-bandwidth query: the pinned shortest
    path between ``src`` and ``dst``, enumerated on first query and kept for
    the rest of the topology epoch (see :func:`avg_path_bandwidth`). Returns
    ``None`` for a disconnected pair and ``()`` for colocated endpoints."""
    if src == dst:
        return ()
    cache = getattr(net, "_avg_bw_cache", None)
    if cache is None:
        cache = net._avg_bw_cache = {}
    links = cache.get((src, dst), _MISSING)
    if links is _MISSING:
        path = dijkstra(net, src, dst)
        links = None if path is None else tuple(path_links(net, path))
        cache[(src, dst)] = links
    return links


def avg_path_bandwidth(net: NetworkGraph, src: int, dst: int) -> float:
    """Average bandwidth along the shortest path (Algo 1, line 7 note: 'we set
    the bandwidth between two edge nodes as the average bandwidth of all
    routing links'). Infinite for colocated endpoints, 0 for disconnected.

    Memoized per network, with footprint-scoped invalidation: the memo pins
    the shortest *path* (its link-id tuple) per (src, dst) for one topology
    epoch, and the value reads through to the live capacities of those links
    on every call. Capacity drift therefore never clears the memo — drifted
    links feed the next query automatically — while a link failure prunes
    exactly the pairs whose pinned path crossed the dead link and a recovery
    (which can create shorter paths anywhere) clears it wholesale (see
    ``NetworkGraph``'s churn API). The pinned path is the tie-break choice
    made at first query within the epoch: a later capacity drift on *other*
    equal-hop paths does not re-run the tie-break, which is what makes the
    value a pure function of (topology epoch, capacities on the pinned path)
    — the invariant footprint-scoped speculation invalidation relies on.

    Algorithm 1 queries this for every candidate node of every task —
    uncached it is the online scheduler's hottest host-side path. When
    ``net._avg_bw_trace`` is a set, every query adds its pinned-path link ids
    to it (the hook ``OnlineScheduler`` uses to record an allocation's
    avg-bandwidth dependency footprint)."""
    links = avg_bw_path_links(net, src, dst)
    if links == ():
        return float("inf")
    trace = getattr(net, "_avg_bw_trace", None)
    if trace is not None and links:
        trace.update(links)
    if links is None:
        return 0.0
    # derived-value memo keyed on the capacity epoch: repeat queries (the
    # common case — Algorithm 1 re-scores the same pairs for every waiting
    # job every round) are one dict hit, while any capacity mutation bumps
    # ``capacity_version`` and lazily re-derives only the pairs re-queried.
    # Every event that can change a pinned path (failure/recovery/restore)
    # also bumps the version, so a stored value can never outlive its path.
    version = net.capacity_version
    values = getattr(net, "_avg_bw_values", None)
    if values is None:
        values = net._avg_bw_values = {}
    hit = values.get((src, dst))
    if hit is not None and hit[0] == version:
        return hit[1]
    cap = net.capacity
    value = float(sum(cap[l] for l in links) / len(links))
    values[(src, dst)] = (version, value)
    return value
