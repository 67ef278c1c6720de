"""Workload generators.

``video_analytics_job`` builds the paper's evaluation application (Fig. 9,
object-attribute recognition): 10 functional modules — decode, detect
(MobileNet-V2 backbone), 7 attribute-recognition / re-id heads (ResNet-50
backbones), and a Kalman tracker — in the Fig. 2 unit system (bandwidth ~1
unit/s per low link, node power 10..200, frame input ~5 units).

``fig2_instance`` is the exact motivating example of Fig. 2, reconstructed so
the four strategies evaluate to throughput 2 / 2.5 / 3.33 / 4 (values stated
in the paper's text).
"""
from __future__ import annotations

import numpy as np

from .graph import JobGraph, NetworkGraph, Task

__all__ = [
    "video_analytics_job",
    "poisson_arrivals",
    "poisson_burst_arrivals",
    "fig2_instance",
    "fig2_job",
]


def video_analytics_job(
    rng: np.random.RandomState,
    source_node: int,
    *,
    input_size: float = 5.0,
    scale: float = 1.0,
    name: str = "object-attr-recognition",
) -> JobGraph:
    """Paper Fig. 9 DAG. Volumes/workloads are jittered ±20% per job so the
    online experiments see heterogeneous instances (as real video content
    produces)."""

    def j(x: float) -> float:
        return float(x * scale * rng.uniform(0.8, 1.2))

    tasks = [
        Task("source", 0.0, 0.0, pinned_node=source_node),  # camera / video source
        Task("decode", j(4.0), 1.0),  # module 1
        Task("detect", j(16.0), 2.0),  # module 2 (MobileNet-V2)
        Task("ped-attr-1", j(8.0), 1.5),  # modules 3-9 (ResNet-50 heads)
        Task("ped-attr-2", j(8.0), 1.5),
        Task("ped-reid", j(9.0), 1.5),
        Task("veh-attr-1", j(8.0), 1.5),
        Task("veh-attr-2", j(8.0), 1.5),
        Task("veh-reid", j(9.0), 1.5),
        Task("track", j(3.0), 1.0),  # module 10 (Kalman)
    ]
    # volumes: raw frames are heavy, crops much lighter, metadata tiny
    edges = [
        (0, 1, j(input_size)),  # raw stream into decode
        (1, 2, j(input_size * 0.8)),  # decoded frames
        (2, 3, j(0.6)),
        (2, 4, j(0.6)),
        (2, 5, j(0.8)),
        (2, 6, j(0.6)),
        (2, 7, j(0.6)),
        (2, 8, j(0.8)),
        (3, 9, j(0.1)),
        (4, 9, j(0.1)),
        (5, 9, j(0.15)),
        (6, 9, j(0.1)),
        (7, 9, j(0.1)),
        (8, 9, j(0.15)),
    ]
    return JobGraph(tasks, edges, name=name)


def poisson_arrivals(
    n_jobs: int,
    net_nodes: int,
    rng: np.random.RandomState,
    *,
    lam: float = 0.5,  # jobs/second (paper Sec. VI)
    total_units: float = 30.0,  # stream units each job processes
    input_size: float = 5.0,
    source_nodes: list[int] | None = None,  # restrict cameras (e.g. fat-tree hosts)
) -> list[tuple[float, JobGraph, float]]:
    t = 0.0
    arrivals = []
    for _ in range(n_jobs):
        t += rng.exponential(1.0 / lam)
        src = _pick_source(rng, net_nodes, source_nodes)
        job = video_analytics_job(rng, src, input_size=input_size)
        arrivals.append((t, job, total_units * rng.uniform(0.7, 1.3)))
    return arrivals


def poisson_burst_arrivals(
    n_jobs: int,
    net_nodes: int,
    rng: np.random.RandomState,
    *,
    lam_base: float = 0.2,  # jobs/s in the quiet phase
    lam_burst: float = 3.0,  # jobs/s inside a burst
    burst_dwell: float = 4.0,  # mean burst duration (s)
    quiet_dwell: float = 15.0,  # mean quiet duration (s)
    total_units: float = 30.0,
    input_size: float = 5.0,
    source_nodes: list[int] | None = None,
) -> list[tuple[float, JobGraph, float]]:
    """Two-state Markov-modulated Poisson arrivals (flash-crowd traffic).

    The process alternates exponential-dwell quiet/burst phases; within a
    phase arrivals are Poisson at the phase rate. Bursts are what separate
    OTFS from OTFA in queueing behaviour — steady Poisson rarely builds a
    deep enough backlog."""
    arrivals: list[tuple[float, JobGraph, float]] = []
    t = 0.0
    bursting = False
    phase_end = rng.exponential(quiet_dwell)
    while len(arrivals) < n_jobs:
        lam = lam_burst if bursting else lam_base
        dt = rng.exponential(1.0 / lam)
        if t + dt >= phase_end:  # phase flips before the next arrival lands
            t = phase_end
            bursting = not bursting
            phase_end = t + rng.exponential(burst_dwell if bursting else quiet_dwell)
            continue
        t += dt
        src = _pick_source(rng, net_nodes, source_nodes)
        job = video_analytics_job(rng, src, input_size=input_size)
        arrivals.append((t, job, total_units * rng.uniform(0.7, 1.3)))
    return arrivals


def _pick_source(
    rng: np.random.RandomState, net_nodes: int, source_nodes: list[int] | None
) -> int:
    if source_nodes is not None:
        return int(source_nodes[rng.randint(len(source_nodes))])
    return int(rng.randint(net_nodes))


# ---------------------------------------------------------------------------
# Fig. 2 motivating example (exact)
# ---------------------------------------------------------------------------
def fig2_instance() -> tuple[NetworkGraph, JobGraph]:
    """Reconstruction of Fig. 2 consistent with every number in the text:

    * job: 6 tasks, total workload 55, total memory 11; input 5 from e4.
    * strategy (c) LR: whole job on e1, flow 5 units at bw 10 over e4-e2-e1
      -> 1/max(5/10, 55/200) = 2.
    * (d) task a on e4, rest on e1, flows f_ac (V=2), f_ab (V=1) equal-share
      the 10-unit path -> 1/max(5/20, 50/200, 2/5, 1/5) = 2.5.
    * (e) proportional bandwidth (Eq. 15): b_ac=20/3, b_ab=10/3
      -> 1/max(0.25, 0.25, 0.3, 0.3) = 3.33.
    * (f) f_ab re-routed over e4-e3-e1 (bw 6): 1/max(0.25, 0.25, 0.2, 1/6) = 4.
    """
    # nodes: e1..e5 -> ids 0..4
    power = [200.0, 10.0, 10.0, 20.0, 10.0]
    mem = [11.0, 1.0, 1.0, 2.0, 1.0]
    links = [
        (3, 1, 10.0),  # e4-e2
        (1, 0, 10.0),  # e2-e1
        (3, 2, 6.0),  # e4-e3
        (2, 0, 8.0),  # e3-e1
        (4, 0, 5.0),  # e5-e1 (spare)
    ]
    net = NetworkGraph(power, mem, links)
    job = fig2_job()
    return net, job


def fig2_job() -> JobGraph:
    # task 0 is the pinned camera source at e4 (node id 3)
    tasks = [
        Task("source", 0.0, 0.0, pinned_node=3),
        Task("a", 5.0, 1.0),
        Task("b", 10.0, 2.0),
        Task("c", 10.0, 2.0),
        Task("d", 10.0, 2.0),
        Task("e", 10.0, 2.0),
        Task("f", 10.0, 2.0),
    ]
    edges = [
        (0, 1, 5.0),  # raw input 5 units
        (1, 2, 1.0),  # f_ab volume 1
        (1, 3, 2.0),  # f_ac volume 2
        (2, 4, 0.5),
        (3, 5, 0.5),
        (4, 6, 0.2),
        (5, 6, 0.2),
    ]
    return JobGraph(tasks, edges, name="fig2")
