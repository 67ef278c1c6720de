"""Job profiler (paper Sec. IV-A).

The paper profiles each task's execution time on every heterogeneous node
class by actually running it (offline profiling). Here the equivalent
information comes from two sources:

* **abstract jobs** (the paper's evaluation): ``C_i / PS_j`` from the job
  graph and node classes — exactly the paper's cost model;
* **ML stage jobs** (the TPU adaptation): per-stage FLOPs/bytes, either from
  analytic formulas (``configs``) or *exactly* from a compiled step's
  ``cost_analysis()`` (see ``launch/roofline.py``), divided by the node
  class's peak FLOP/s / HBM bandwidth — i.e. the same "execution time per
  node class" table the paper's profiler measures, derived instead of timed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import JobGraph, NetworkGraph

__all__ = ["H100", "JobProfile", "profile_job", "NodeClass", "TPU_V5E"]


@dataclasses.dataclass(frozen=True)
class NodeClass:
    """A hardware class (paper Tab. I rows; here also accelerator chips)."""

    name: str
    peak_flops: float  # FLOP/s (or abstract units/s)
    hbm_bw: float = float("inf")  # bytes/s
    mem: float = float("inf")  # bytes (or abstract units)


TPU_V5E = NodeClass("tpu-v5e", peak_flops=197e12, hbm_bw=819e9, mem=16e9)
# one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): dense bf16
# tensor-core FLOP/s, HBM3 bytes/s, 80 GB
H100 = NodeClass("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, mem=80e9)


@dataclasses.dataclass
class JobProfile:
    """exec_time[i, c]: time of task i on node class c (paper's profile)."""

    job: JobGraph
    classes: list[NodeClass]
    exec_time: np.ndarray  # (n_tasks, n_classes)

    def exec_on(self, task: int, klass: int) -> float:
        return float(self.exec_time[task, klass])


def profile_job(
    job: JobGraph,
    classes: list[NodeClass],
    *,
    task_bytes: np.ndarray | None = None,
) -> JobProfile:
    """Roofline-style profile: t = max(flops/peak, bytes/bw). For abstract
    jobs (no byte counts) this is exactly C_i / PS_j."""
    n, c = job.n_tasks, len(classes)
    et = np.zeros((n, c))
    for i, task in enumerate(job.tasks):
        for j, kl in enumerate(classes):
            t_compute = task.workload / kl.peak_flops
            t_mem = 0.0 if task_bytes is None else task_bytes[i] / kl.hbm_bw
            et[i, j] = max(t_compute, t_mem)
    return JobProfile(job, classes, et)


def profile_on_network(job: JobGraph, net: NetworkGraph) -> np.ndarray:
    """(n_tasks, n_nodes) exec time on each concrete node — the table the
    scheduler consumes (Algo 1 line 6)."""
    return np.asarray(
        [[t.workload / p for p in net.power] for t in job.tasks], dtype=np.float64
    )
