"""ENTS placement: model stage graphs as ENTS jobs.

This is the integration layer described in DESIGN.md §2: a (train or serve)
job for one of the assigned architectures is cut into pipeline stages; each
stage is an ENTS task whose workload is its FLOPs, and inter-stage activation
transfers are ENTS flows whose volume is bytes-per-stream-unit. The ENTS
scheduler (Algo 1 + JRBA, or the online OTFS/OTFA loop) then places stages
onto pod submeshes and routes/provisions the inter-stage flows over ICI/DCN
links — maximizing steady-state pipeline throughput, which is exactly the
paper's streaming objective TP = 1/t_p.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from .allocation import allocate_greedy, job_span, throughput
from .graph import JobGraph, NetworkGraph, Task
from .jrba import jrba

__all__ = ["stage_graph", "place_job", "PlacementReport"]


def _block_flops(cfg: ModelConfig, block, tokens: int) -> float:
    """Forward FLOPs per stream unit (= one microbatch of ``tokens``)."""
    return 2.0 * (cfg.mixer_params(block) + cfg.mlp_params(block)) * tokens


def stage_graph(
    cfg: ModelConfig,
    *,
    n_stages: int = 4,
    microbatch_tokens: int = 4096,
    source_node: int = 0,
    train: bool = False,
    name: str | None = None,
) -> JobGraph:
    """Cut the layer stack into ``n_stages`` contiguous stages.

    Task workload = stage FLOPs per microbatch (x3 for train: fwd+bwd).
    Flow volume = activation bytes between stages (B*S*d at bf16).
    Stage memory = its parameter bytes (the allocator's R_req).
    """
    blocks = cfg.blocks
    n_stages = min(n_stages, len(blocks))
    # even split (np.array_split semantics): stage sizes differ by at most 1
    bounds = np.linspace(0, len(blocks), n_stages + 1).round().astype(int)
    chunks = [blocks[bounds[i] : bounds[i + 1]] for i in range(n_stages)]
    mult = 3.0 if train else 1.0
    act_bytes = microbatch_tokens * cfg.d_model * 2.0  # bf16 boundary activations

    tasks = [Task("source", 0.0, 0.0, pinned_node=source_node)]
    embed_bytes = cfg.vocab * cfg.d_model * 2.0
    for si, chunk in enumerate(chunks):
        flops = sum(_block_flops(cfg, b, microbatch_tokens) for b in chunk) * mult
        mem = sum(cfg.block_params(b) for b in chunk) * 2.0
        if si == 0:
            mem += embed_bytes
        if si == len(chunks) - 1 and not cfg.tie_embeddings:
            mem += embed_bytes
        tasks.append(Task(f"stage{si}", flops, mem))
    edges = [(0, 1, microbatch_tokens * 4.0)]  # token ids from the source
    for si in range(len(chunks) - 1):
        edges.append((si + 1, si + 2, act_bytes))
    return JobGraph(tasks, edges, name=name or f"{cfg.name}-{'train' if train else 'serve'}")


@dataclasses.dataclass
class PlacementReport:
    job: JobGraph
    assignment: np.ndarray  # stage -> node
    routes: list[list[int]]
    bandwidths: np.ndarray
    throughput: float  # stream units (microbatches) per second
    span: float


def place_job(
    net: NetworkGraph,
    job: JobGraph,
    *,
    k_paths: int = 4,
    water_filling: bool = False,
    device: str | torch.device = "cuda",
) -> PlacementReport | None:
    """One-shot ENTS placement (Algo 1 + JRBA) of a stage graph onto a pod
    network (e.g. core.graph.torus_network). JRBA's relaxation runs on
    ``device`` (the CUDA kernel on a card). Returns None if infeasible."""
    alloc, flows = allocate_greedy(net, job, commit=False)
    if not alloc.feasible:
        return None
    res = jrba(net, flows, k=k_paths, water_filling=water_filling, device=device)
    if res is None:
        bandwidths, routes, flows2 = np.zeros(0), [], []
    else:
        bandwidths, routes, flows2 = res.bandwidth, res.routes, res.flows
    span = job_span(net, alloc, flows2, bandwidths)
    return PlacementReport(
        job=job,
        assignment=alloc.assignment,
        routes=routes,
        bandwidths=bandwidths,
        throughput=throughput(net, alloc, flows2, bandwidths),
        span=span,
    )
